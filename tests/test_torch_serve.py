"""The port's serving slice against the JAX reference, plus its device
and import rules.

* Step level: the port's ``paged_prefill`` + 2 ``paged_pac_decode_step``s
  with the ``"cuda"`` OpSet (its kernel wrappers take their plain
  versions on CPU tensors) against JAX ``kernel_impl="pallas"`` in
  interpret mode — INT8 backbone, a 2-adapter bank, ragged prompts, per
  KV policy: logits within the policy's tolerance, equal greedy tokens,
  page pools equal once dequantized.
* Engine level: ``ServeEngine(device="cpu")`` and the JAX engine give
  equal token streams for int8, f32 and bf16 KV over an INT8 backbone and
  int8 and f32 KV over an INT4 one; on a pool too small for every prompt
  at once, the same admission schedule (which request each step admits,
  each wave's buckets: the smoke's host replay's too) and streams; on a
  pool too small for the decode, ``OutOfPagesError`` at the same step.
* The engine refuses to fall back to the CPU silently; no module of the
  port (nor ``chip_smoke.py``) imports JAX or the reference package.
"""

import ast
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.parallel_adapters import gather_adapters, init_adapter, stack_adapters
from repro.core.quantization import quantize_tree
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import paging as jax_paging
from repro.serve.decode import paged_pac_decode_step as jax_decode_step
from repro.serve.decode import paged_prefill as jax_prefill
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.serve import ServeEngine, paging
from repro_torch.serve.decode import paged_pac_decode_step, paged_prefill

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PROMPTS = [[5, 7, 11, 2, 9], [3, 1], [8, 8, 4, 6]]  # ragged on purpose
PAGE, MAX_LEN, R, N_STEPS = 4, 16, 4, 2
#: logits tolerance per KV policy (tests/test_decode_parity.py:36)
TOL = {"f32": 2e-4, "bf16": 3e-2, "int8": 2e-4}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def torch_cfg(tiny_cfg):
    cfg = get_arch("internlm2-1.8b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tiny_cfg)
    return cfg


@pytest.fixture(scope="module")
def serving_model(tiny_cfg, tiny_backbone, tiny_adapter):
    backbone = quantize_tree(tiny_backbone, bits=8, min_size=1024)
    bank = stack_adapters([tiny_adapter, init_adapter(jax.random.PRNGKey(2), tiny_cfg, r=R)])
    abatch = gather_adapters(bank, jnp.arange(len(PROMPTS)) % 2)
    return backbone, abatch


def _table():
    max_pages = MAX_LEN // PAGE
    table = paging.PageTable(paging.PageAllocator(len(PROMPTS) * max_pages + 1), PAGE, max_pages)
    for i, p in enumerate(PROMPTS):
        table.open(i, len(p))
    return table


def _pool_f32(entry):
    """A pool's K and V as f32 (int8 dequantized), null page dropped."""
    out = []
    for name in ("k", "v"):
        e = entry[name]
        if isinstance(e, dict):
            q, s = (np.asarray(e["q"]), np.asarray(e["scale"])) if not isinstance(
                e["q"], torch.Tensor) else (e["q"].numpy(), e["scale"].numpy())
            out.append((q.astype(np.float32) * s[..., None])[:, 1:])
        else:
            a = e.float().numpy() if isinstance(e, torch.Tensor) else np.asarray(
                e.astype(jnp.float32))
            out.append(a[:, 1:])
    return out


@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_prefill_and_decode_steps_match_pallas(policy, tiny_cfg, torch_cfg, serving_model):
    backbone, abatch = serving_model
    tb, ta = bridge.to_torch(_np(backbone)), bridge.to_torch(_np(abatch))
    table = _table()
    n_pages = table.allocator.n_pages
    jpools = jax_paging.init_pools(tiny_cfg, n_pages, PAGE, len(PROMPTS), policy)
    tpools = paging.init_pools(torch_cfg, n_pages, PAGE, policy, "cpu")
    bt, lengths = table.dense(range(len(PROMPTS)))
    toks = np.zeros((len(PROMPTS), max(map(len, PROMPTS))), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, : len(p)] = p

    jl, jpools, jac = jax_prefill(
        backbone, abatch, jnp.asarray(toks), jnp.asarray(lengths), jpools, jnp.asarray(bt),
        cfg=tiny_cfg, max_len=MAX_LEN, r=R, kernel_impl="pallas", interpret=True)
    tl, tpools, tac = paged_prefill(
        tb, ta, torch.from_numpy(toks), torch.from_numpy(lengths), tpools,
        torch.from_numpy(bt), cfg=torch_cfg, max_len=MAX_LEN, r=R, kernel_impl="cuda")
    outs = [(np.asarray(jl[:, 0]), tl[:, 0].numpy())]
    for _ in range(N_STEPS):
        tok = np.argmax(outs[-1][0], axis=-1).astype(np.int32)[:, None]
        for i in range(len(PROMPTS)):
            table.extend_to(i, table.length(i) + 1)
        bt, lengths = table.dense(range(len(PROMPTS)))
        jl, jpools, jac = jax_decode_step(
            backbone, abatch, jnp.asarray(tok), jpools, jnp.asarray(bt), jnp.asarray(lengths),
            jac, cfg=tiny_cfg, r=R, kernel_impl="pallas", interpret=True)
        tl, tpools, tac = paged_pac_decode_step(
            tb, ta, torch.from_numpy(tok), tpools, torch.from_numpy(bt),
            torch.from_numpy(lengths), tac, cfg=torch_cfg, r=R, kernel_impl="cuda")
        outs.append((np.asarray(jl[:, 0]), tl[:, 0].numpy()))
        for i in range(len(PROMPTS)):
            table.append_token(i)

    for want, got in outs:
        assert np.max(np.abs(want - got)) < TOL[policy]
        np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))
    # pools agree once dequantized: a one-ulp K/V difference may move an
    # int8 code by one step of its scale (bf16: one bf16 ulp)
    for jp, tp in zip(jpools, tpools):
        for want, got in zip(_pool_f32(jp), _pool_f32(tp)):
            atol = 1e-5
            if policy == "int8":
                atol += np.abs(want).max() / 127
            np.testing.assert_allclose(got, want, atol=atol, rtol=8e-3 if policy == "bf16" else 0)
    for jc, tc in zip(jac, tac):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), atol=1e-4)


ENGINE_PROMPTS = [[5, 7, 11, 2, 9], [3, 1], [8, 8, 4, 6], [2, 2, 2]]
USERS = ["alice", "bob", "alice", "bob"]


@pytest.mark.parametrize("policy,bits", [
    pytest.param("int8", 8, id="int8"), pytest.param("f32", 8, id="f32"),
    pytest.param("bf16", 8, id="bf16"), pytest.param("int8", 4, id="int4-int8"),
    pytest.param("f32", 4, id="int4-f32")])
def test_engine_streams_equal_jax_pallas(policy, bits, tiny_cfg, torch_cfg, tiny_backbone):
    """4 requests / 2 adapters, max_batch=2 (admission waves, swap-remove
    retirement), an INT8 or INT4 backbone: the port's engine emits the JAX
    engine's token streams (greedy tokens equal: the logits' tolerance of
    the step test above, bf16 pages 3e-2, leaves every argmax alike)."""
    backbone = quantize_tree(tiny_backbone, bits=bits, min_size=1024)
    adapters = {"alice": init_adapter(jax.random.PRNGKey(1), tiny_cfg, r=R),
                "bob": init_adapter(jax.random.PRNGKey(2), tiny_cfg, r=R)}
    kw = dict(r=R, kv_policy=policy, page_size=PAGE, max_len=32, max_batch=2)
    jeng = JaxServeEngine(backbone, tiny_cfg, adapters, kernel_impl="pallas", interpret=True, **kw)
    teng = ServeEngine(bridge.to_torch(_np(backbone)), torch_cfg,
                       {u: bridge.to_torch(_np(a)) for u, a in adapters.items()},
                       kernel_impl="cuda", device="cpu", **kw)
    handles = [jeng.submit(p, u, max_new_tokens=5) for p, u in zip(ENGINE_PROMPTS, USERS)]
    jeng.drain()
    streams = [[h.result() for h in handles]]
    if policy == "f32":  # the background step loop and streaming handles
        teng.start()
        try:
            handles = [teng.submit(p, u, max_new_tokens=5) for p, u in zip(ENGINE_PROMPTS, USERS)]
            streams.append([list(h.tokens()) for h in handles])
        finally:
            teng.stop()
    else:
        handles = [teng.submit(p, u, max_new_tokens=5) for p, u in zip(ENGINE_PROMPTS, USERS)]
        teng.drain()
        streams.append([h.result() for h in handles])
    assert streams[1] == streams[0]
    assert all(len(s) == 5 for s in streams[1])
    assert teng.decode_steps > 0 and teng.decode_tokens > 0 and teng.prefill_seconds > 0


def _smoke():
    """``chip_smoke.py`` as a module (its import needs no card): its host
    replay of the page table and its choice of a tight pool."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: six prompts of 2-13 tokens; with 3 new tokens each, pages of 4 and max_len 24 the
#: largest tight pool (7 pages) admits them in waves of 3, 2 and 1, and 6 pages run out in
#: the first decode step
POOL_PROMPTS = [[5, 7], [3, 1, 4, 1, 5], [8, 8, 4, 6, 1, 2, 7], [2, 7, 1, 8, 2, 8, 1],
                [4, 4, 4], [9, 1, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]]
POOL_USERS = ["alice", "bob"] * 3
POOL_MAX_LEN, POOL_NEW = 24, 3


def _engines(tiny_cfg, torch_cfg, tiny_backbone, n_pages, max_batch=4):
    backbone = quantize_tree(tiny_backbone, bits=8, min_size=1024)
    adapters = {"alice": init_adapter(jax.random.PRNGKey(1), tiny_cfg, r=R),
                "bob": init_adapter(jax.random.PRNGKey(2), tiny_cfg, r=R)}
    kw = dict(r=R, kv_policy="int8", page_size=PAGE, max_len=POOL_MAX_LEN, max_batch=max_batch,
              n_pages=n_pages)
    jeng = JaxServeEngine(backbone, tiny_cfg, adapters, kernel_impl="pallas", interpret=True, **kw)
    teng = ServeEngine(bridge.to_torch(_np(backbone)), torch_cfg,
                       {u: bridge.to_torch(_np(a)) for u, a in adapters.items()},
                       kernel_impl="cuda", device="cpu", **kw)
    return jeng, teng


def _drain(eng, n_new, smoke):
    """(streams, schedule) of ``POOL_PROMPTS`` through ``eng``, drained."""
    rec = smoke.watch_schedule(eng, {})
    handles = [eng.submit(p, u, max_new_tokens=n_new) for p, u in zip(POOL_PROMPTS, POOL_USERS)]
    eng.drain()
    return [h.result() for h in handles], rec


def test_engine_admission_under_a_tight_pool_matches_jax(tiny_cfg, torch_cfg, tiny_backbone):
    """A pool below what the prompts need at once (chip_smoke's
    ``tight_pool``, the largest on which the replay waits, prefills in
    waves of different batch buckets and never runs out): the port's
    engine admits as the JAX engine does, step by step, wave by wave, and
    as the smoke's host replay predicts from the lengths alone; it emits
    the JAX engine's streams (greedy tokens, as above); it never holds
    more than ``n_pages`` - 1 pages, and frees them all once drained."""
    smoke, n_new = _smoke(), POOL_NEW
    lens = [len(p) for p in POOL_PROMPTS]
    n_pages, replay = smoke.tight_pool(lens, n_new, PAGE, POOL_MAX_LEN, 4)
    assert n_pages - 1 < sum(-(-n // PAGE) for n in lens)
    assert replay["waits"] > 0 and len({w[2] for w in replay["waves"]}) >= 2
    jeng, teng = _engines(tiny_cfg, torch_cfg, tiny_backbone, n_pages)
    (jstreams, jrec), (tstreams, trec) = _drain(jeng, n_new, smoke), _drain(teng, n_new, smoke)
    assert trec["waves"] == jrec["waves"] == replay["waves"]
    assert trec["steps"] == jrec["steps"] == replay["steps"]
    assert trec["max_in_use"] == jrec["max_in_use"] == replay["max_in_use"] <= n_pages - 1
    assert tstreams == jstreams and all(len(s) == n_new for s in tstreams)
    assert teng.allocator.free_pages == jeng.allocator.free_pages == n_pages - 1


def test_engine_out_of_pages_mid_decode_matches_jax(tiny_cfg, torch_cfg, tiny_backbone):
    """A pool that admits prompts its decode cannot grow: the reference's
    engine has no eviction, so a decode step that finds no page raises.
    Both engines raise ``OutOfPagesError`` at the same step, after the
    same admissions, as the smoke's host replay predicts."""
    smoke, n_new, n_pages = _smoke(), POOL_NEW, 6
    lens = [len(p) for p in POOL_PROMPTS]
    replay = {}
    with pytest.raises(paging.OutOfPagesError):
        smoke.admission_replay(lens, n_new, PAGE, POOL_MAX_LEN, 4, n_pages, rec=replay)
    assert replay["waves"] and replay["steps"] > replay["waves"][-1][0]  # raised in a decode
    for eng, err in zip(_engines(tiny_cfg, torch_cfg, tiny_backbone, n_pages),
                        (jax_paging.OutOfPagesError, paging.OutOfPagesError)):
        rec = smoke.watch_schedule(eng, {})
        for p, u in zip(POOL_PROMPTS, POOL_USERS):
            eng.submit(p, u, max_new_tokens=n_new)
        with pytest.raises(err):
            eng.drain()
        assert (rec["steps"], rec["waves"]) == (replay["steps"], replay["waves"])


def test_engine_without_device_refuses_cpu_fallback(torch_cfg):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the default engine would run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine({}, torch_cfg)


def test_engine_rejects_backbone_on_another_device(torch_cfg):
    backbone = {"embed": torch.zeros(4, 4, device="meta")}
    with pytest.raises(ValueError):
        ServeEngine(backbone, torch_cfg, device="cpu")


def test_page_bookkeeping_matches_reference(tiny_cfg, torch_cfg):
    for policy in jax_paging.KV_POLICIES:
        assert paging.kv_bytes_per_token(torch_cfg, policy) == \
            jax_paging.kv_bytes_per_token(tiny_cfg, policy)
    tables = [mod.PageTable(mod.PageAllocator(9), page=4, max_pages=3)
              for mod in (jax_paging, paging)]
    for t in tables:
        t.open(0, 5)
        t.open(1, 2)
        for _ in range(4):
            t.append_token(1)
        t.close(0)
        t.open(2, 9)
    (jb, jl), (tb, tl) = (t.dense([1, 2], rows=4) for t in tables)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tl, jl)
    for want, got in zip(tables[0].ragged([2, 1]), tables[1].ragged([2, 1])):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(paging.OutOfPagesError):
        tables[1].extend_to(2, 13)


_FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "msgpack")  # the card's machine has no msgpack


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & set(_FORBIDDEN))
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, repro_torch.serve, repro_torch.kernels.quant_matmul, "
            "repro_torch.kernels.flash_attention, repro_torch.kernels.paged_attention; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
