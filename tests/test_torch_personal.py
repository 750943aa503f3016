"""The port's single-user serving path against the JAX reference:
``adapter_fuse`` (the last TPU kernel's wrapper), the INT8 linear KV
cache, ``backbone_decode``, ``prefill_step`` and ``pac_decode_step``,
and the public ``kernels.ops`` wrappers.

Inputs come from numpy seeds; parameters are the reference's tiny
fixtures carried over with ``repro_torch.bridge``. On CPU tensors every
kernel wrapper computes its plain version, so the ``cuda`` OpSet's
control flow runs here; the kernels themselves are held against those
plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import steps as jsteps
from repro.core.parallel_adapters import init_adapter_cache as jax_init_adapter_cache
from repro.core.quantization import quantize_tree
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.adapter_fuse import adapter_fuse as jax_adapter_fuse
from repro.models import backbone as jbb
from repro.models.layers import quantize_kv_token as jax_quantize_kv_token
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import steps
from repro_torch.core.parallel_adapters import gather_adapters, init_adapter_cache, stack_adapters
from repro_torch.kernels import adapter_fuse as adapter_fuse_mod
from repro_torch.kernels import ops
from repro_torch.kernels.adapter_fuse import adapter_fuse
from repro_torch.models import backbone as bb
from repro_torch.models.layers import quantize_kv_token
from repro_torch.serve import paging
from repro_torch.serve.decode import paged_pac_decode_step, paged_prefill

torch.set_num_threads(2)

R = 4
PROMPT = [5, 7, 11, 2, 9, 3]
N_NEW = 4
MAX_LEN = 16
#: logits tolerance of the port against JAX ``ref`` on the same inputs:
#: the reference's f32/int8 decode-parity ceiling (tests/test_decode_parity.py:36)
LOGITS_TOL = 2e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def torch_cfg(tiny_cfg):
    cfg = get_arch("internlm2-1.8b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tiny_cfg)
    return cfg


@pytest.fixture(scope="module")
def model(tiny_backbone, tiny_adapter):
    """The INT8 serving backbone and the r=4 adapter, in both packages."""
    jb = quantize_tree(tiny_backbone, bits=8, min_size=1024)
    return (jb, tiny_adapter), (bridge.to_torch(_np(jb)), bridge.to_torch(_np(tiny_adapter)))


# ---------------------------------------------------------------------------
# adapter_fuse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,d,da,lam", [
    (128, 256, 64, 0.5), (256, 512, 128, 0.0), (64, 128, 128, 1.0),   # the reference's sweep
    (100, 130, 70, 0.7), (100, 512, 96, 0.7), (33, 257, 65, 0.7), (1, 5, 3, 0.7),  # ragged
])
def test_adapter_fuse_matches_the_pallas_kernel(T, d, da, lam):
    """The wrapper's CPU path against the Pallas kernel in interpret
    mode and the jnp oracle, at the shapes of tests/test_kernels.py's
    adapter_fuse tests; atol 1e-4, the reference's (test_kernels.py:68)."""
    rng = np.random.default_rng(T * 1000 + d)
    b = rng.standard_normal((T, d), dtype=np.float32)
    w = rng.standard_normal((d, da), dtype=np.float32)
    a = rng.standard_normal((T, da), dtype=np.float32)
    pallas = jax_adapter_fuse(jnp.asarray(b), jnp.asarray(w), jnp.asarray(a), jnp.float32(lam),
                              bt=64, bj=64, bk=128, interpret=True)
    oracle = jref.adapter_fuse_ref(jnp.asarray(b), jnp.asarray(w), jnp.asarray(a), lam)
    got = adapter_fuse(torch.from_numpy(b), torch.from_numpy(w), torch.from_numpy(a),
                       torch.tensor(lam))
    assert got.shape == (T, da) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=1e-4)


def test_adapter_fuse_contract():
    """bf16 b gives a bf16 result accumulated in f32; inputs that need
    a gradient are refused (the TPU kernel has no VJP); CPU calls
    compute the plain version and are not counted as launches."""
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.standard_normal((8, 64), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 16), dtype=np.float32))
    a = torch.from_numpy(rng.standard_normal((8, 16), dtype=np.float32))
    before = adapter_fuse_mod.launches
    out = adapter_fuse(b.bfloat16(), w.bfloat16(), a, torch.tensor(0.25))
    assert out.dtype == torch.bfloat16
    want = 0.25 * (b.bfloat16().float() @ w.bfloat16().float()) + 0.75 * a
    assert torch.equal(out, want.bfloat16())
    with pytest.raises(ValueError, match="no gradient"):
        adapter_fuse(b, w.clone().requires_grad_(), a, 0.5)
    with pytest.raises(ValueError, match="does not match"):
        adapter_fuse(b, w, a[:, :8], 0.5)
    assert adapter_fuse_mod.launches == before


def test_kernel_ops_reshape_like_the_reference():
    """``kernels.ops`` against ``repro.kernels.ops`` on model-shaped
    inputs: (B,S,K) quant_matmul, (B,S,d) adapter_fuse, (B,H,S,hd)
    flash attention (atol 1e-5, rtol 1e-5: the same plain math in f32,
    sums reordered)."""
    from repro.core.quantization import quantize as jquantize

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 256), dtype=np.float32)
    w = jquantize(jnp.asarray(rng.standard_normal((256, 200), dtype=np.float32) / 16), 8)
    got = ops.quant_matmul(torch.from_numpy(x), bridge.to_torch(_np(w)))
    assert got.shape == (2, 5, 200)
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.quant_matmul(jnp.asarray(x), w)),
                               atol=1e-5, rtol=1e-5)
    b = rng.standard_normal((2, 3, 64), dtype=np.float32)
    wd = rng.standard_normal((64, 16), dtype=np.float32)
    a = rng.standard_normal((2, 3, 16), dtype=np.float32)
    got = ops.adapter_fuse(*map(torch.from_numpy, (b, wd, a)), torch.tensor(0.3))
    want = jops.adapter_fuse(jnp.asarray(b), jnp.asarray(wd), jnp.asarray(a), 0.3)
    assert got.shape == (2, 3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    q, k, v = (rng.standard_normal((2, 4, 16, 32), dtype=np.float32) for _ in range(3))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), window=8)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# INT8 linear KV cache and backbone decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_quantize_kv_token_is_bit_exact(scale):
    rng = np.random.default_rng(int(scale * 1000))
    t = (rng.standard_normal((3, 1, 4, 16)) * scale).astype(np.float32)
    t[1, 0, 2] = 0.0  # an all-zero (token, head): the 1e-8 scale floor
    jq, js = jax_quantize_kv_token(jnp.asarray(t))
    q, s = quantize_kv_token(torch.from_numpy(t))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("kv_quant", [None, 8])
@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_backbone_decode_matches_jax(impl, kv_quant, tiny_cfg, torch_cfg, model):
    """10 teacher-forced decode steps (B=2) against JAX ``decode_step``
    (ref) with the same cache policy: logits within LOGITS_TOL, the
    caches equal (int8 codes bit for bit, scales and f32 K/V within
    1e-5)."""
    (jb, _), (tb, _) = model
    B, S = 2, 10
    toks = _tokens(tiny_cfg, B, S, 3)
    jc = jbb.init_cache(tiny_cfg, B, S, kv_quant=kv_quant)
    tc = bb.init_cache(torch_cfg, B, S, kv_quant=kv_quant)
    for t in range(S):
        tok = toks[:, t:t + 1]
        jl, jc = jsteps.decode_step(jb, {"tokens": jnp.asarray(tok)}, jc, jnp.int32(t),
                                    cfg=tiny_cfg)
        tl, tc = steps.decode_step(tb, {"tokens": torch.from_numpy(tok)}, tc, t, cfg=torch_cfg,
                                   kernel_impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_TOL)
    for je, te in zip(jc, tc):
        assert je.keys() == te.keys()
        for name in je:
            if te[name].dtype == torch.int8:
                np.testing.assert_array_equal(te[name].numpy(), np.asarray(je[name]))
            else:
                np.testing.assert_allclose(te[name].numpy(), np.asarray(je[name]), atol=1e-5)


def test_prefill_step_matches_jax_and_the_decode(tiny_cfg, torch_cfg, model):
    """``prefill_step`` against JAX's (LOGITS_TOL), and against the
    teacher-forced f32-cache decode at the last position within 2e-3
    relative (tests/test_backbone_smoke.py:123); the INT8-KV decode
    within 5 % relative of the f32-KV one (test_backbone_smoke.py:152)."""
    (jb, _), (tb, _) = model
    B, S = 2, 10
    toks = _tokens(tiny_cfg, B, S, 4)
    jl = jsteps.prefill_step(jb, {"tokens": jnp.asarray(toks)}, cfg=tiny_cfg)
    tl = steps.prefill_step(tb, {"tokens": torch.from_numpy(toks)}, cfg=torch_cfg,
                            kernel_impl="cuda")
    assert tl.shape == (B, 1, tiny_cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_TOL)
    last = {}
    for kv_quant in (None, 8):
        cache = bb.init_cache(torch_cfg, B, S, kv_quant=kv_quant)
        for t in range(S):
            lg, cache = steps.decode_step(tb, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                          cache, t, cfg=torch_cfg, kernel_impl="cuda")
        last[kv_quant] = lg
    scale = float(tl.abs().max())
    assert float((last[None] - tl).abs().max()) / scale < 2e-3
    assert float((last[8] - last[None]).abs().max()) / float(last[None].abs().max()) < 0.05


# ---------------------------------------------------------------------------
# pac_decode_step
# ---------------------------------------------------------------------------


def _greedy_jax(cfg, jb, ja, kv_quant):
    cache = jbb.init_cache(cfg, 1, MAX_LEN, kv_quant=kv_quant)
    acache = jax_init_adapter_cache(cfg, 1, MAX_LEN, r=R)
    logits, tokens = [], list(PROMPT)
    for pos in range(len(PROMPT) + N_NEW - 1):
        tok = jnp.asarray([[tokens[pos]]], jnp.int32)
        lg, cache, acache = jsteps.pac_decode_step(jb, ja, {"tokens": tok}, cache, acache,
                                                   jnp.int32(pos), cfg=cfg, r=R)
        logits.append(np.asarray(lg[0, 0]))
        if pos >= len(PROMPT) - 1:
            tokens.append(int(np.argmax(logits[-1])))
    return tokens, np.stack(logits)


def _greedy_torch(cfg, tb, ta, kv_quant, impl):
    cache = bb.init_cache(cfg, 1, MAX_LEN, kv_quant=kv_quant)
    acache = init_adapter_cache(cfg, 1, MAX_LEN, r=R)
    logits, tokens = [], list(PROMPT)
    for pos in range(len(PROMPT) + N_NEW - 1):
        tok = torch.tensor([[tokens[pos]]], dtype=torch.int32)
        lg, cache, acache = steps.pac_decode_step(tb, ta, {"tokens": tok}, cache, acache, pos,
                                                  cfg=cfg, r=R, kernel_impl=impl)
        logits.append(lg[0, 0])
        if pos >= len(PROMPT) - 1:
            tokens.append(int(lg[0, 0].argmax()))
    return tokens, torch.stack(logits).numpy()


@pytest.mark.parametrize("kv_quant", [None, 8])
@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_pac_decode_step_matches_jax(impl, kv_quant, tiny_cfg, torch_cfg, model):
    """The reference's one-request loop (teacher-forced prompt, then
    greedy tokens) under the port's ``ref`` and ``cuda`` OpSets against
    JAX ``ref``: equal greedy tokens, logits within LOGITS_TOL."""
    (jb, ja), (tb, ta) = model
    want_tokens, want = _greedy_jax(tiny_cfg, jb, ja, kv_quant)
    got_tokens, got = _greedy_torch(torch_cfg, tb, ta, kv_quant, impl)
    assert got_tokens == want_tokens
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL)


@pytest.mark.parametrize("kv_quant", [None, 8])
@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_pac_decode_step_int4_matches_jax(impl, kv_quant, tiny_cfg, torch_cfg, tiny_backbone,
                                          tiny_adapter):
    """The same loop over an INT4 backbone (the reference's ``--quant 4``):
    under ``cuda`` every projection takes ``quant_matmul``'s int4 branch
    (its plain version here) at M = 1; equal greedy tokens, logits within
    LOGITS_TOL of JAX ``ref``."""
    jb = quantize_tree(tiny_backbone, bits=4, min_size=1024)
    tb, ta = bridge.to_torch(_np(jb)), bridge.to_torch(_np(tiny_adapter))
    assert {leaf.bits for leaf in jax.tree.leaves(
        jb, is_leaf=lambda t: hasattr(t, "bits")) if hasattr(leaf, "bits")} == {4}
    want_tokens, want = _greedy_jax(tiny_cfg, jb, tiny_adapter, kv_quant)
    got_tokens, got = _greedy_torch(torch_cfg, tb, ta, kv_quant, impl)
    assert got_tokens == want_tokens
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL)


def test_pac_decode_step_routes_the_mix_through_adapter_fuse(torch_cfg, model, monkeypatch):
    """Under ``cuda`` every period's λ-mix calls the ``adapter_fuse``
    wrapper once (24 calls a step at full depth); ``ref`` and the paged
    engine's per-request bank (a request axis on W_down) never do."""
    (_, _), (tb, ta) = model
    calls = []
    real = adapter_fuse_mod.adapter_fuse

    def spy(b, w, a, lam):
        calls.append(tuple(b.shape))
        return real(b, w, a, lam)

    monkeypatch.setattr(adapter_fuse_mod, "adapter_fuse", spy)
    tok = {"tokens": torch.tensor([[3]], dtype=torch.int32)}
    for impl, want in (("cuda", torch_cfg.n_periods), ("ref", 0)):
        calls.clear()
        steps.pac_decode_step(tb, ta, tok, bb.init_cache(torch_cfg, 1, 4, kv_quant=8),
                              init_adapter_cache(torch_cfg, 1, 4, r=R), 0, cfg=torch_cfg, r=R,
                              kernel_impl=impl)
        assert len(calls) == want and set(calls) <= {(1, torch_cfg.d_model)}
    calls.clear()
    _paged(torch_cfg, tb, ta, [PROMPT], 1)
    assert calls == []


def _paged(cfg, tb, ta, prompts, n_steps, page=4):
    """Paged prefill + ``n_steps`` greedy decode steps at f32 KV with
    the cuda OpSet; per request: [prefill logits, step logits...]."""
    abatch = gather_adapters(stack_adapters([ta]), torch.zeros(len(prompts), dtype=torch.long))
    max_pages = MAX_LEN // page
    table = paging.PageTable(paging.PageAllocator(len(prompts) * max_pages + 1), page, max_pages)
    for i, p in enumerate(prompts):
        table.open(i, len(p))
    pools = paging.init_pools(cfg, table.allocator.n_pages, page, "f32", "cpu")
    bt, lengths = table.dense(range(len(prompts)))
    toks = np.zeros((len(prompts), max(map(len, prompts))), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lg, pools, acache = paged_prefill(tb, abatch, torch.from_numpy(toks), torch.from_numpy(lengths),
                                      pools, torch.from_numpy(bt), cfg=cfg, max_len=MAX_LEN, r=R)
    out = [lg[:, 0]]
    for _ in range(n_steps):
        tok = out[-1].argmax(-1).int()[:, None]
        for i in range(len(prompts)):
            table.extend_to(i, table.length(i) + 1)
        bt, lengths = table.dense(range(len(prompts)))
        lg, pools, acache = paged_pac_decode_step(tb, abatch, tok, pools, torch.from_numpy(bt),
                                                  torch.from_numpy(lengths), acache, cfg=cfg, r=R)
        for i in range(len(prompts)):
            table.append_token(i)
        out.append(lg[:, 0])
    return torch.stack(out, 1).numpy()


def test_paged_step_matches_linear_pac_decode_step(torch_cfg, model):
    """The port's paged engine step at f32 KV against the port's own
    one-request ``pac_decode_step`` loop (tests/test_decode_parity.py):
    the same greedy tokens, logits within 1e-4 (the paged path masks by
    position instead of slicing, so reductions reorder)."""
    (_, _), (tb, ta) = model
    prompts = [PROMPT, [3, 1], [8, 8, 4, 6]]
    paged = _paged(torch_cfg, tb, ta, prompts, N_NEW - 1)
    for i, prompt in enumerate(prompts):
        cache = bb.init_cache(torch_cfg, 1, MAX_LEN)
        acache = init_adapter_cache(torch_cfg, 1, MAX_LEN, r=R)
        seq = list(prompt)
        for pos in range(len(prompt) + N_NEW - 1):
            lg, cache, acache = steps.pac_decode_step(
                tb, ta, {"tokens": torch.tensor([[seq[pos]]], dtype=torch.int32)}, cache,
                acache, pos, cfg=torch_cfg, r=R, kernel_impl="cuda")
            if pos >= len(prompt) - 1:
                k = pos - len(prompt) + 1
                np.testing.assert_allclose(paged[i, k], lg[0, 0].numpy(), atol=1e-4)
                assert int(np.argmax(paged[i, k])) == int(lg[0, 0].argmax())
                seq.append(int(lg[0, 0].argmax()))
