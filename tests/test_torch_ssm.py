"""The port's SSM mixers (``repro_torch.models.ssm``: Mamba, mLSTM, sLSTM)
and the SSM configs served.

Twins of tests/test_ssm.py on the port (each mixer's chunked forward
against its step-by-step decode at the reference's 2e-4, the mLSTM's
chunk invariance and long-range memory, finite gradients through the
chunked Mamba scan), then the cross-package checks: inputs and
parameters from the JAX package (numpy with a fixed seed, the JAX
initialisers' trees bridged across), each mixer's forward and decode
against the JAX function at 1e-5, with S not a multiple of the chunk,
their gradients against ``jax.grad`` at 1e-4·max(1, |g|max), and the
INT8 backbone's SSM leaves quantized where and as ``quantize_tree``
quantizes them, bit for bit. Then xlstm-125m and jamba-1.5-large-398b
reduced served: both packages' ``ServeEngine`` on the stepwise prompt
path, token for token, a request admitted into a retired slot, and
``pac_decode_step`` over the SSM state.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import steps as jax_steps
from repro.core.parallel_adapters import init_adapter
from repro.core.parallel_adapters import init_adapter_cache as jax_init_adapter_cache
from repro.core.quantization import quantize_tree as jax_quantize_tree
from repro.models import backbone as jbb
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import steps
from repro_torch.core.opset import get_opset
from repro_torch.core.parallel_adapters import init_adapter_cache
from repro_torch.core.quantization import QTensor, quantize_tree, tree_leaves, tree_map
from repro_torch.models import ssm
from repro_torch.models import backbone as tbb
from repro_torch.models.backbone import init_backbone
from repro_torch.models.layers import LeafMaker

torch.set_num_threads(2)
KINDS = ("mamba", "mlstm", "slstm")


def _cfg(kind, **kw):
    """xlstm-125m reduced for the xLSTM kinds, jamba reduced for Mamba."""
    arch = "jamba-1.5-large-398b" if kind == "mamba" else "xlstm-125m"
    return dataclasses.replace(get_arch(arch).reduced(), **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _init(kind, cfg, seed=0):
    """The port's own draw of one mixer (CPU generator)."""
    init = ssm.MIXERS[kind][0]
    return init(LeafMaker(torch.Generator().manual_seed(seed)), cfg)


def _walk(jtree, ttree, fn):
    """``fn(jax leaf, port leaf)`` over two trees, key by key (a
    quantized leaf, either package's, is a leaf)."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree)
        for k in jtree:
            _walk(jtree[k], ttree[k], fn)
    elif isinstance(jtree, (list, tuple)) and not hasattr(jtree, "q"):
        assert len(jtree) == len(ttree)
        for a, b in zip(jtree, ttree):
            _walk(a, b, fn)
    else:
        fn(jtree, ttree)


def _decode_all(kind, p, x, cfg):
    """x (B,S,d) one step at a time from a fresh state: (outputs (B,S,d), state)."""
    state = ssm.init_state(cfg, kind, x.shape[0])
    outs = []
    for t in range(x.shape[1]):
        o, state = ssm.MIXERS[kind][2](p, x[:, t:t + 1], cfg, state)
        outs.append(o)
    return torch.cat(outs, 1), state


# ---------------------------------------------------------------------------
# twins of tests/test_ssm.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,S,kw", [("mlstm", 13, dict(mlstm_chunk=5)), ("slstm", 9, {}),
                                       ("mamba", 11, {})])
def test_forward_vs_decode(kind, S, kw):
    """The chunked forward (mLSTM chunk 5 over S = 13; sLSTM and Mamba in
    chunks of 4) against the recurrent decode, step by step: 2e-4."""
    cfg = _cfg(kind, **kw)
    p = _init(kind, cfg)
    x = torch.from_numpy(_randn((2, S, cfg.d_model), 1, 0.5))
    chunk = {} if kind == "mlstm" else {"chunk": 4}
    full = ssm.MIXERS[kind][1](p, x, cfg, **chunk)
    dec, _ = _decode_all(kind, p, x, cfg)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-4, rtol=0)


@pytest.mark.parametrize("S", [2, 11])
def test_mamba_forward_returns_the_decode_state(S):
    """``mamba_forward(return_state=True)``: the cache the decode holds
    after the same S tokens (S below and above the conv's 3-step window),
    ``h`` within 1e-6, the conv window within 1e-5."""
    cfg = _cfg("mamba")
    p = _init("mamba", cfg, 4)
    x = torch.from_numpy(_randn((2, S, cfg.d_model), 5, 0.5))
    _, state = ssm.mamba_forward(p, x, cfg, chunk=4, return_state=True)
    _, want = _decode_all("mamba", p, x, cfg)
    torch.testing.assert_close(state["h"], want["h"], atol=1e-6, rtol=0)
    torch.testing.assert_close(state["conv"], want["conv"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_mlstm_chunk_invariance(chunk):
    """The mLSTM's output does not depend on its chunk size."""
    cfg = _cfg("mlstm")
    p = _init("mlstm", cfg, 2)
    x = torch.from_numpy(_randn((1, 17, cfg.d_model), 3, 0.5))
    a = ssm.mlstm_forward(p, x, dataclasses.replace(cfg, mlstm_chunk=chunk))
    b = ssm.mlstm_forward(p, x, dataclasses.replace(cfg, mlstm_chunk=17))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=0)


def test_mamba_gradients_finite_through_chunked_scan():
    """Gradients through the checkpointed chunks of the Mamba scan: finite,
    and equal to those of one unchunked scan within 1e-5·max(1, |g|max)."""
    cfg = _cfg("mamba")
    p = tree_map(lambda t: t.requires_grad_(), _init("mamba", cfg, 8))
    x = torch.from_numpy(_randn((1, 16, cfg.d_model), 9))
    grads = {}
    for chunk in (4, 16):
        loss = torch.sum(torch.square(ssm.mamba_forward(p, x, cfg, chunk=chunk)))
        grads[chunk] = torch.autograd.grad(loss, list(p.values()))
    gmax = max(float(g.abs().max()) for g in grads[16])
    for a, b in zip(grads[4], grads[16]):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, gmax), rtol=0)


def test_mlstm_long_range_memory():
    """The matrix memory carries a change of the first token across chunk
    boundaries to the last one."""
    cfg = _cfg("mlstm", mlstm_chunk=4)
    p = _init("mlstm", cfg, 10)
    x = torch.from_numpy(_randn((1, 16, cfg.d_model), 11))
    base = ssm.mlstm_forward(p, x, cfg)
    x2 = x.clone()
    x2[0, 0] += 1.0
    pert = ssm.mlstm_forward(p, x2, cfg)
    assert float((pert[0, -1] - base[0, -1]).abs().max()) > 1e-6


def test_mlstm_output_gate_starts_equal_to_wq():
    """As the reference draws it (from wq's key), plain or INT8."""
    cfg = _cfg("mlstm")
    p = _init("mlstm", cfg)
    assert torch.equal(p["ogate"], p["wq"]) and p["ogate"] is not p["wq"]
    q = init_backbone(torch.Generator().manual_seed(0), cfg, quant_bits=8)["blocks"][0]["mixer"]
    assert isinstance(q["ogate"], QTensor) and torch.equal(q["ogate"].q, q["wq"].q)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _jax_mixer(kind, seed=0):
    """(the JAX reduced config, its mixer params, the port's config, the
    same params bridged)."""
    arch = "jamba-1.5-large-398b" if kind == "mamba" else "xlstm-125m"
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), mlstm_chunk=16)
    jp = getattr(jssm, f"init_{kind}")(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, _cfg(kind, mlstm_chunk=16), bridge.to_torch(_np(jp))


def _chunk_kw(kind):
    return {} if kind == "mlstm" else {"chunk": 16}


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(kind):
    """S = 37 over chunks of 16, the last one ragged: 1e-5."""
    jcfg, jp, tcfg, tp = _jax_mixer(kind)
    x = _randn((2, 37, jcfg.d_model), 21, 0.5)
    want = getattr(jssm, f"{kind}_forward")(jp, jnp.asarray(x), jcfg, **_chunk_kw(kind))
    got = ssm.MIXERS[kind][1](tp, torch.from_numpy(x), tcfg, **_chunk_kw(kind))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_matches_jax(kind):
    """Seven decode steps from each package's fresh state: every step's
    output and the final state at 1e-5."""
    jcfg, jp, tcfg, tp = _jax_mixer(kind, 1)
    x = _randn((3, 7, jcfg.d_model), 22, 0.5)
    jstate, outs = getattr(jssm, f"init_{kind}_cache")(jcfg, 3), []
    for t in range(x.shape[1]):
        o, jstate = getattr(jssm, f"{kind}_decode")(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jstate)
        outs.append(np.asarray(o))
    got, tstate = _decode_all(kind, tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.concatenate(outs, 1), atol=1e-5, rtol=0)
    assert set(tstate) == set(jstate)
    for k in jstate:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax(kind):
    """The gradient of ``sum(out · g)`` (g seeded) with respect to every
    parameter and the input, through the chunked forward (checkpointed
    here, ``jax.checkpoint``ed there): 1e-4·max(1, |g|max)."""
    jcfg, jp, tcfg, tp = _jax_mixer(kind, 2)
    x = _randn((2, 21, jcfg.d_model), 23, 0.5)
    g = _randn((2, 21, jcfg.d_model), 24)
    fwd = getattr(jssm, f"{kind}_forward")

    def jloss(p, xx):
        return jnp.sum(fwd(p, xx, jcfg, **_chunk_kw(kind)) * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(), tp)
    tx = torch.from_numpy(x).requires_grad_()
    out = ssm.MIXERS[kind][1](tp, tx, tcfg, **_chunk_kw(kind))
    leaves = tree_leaves(tp)
    *tgp, tgx = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), leaves + [tx])
    want = jax.tree.leaves(jgp) + [jgx]
    gmax = max(float(jnp.max(jnp.abs(w))) for w in want)
    assert len(want) == len(tgp) + 1
    for w, t in zip(want, tgp + [tgx]):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-4 * max(1.0, gmax), rtol=0)


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_int8_ssm_leaves_equal_quantize_tree(arch):
    """The reduced backbone from the JAX package, quantized by the port
    (``quantize_tree``, int8): every leaf's codes and scales bit-equal to
    the reference's ``quantize_tree``. And at full width, on the meta
    device, the port's ``init_backbone(quant_bits=8)`` quantizes exactly
    the leaves the reference's ``quantize_tree`` does, with the same
    storage shapes: jamba's ``a_log`` (n_p, 16384, 16) among them, and
    xlstm's period-stacked mLSTM gates ``wi``/``wf`` (3, 768, 4), 9216
    values, past the 4096 threshold."""
    jcfg = jax_get_arch(arch).reduced()
    jb = jbb.init_backbone(jax.random.PRNGKey(0), jcfg)

    def equal(w, g):
        assert hasattr(w, "q") == isinstance(g, QTensor)
        if isinstance(g, QTensor):
            assert (g.bits, g.block, g.orig_last) == (w.bits, w.block, w.orig_last)
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    _walk(jax_quantize_tree(jb, bits=8), quantize_tree(bridge.to_torch(_np(jb)), bits=8), equal)

    def same_layout(w, g):
        assert hasattr(w, "q") == isinstance(g, QTensor)
        if isinstance(g, QTensor):
            assert (tuple(g.q.shape), tuple(g.scale.shape), g.block) == (
                tuple(w.q.shape), tuple(w.scale.shape), w.block)
        else:
            assert tuple(g.shape) == tuple(w.shape)

    full = jax_get_arch(arch)
    shapes = jax.eval_shape(lambda: jax_quantize_tree(jbb.init_backbone(jax.random.PRNGKey(0),
                                                                         full), bits=8))
    meta = init_backbone(torch.Generator().manual_seed(0), get_arch(arch), device="meta",
                         quant_bits=8)
    _walk(shapes, meta, same_layout)
    mixer = meta["blocks"][0]["mixer"]
    if arch == "jamba-1.5-large-398b":
        assert isinstance(mixer["a_log"], QTensor) and mixer["a_log"].shape == (9, 16384, 16)
    else:
        assert isinstance(mixer["wi"], QTensor) and mixer["wi"].shape == (3, 768, 4)
        assert not isinstance(mixer["f_bias"], QTensor)


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_cuda_opset_prepares_ssm_blocks(arch):
    """The ``cuda`` OpSet dequantizes an SSM block's norm and mixer (its
    scans run dense, as the reference's pallas OpSet runs them) and keeps
    a dense FFN beside it quantized for ``quant_matmul``; jamba's MoE
    experts are dequantized."""
    cfg = get_arch(arch).reduced()
    params = init_backbone(torch.Generator().manual_seed(0), cfg, quant_bits=8)
    ops = get_opset("cuda")
    for spec, block in zip(cfg.pattern, params["blocks"]):
        if spec.kind == "attn":
            continue
        p = ops.prepare_block(tree_map(lambda t: t[0], block), spec)
        assert not any(isinstance(t, QTensor) for t in tree_leaves(p["mixer"]))
        if "ffn" in p:
            quantized = [isinstance(t, QTensor) for t in tree_leaves(p["ffn"])]
            assert all(quantized) if not spec.moe else not any(quantized)


# ---------------------------------------------------------------------------
# the SSM configs served: pac_decode_step and the stepwise engine
# ---------------------------------------------------------------------------

R = 4

SSM_ARCHS = ["xlstm-125m", "jamba-1.5-large-398b"]
SERVE_LENS = (5, 9, 3, 7, 4)  # five prompts through two slots: three admissions into retired rows
SERVE_NEW, SERVE_MAX_LEN, SERVE_PAGE = 4, 32, 4


@functools.lru_cache(maxsize=None)
def _served(arch):
    """(the JAX config, the port's, the INT8 backbone, two users' adapters,
    the prompts): the reduced backbone quantized by the reference's
    ``quantize_tree`` (int8, every matrix from 1024 values), the adapters
    drawn by the reference."""
    jcfg, tcfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    qb = jax_quantize_tree(jbb.init_backbone(jax.random.PRNGKey(0), jcfg), bits=8,
                           min_size=1024)
    users = {f"user{i}": init_adapter(jax.random.PRNGKey(11 + i), jcfg, r=R) for i in range(2)}
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, jcfg.vocab, size=n).tolist() for n in SERVE_LENS]
    return jcfg, tcfg, qb, users, prompts


def _port_engine(arch, kernel_impl, max_batch=2):
    from repro_torch.serve import ServeEngine

    _, tcfg, qb, users, _ = _served(arch)
    return ServeEngine(bridge.to_torch(_np(qb)), tcfg,
                       {n: bridge.to_torch(_np(a)) for n, a in users.items()}, r=R,
                       kernel_impl=kernel_impl, kv_policy="int8", page_size=SERVE_PAGE,
                       max_len=SERVE_MAX_LEN, max_batch=max_batch, device="cpu")


@pytest.mark.parametrize("kernel_impl", ["ref", "cuda"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_stepwise_engine_matches_jax(arch, kernel_impl):
    """Both packages' ``ServeEngine`` on the INT8 backbone, int8 KV pages
    (jamba's attention layers), two slots, five requests over two users:
    the stepwise prompt path in both, and the greedy tokens of every
    request equal."""
    from repro.serve import ServeEngine as JaxEngine

    jcfg, _, qb, users, prompts = _served(arch)
    jeng = JaxEngine(qb, jcfg, users, r=R, kernel_impl="ref", kv_policy="int8",
                     page_size=SERVE_PAGE, max_len=SERVE_MAX_LEN, max_batch=2)
    teng = _port_engine(arch, kernel_impl)
    assert jeng.prefill_mode == teng.prefill_mode == "stepwise"
    want = [jeng.submit(p, f"user{i % 2}", max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)]
    got = [teng.submit(p, f"user{i % 2}", max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)]
    jeng.drain()
    teng.drain()
    assert [h.result() for h in got] == [h.result() for h in want]
    assert teng.stepwise_prompt_tokens == sum(n - 1 for n in SERVE_LENS)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_stepwise_admission_into_a_retired_row(arch):
    """A request admitted into a slot whose request has retired (its SSM
    state rows and adapter-cache row moved or left behind) gives the
    tokens it gives alone in a fresh engine: admission zeroes the row."""
    _, _, _, _, prompts = _served(arch)
    eng = _port_engine(arch, "cuda")
    short = eng.submit(prompts[2], "user0", max_new_tokens=1)  # retires first
    long_ = eng.submit(prompts[1], "user1", max_new_tokens=SERVE_NEW)
    late = eng.submit(prompts[0], "user0", max_new_tokens=SERVE_NEW)
    eng.drain()
    assert short.done and long_.done
    alone = _port_engine(arch, "cuda")
    want = alone.submit(prompts[0], "user0", max_new_tokens=SERVE_NEW)
    alone.drain()
    assert late.result() == want.result()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_pac_decode_step_matches_jax(arch):
    """``pac_decode_step`` at B = 2 over each package's fresh caches (SSM
    states, jamba's f32 linear KV), 6 teacher-forced tokens: the logits
    of every step within 1e-4, or eight times the reference's own move
    between its decode and its one pass over the same tokens
    (``pac_logits``), where that is larger (xlstm: the mLSTM's f32 noise,
    the rule of tests/test_torch_families.py's ``_ref_noise``)."""
    from repro.core.parallel_adapters import pac_logits as jax_pac_logits

    jcfg, tcfg, qb, users, _ = _served(arch)
    adapter = users["user0"]
    toks = np.random.default_rng(17).integers(0, jcfg.vocab, size=(2, 6)).astype(np.int32)
    tbp, tap = bridge.to_torch(_np(qb)), bridge.to_torch(_np(adapter))
    jc, jac = jbb.init_cache(jcfg, 2, 6), jax_init_adapter_cache(jcfg, 2, 6, R)
    tc, tac = tbb.init_cache(tcfg, 2, 6), init_adapter_cache(tcfg, 2, 6, R)
    b_final, taps, x0, pos = jbb.backbone_forward(qb, jcfg, {"tokens": jnp.asarray(toks)},
                                                  collect_taps=True, return_inputs=True)
    one_pass = np.asarray(jax_pac_logits(qb, adapter, jcfg, x0, taps, b_final, pos, R))
    wants, gots = [], []
    for t in range(6):
        want, jc, jac = jax_steps.pac_decode_step(
            qb, adapter, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc, jac, jnp.int32(t),
            cfg=jcfg, r=R)
        got, tc, tac = steps.pac_decode_step(
            tbp, tap, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, tc, tac, t, cfg=tcfg, r=R,
            kernel_impl="cuda")
        wants.append(np.asarray(want))
        gots.append(got.numpy())
    wants, gots = np.concatenate(wants, 1), np.concatenate(gots, 1)
    noise = float(np.abs(wants - one_pass).max())
    np.testing.assert_allclose(gots, wants, atol=max(1e-4, 8 * noise), rtol=1e-4)
