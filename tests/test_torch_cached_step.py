"""The port's training kernels, backbone taps and PAC+ steps against the
JAX reference.

On the CPU the kernel wrappers (``mix_fwd``/``mix_dw``,
``ce_fwd``/``ce_bwd``) compute their plain versions, and the two
``autograd.Function``\\ s run those plain versions forward and backward,
so these tests hold the kernels' functions and their backward formulas
against the reference; ``chip_smoke.py`` holds the CUDA kernels against
the same plain versions on the card. The JAX side runs its Pallas
kernels in interpret mode or its jnp oracles. Inputs come from numpy
with fixed seeds; parameters are bridged from the JAX tree. Tolerances
are the reference's own (tests/test_cached_step.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import steps as jax_steps
from repro.core.activation_cache import ActivationCache as JaxCache
from repro.core.init_methods import pruning_init as jax_pruning_init
from repro.core.opset import get_opset as jax_get_opset
from repro.core.parallel_adapters import adapter_param_count as jax_adapter_param_count
from repro.core.quantization import quantize as jax_quantize
from repro.core.quantization import quantize_tree as jax_quantize_tree
from repro.kernels import cached_step as jax_cs
from repro.kernels import ref as jax_ref
from repro.models.backbone import backbone_forward as jax_backbone_forward
from repro.models.backbone import backbone_logits as jax_backbone_logits
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import steps
from repro_torch.core.init_methods import pruning_init
from repro_torch.core.opset import get_opset
from repro_torch.core.parallel_adapters import adapter_param_count
from repro_torch.core.quantization import tree_leaves, tree_map
from repro_torch.kernels import cached_mix, lmhead_ce
from repro_torch.kernels.cached_step import cached_loss_parts, dq_adapter_mix
from repro_torch.kernels.cached_step import lmhead_ce as lmhead_ce_op
from repro_torch.models.backbone import backbone_forward, backbone_logits
from repro_torch.optim import adamw_init, adamw_update

torch.set_num_threads(2)
R = 4


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _entry(b, storage):
    """The same entry in both packages' storage forms: (jax, torch).
    ``int8_q32``: int8 with one scale per 32 columns (the training path's
    quantization block is 128)."""
    if storage == "bf16":
        jb = jnp.asarray(b).astype(jnp.bfloat16)
        return jb, bridge.to_torch(np.asarray(jb))
    if storage.startswith("int8"):
        qt = jax_quantize(jnp.asarray(b), bits=8, block=32 if storage == "int8_q32" else 128)
        return {"q": qt.q, "scale": qt.scale}, bridge.to_torch(_np(qt))
    return jnp.asarray(b), torch.from_numpy(b)


def _assert_tree_close(jtree, ttree, atol):
    """Walk a JAX tree and its port counterpart key by key."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree)
        for k in jtree:
            _assert_tree_close(jtree[k], ttree[k], atol)
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree)
        for a, b in zip(jtree, ttree):
            _assert_tree_close(a, b, atol)
    else:
        np.testing.assert_allclose(bridge.to_numpy(ttree), np.asarray(jtree, np.float32),
                                   atol=atol, rtol=0)


def _assert_update_close(jnew, tnew, jgrads, atol=5e-5, lr=1e-3, flip=100 * 1e-8):
    """Updated parameters within ``atol`` — except where the reference's
    clipped gradient is within ``flip`` (default 100·eps) of 0: there
    AdamW's first step, ``lr·g/(|g| + eps)``, turns a last-bit difference
    of ``g`` into any fraction of ``lr``, so such elements are held to
    one step's reach. A config whose own gradients move by more than a
    last bit under an equal computation passes that noise as ``flip``."""
    norm = np.sqrt(sum(float(jnp.sum(g * g)) for g in jax.tree.leaves(jgrads)))
    scale = min(1.0, 1.0 / max(norm, 1e-12))

    def walk(j, t, g):
        if isinstance(j, dict):
            for k in j:
                walk(j[k], t[k], g[k])
        elif isinstance(j, (list, tuple)):
            for a, b, c in zip(j, t, g):
                walk(a, b, c)
        else:
            diff = np.abs(bridge.to_numpy(t) - np.asarray(j, np.float32))
            steep = np.abs(np.asarray(g)) * scale < flip
            assert diff[~steep].max(initial=0.0) <= atol, diff[~steep].max()
            assert diff[steep].max(initial=0.0) <= 2 * lr

    walk(jnew, tnew, jgrads)


@pytest.fixture(scope="module")
def torch_cfg(tiny_cfg):
    cfg = get_arch("internlm2-1.8b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tiny_cfg)
    return cfg


# ---------------------------------------------------------------------------
# Kernel functions: mix_fwd / mix_dw, ce_fwd / ce_bwd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int8_q32"])
@pytest.mark.parametrize("T,d,da", [(64, 256, 32), (100, 130, 17), (7, 300, 40)])
def test_mix_kernels_match_pallas(storage, T, d, da):
    """``mix_fwd`` (out and the bw residual) and ``mix_dw`` against the
    Pallas kernels they replace, aligned and ragged (d not a multiple of
    the quantization block, T not of any tile)."""
    b, w, a = _randn((T, d), 1), _randn((d, da), 2, 0.1), _randn((T, da), 3)
    g = _randn((T, da), 4)
    jb, tb = _entry(b, storage)
    q, scale = (jb["q"], jb["scale"]) if storage.startswith("int8") else (jb, None)
    want_out, want_bw = jax_cs._mix_fwd_impl(q, scale, jnp.asarray(w), jnp.asarray(a), 0.7,
                                             256, 128, 512, True)
    out, bw = cached_mix.mix_fwd(tb, torch.from_numpy(w), torch.from_numpy(a), 0.7)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bw.numpy(), np.asarray(want_bw), atol=1e-4, rtol=1e-4)
    want_dw = jax_cs._mix_dw_impl(q, scale, jnp.asarray(g), 0.7, d, jnp.float32, 256, 128, 256,
                                  True)
    dw = cached_mix.mix_dw(tb, torch.from_numpy(g), 0.7, d)
    assert dw.shape == (d, da) and dw.dtype == torch.float32
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int8_q32"])
@pytest.mark.parametrize("T,d,da", [(64, 256, 32), (100, 130, 17)])
def test_dq_adapter_mix_forward(storage, T, d, da):
    b, w, a = _randn((T, d), 5), _randn((d, da), 6, 0.1), _randn((T, da), 7)
    jb, tb = _entry(b, storage)
    want = jax_ref.dq_adapter_mix_ref(jb, jnp.asarray(w), jnp.asarray(a), 0.7, d)
    got = dq_adapter_mix(tb, torch.from_numpy(w), torch.from_numpy(a), 0.7)
    assert got.shape == (T, da) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_dq_adapter_mix_grads(storage):
    """The autograd Function's backward (dW from mix_dw, da, dλ) against
    JAX autodiff of the reference oracle; the entry gets no gradient."""
    T, d, da = 48, 256, 24
    b, w, a = _randn((T, d), 8), _randn((d, da), 9, 0.1), _randn((T, da), 10)
    jb, tb = _entry(b, storage)

    def loss_r(w_, a_, l_):
        return jnp.sum(jnp.sin(jax_ref.dq_adapter_mix_ref(jb, w_, a_, l_, d)))

    want = jax.grad(loss_r, argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(a), jnp.float32(0.3))
    tw, ta = torch.from_numpy(w).requires_grad_(), torch.from_numpy(a).requires_grad_()
    tl = torch.tensor(0.3, requires_grad=True)
    torch.sin(dq_adapter_mix(tb, tw, ta, tl)).sum().backward()
    for got, ref in zip((tw.grad, ta.grad, tl.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("T,d,V,cap", [(64, 128, 512, None), (50, 96, 300, 30.0),
                                       (8, 64, 1000, None)])
def test_ce_kernels_match_pallas(T, d, V, cap):
    """``ce_fwd`` (nll and lse) and ``ce_bwd`` against the Pallas kernels
    they replace — ragged vocab and tanh soft-cap included."""
    h, w = _randn((T, d), 11), _randn((d, V), 12, 0.05)
    lab = np.random.default_rng(13).integers(0, V, size=T).astype(np.int32)
    g = _randn((T,), 14)
    jh, jw, jl = jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab)
    want_nll, want_lse = jax_cs._ce_fwd_impl(jh, jw, jl, cap, 128, 512, True)
    th, tw, tl = torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(lab)
    nll, lse = lmhead_ce.ce_fwd(th, tw, tl, cap)
    np.testing.assert_allclose(nll.numpy(), np.asarray(want_nll), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=1e-5)
    want_dh = jax_cs._ce_bwd_impl(jh, jw, jl, want_lse, jnp.asarray(g), cap, 128, 512, True)
    dh = lmhead_ce.ce_bwd(th, tw, tl, lse, torch.from_numpy(g), cap)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("T,d,V,cap", [(64, 128, 512, None), (50, 96, 300, 30.0)])
def test_lmhead_ce_forward_and_grad(T, d, V, cap):
    h, w = _randn((T, d), 15), _randn((d, V), 16, 0.05)
    lab = np.random.default_rng(17).integers(0, V, size=T).astype(np.int32)
    jh, jw, jl = jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab)
    th = torch.from_numpy(h).requires_grad_()
    nll = lmhead_ce_op(th, torch.from_numpy(w), torch.from_numpy(lab), softcap=cap)
    np.testing.assert_allclose(nll.detach().numpy(),
                               np.asarray(jax_ref.lmhead_ce_ref(jh, jw, jl, softcap=cap)),
                               atol=2e-5, rtol=1e-5)
    torch.cos(nll).sum().backward()
    want = jax.grad(lambda h_: jnp.sum(jnp.cos(jax_ref.lmhead_ce_ref(h_, jw, jl, softcap=cap))))(jh)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_kernel_wrappers_validate():
    b = torch.zeros(8, 256)
    with pytest.raises(ValueError):
        cached_mix.mix_fwd(b, torch.zeros(300, 16), torch.zeros(8, 16), 0.5)  # d > d_store
    with pytest.raises(ValueError):
        cached_mix.mix_fwd(b.double(), torch.zeros(256, 16), torch.zeros(8, 16), 0.5)
    with pytest.raises(ValueError):
        lmhead_ce.ce_fwd(torch.zeros(8, 64), torch.zeros(32, 100), torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        lmhead_ce.ce_fwd(torch.zeros(8, 64), torch.zeros(64, 100), torch.zeros(8, dtype=torch.int32),
                         softcap=-1.0)


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on any device but the CPU goes to the kernel path, which
    refuses what is not a CUDA tensor: no silent fallback. The one other
    device with a plain path is ``meta``, the pricer's shapes
    (``repro_torch.launch.op_cost``): nothing is computed there, the
    plain version only gives the output's shape. Fake tensors stand for
    a card this machine has not (``xpu``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def inputs(device):
        dev = dict(device=device)
        return (torch.zeros(8, 256, **dev), torch.zeros(8, 16, **dev),
                torch.zeros(256, 16, **dev), torch.zeros(8, 64, **dev),
                torch.zeros(64, 100, **dev), torch.zeros(8, dtype=torch.int32, **dev),
                torch.zeros(8, **dev))

    with FakeTensorMode():
        b, g, wd, h, w, lab, vec = inputs("xpu")
        with pytest.raises(ValueError, match="unsupported device"):
            cached_mix.mix_fwd(b, wd, g, 0.5)
        with pytest.raises(ValueError, match="unsupported device"):
            cached_mix.mix_dw(b, g, 0.5, 256)
        with pytest.raises(ValueError, match="unsupported device"):
            lmhead_ce.ce_fwd(h, w, lab)
        with pytest.raises(ValueError, match="unsupported device"):
            lmhead_ce.ce_bwd(h, w, lab, vec, vec)
    b, g, wd, h, w, lab, vec = inputs("meta")
    out, bw = cached_mix.mix_fwd(b, wd, g, 0.5)
    assert out.shape == bw.shape == (8, 16) and out.device.type == "meta"
    assert cached_mix.mix_dw(b, g, 0.5, 256).shape == (256, 16)
    nll, lse = lmhead_ce.ce_fwd(h, w, lab)
    assert nll.shape == lse.shape == (8,) and nll.device.type == "meta"
    assert lmhead_ce.ce_bwd(h, w, lab, vec, vec).shape == (8, 64)


# ---------------------------------------------------------------------------
# The tap seam and the backbone forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["int8", "bf16", "f32"])
def test_emit_tap_matches_reference_bit_for_bit(policy):
    h = _randn((2, 5, 300), 18, 3.0)
    want = jax_get_opset("pallas", policy, interpret=True).emit_tap(jnp.asarray(h))
    got = get_opset("cuda", policy).emit_tap(torch.from_numpy(h))
    if policy == "int8":
        assert got.block == 128 and got.orig_last == 300
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want["scale"]))
    else:
        np.testing.assert_array_equal(bridge.to_numpy(got).view(np.uint8),
                                      np.asarray(want).view(np.uint8))
    assert get_opset("ref", policy).emit_tap(torch.from_numpy(h)) is not None
    assert get_opset("cuda", policy) is get_opset("cuda", policy)


@pytest.mark.parametrize("quant", [None, 8, 4])
def test_backbone_forward_taps_match_reference(tiny_cfg, tiny_backbone, tiny_batch, torch_cfg,
                                               quant):
    bp = tiny_backbone if quant is None else jax_quantize_tree(tiny_backbone, bits=quant)
    want = jax_backbone_forward(bp, tiny_cfg, tiny_batch, collect_taps=True, return_inputs=True)
    tbatch = {"tokens": torch.from_numpy(np.array(tiny_batch["tokens"]))}
    got = backbone_forward(bridge.to_torch(_np(bp)), torch_cfg, tbatch, collect_taps=True,
                           return_inputs=True)
    assert got[1].shape == (torch_cfg.n_periods,) + tuple(got[0].shape)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        backbone_logits(bridge.to_torch(_np(bp)), torch_cfg, tbatch).numpy(),
        np.asarray(jax_backbone_logits(bp, tiny_cfg, tiny_batch)), atol=1e-4, rtol=1e-4)


def test_backbone_forward_emits_storage_form(tiny_backbone, tiny_batch, torch_cfg):
    """Under the cuda OpSet with the int8 policy the stacked taps are one
    QTensor, payload and scales both stacked over periods, equal to the
    ref OpSet's taps quantized afterwards."""
    from repro_torch.core.quantization import quantize

    bp = bridge.to_torch(_np(jax_quantize_tree(tiny_backbone, bits=8)))
    batch = {"tokens": torch.from_numpy(np.array(tiny_batch["tokens"]))}
    taps = backbone_forward(bp, torch_cfg, batch, collect_taps=True,
                            ops=get_opset("cuda", "int8"))[1]
    ref_taps = backbone_forward(bp, torch_cfg, batch, collect_taps=True)[1]
    want = quantize(ref_taps, 8, 128)
    assert taps.q.dtype == torch.int8 and taps.q.shape == want.q.shape
    assert taps.scale.shape == (torch_cfg.n_periods,) + tuple(ref_taps.shape[1:3]) + (2,)
    assert (taps.q.int() - want.q.int()).abs().max() <= 1  # f32 sums reorder
    np.testing.assert_allclose(taps.scale.numpy(), want.scale.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# Optimizer, init, parameter count
# ---------------------------------------------------------------------------


def test_adamw_and_clip_match_reference():
    from repro.optim import clip_by_global_norm as jax_clip
    from repro_torch.optim import clip_by_global_norm

    params = {"w": _randn((5, 7), 19), "b": [_randn((7,), 20), _randn((3, 2), 21)]}
    jp, tp = jax.tree.map(jnp.asarray, params), bridge.to_torch(params)
    jopt, topt = jax_adamw_init(jp), adamw_init(tp)
    for step in range(3):
        grads = {"w": _randn((5, 7), 30 + step, 3.0),
                 "b": [_randn((7,), 40 + step), _randn((3, 2), 50 + step)]}
        jg, jn = jax_clip(jax.tree.map(jnp.asarray, grads), 1.0)
        tg, tn = clip_by_global_norm(bridge.to_torch(grads), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        jp, jopt = jax_adamw_update(jp, jg, jopt, lr=3e-3)
        tp, topt = adamw_update(tp, tg, topt, lr=3e-3)
    _assert_tree_close(jp, tp, atol=1e-7)
    _assert_tree_close(jopt["mu"], topt["mu"], atol=1e-7)
    _assert_tree_close(jopt["nu"], topt["nu"], atol=1e-7)
    assert int(topt["count"]) == int(jopt["count"]) == 3


def test_pruning_init_matches_reference(tiny_cfg, tiny_backbone, torch_cfg):
    want = jax_pruning_init(jax.random.PRNGKey(1), tiny_backbone, tiny_cfg, r=R)
    got = pruning_init(torch.Generator().manual_seed(1), bridge.to_torch(_np(tiny_backbone)),
                       torch_cfg, r=R)
    _assert_tree_close(want, got, atol=0.0)


@pytest.mark.parametrize("r", [4, 8])
def test_adapter_param_count_matches_reference(tiny_cfg, torch_cfg, r):
    from repro.configs import get_arch as jax_get_arch

    assert adapter_param_count(torch_cfg, r) == jax_adapter_param_count(tiny_cfg, r)
    full = jax_get_arch("internlm2-1.8b")
    assert adapter_param_count(get_arch("internlm2-1.8b"), r) == jax_adapter_param_count(full, r)


# ---------------------------------------------------------------------------
# PAC+ steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_state(tiny_cfg, tiny_backbone, tiny_adapter, tiny_batch):
    """The epoch-1 reference step and its activations."""
    opt = jax_adamw_init(tiny_adapter)
    out = jax_steps.pac_train_step(tiny_backbone, tiny_adapter, opt, tiny_batch, cfg=tiny_cfg,
                                   r=R)
    return opt, out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("kernel_impl", ["ref", "cuda"])
def test_pac_train_step_matches_reference(tiny_cfg, tiny_backbone, tiny_adapter, tiny_batch,
                                          torch_cfg, jax_state, kernel_impl):
    """Epoch-1 step (f32 taps) against JAX ``kernel_impl="ref"``: the
    ``cuda`` composition runs the mix and CE Functions forward and
    backward (plain versions on the CPU)."""
    _, (loss, ap, _, (b0, taps, bf)) = jax_state
    tap = bridge.to_torch(_np(tiny_adapter))
    got = steps.pac_train_step(bridge.to_torch(_np(tiny_backbone)), tap, adamw_init(tap),
                               _torch_batch(tiny_batch), cfg=torch_cfg, r=R,
                               kernel_impl=kernel_impl)
    assert abs(float(got[0]) - float(loss)) < 2e-5
    jgrads = jax.grad(lambda a: jax_steps.pac_loss_fn(a, tiny_backbone, tiny_cfg, tiny_batch, R))(
        tiny_adapter)
    _assert_update_close(ap, got[1], jgrads)
    for g, w in zip(got[3], (b0, taps, bf)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def _cached(policy, b0, taps, bf, labels, compressed):
    cache = JaxCache(budget_bytes=1 << 30, compress=policy)
    ids = list(range(b0.shape[0]))
    cache.put_batch(ids, b0, taps, bf)
    hit = cache.get_batch(ids, with_final=True, dtype=None, compressed=compressed)
    return {"b0": hit[0], "taps": hit[1], "b_final": hit[2], "labels": np.asarray(labels)}


def _to_port(cached, d):
    """The reference's {"q", "scale"} entries become the port's QTensor."""
    def one(v):
        if isinstance(v, dict):
            v = bridge.NumpyQTensor(v["q"], v["scale"], 8,
                                    v["q"].shape[-1] // v["scale"].shape[-1], d)
        return bridge.to_torch(v)

    return {k: one(v) for k, v in cached.items()}


@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_pac_cached_train_step_matches_reference_per_policy(
        tiny_cfg, tiny_backbone, tiny_adapter, tiny_batch, torch_cfg, jax_state, policy):
    """Storage-form entries (int8 as QTensor, bf16 as bf16) through the
    port's cached step, ``cuda`` and ``ref``, against JAX
    ``kernel_impl="ref"`` on the same entries: loss, gradients and the
    updated parameters."""
    opt, (_, _, _, (b0, taps, bf)) = jax_state
    jc = _cached(policy, b0, taps, bf, tiny_batch["labels"], True)
    tc = _to_port(jc, tiny_cfg.d_model)
    if policy == "int8":
        assert tc["taps"].q.dtype == torch.int8 and tc["taps"].q.shape[0] == tiny_cfg.n_periods
    jstep = jax.jit(functools.partial(jax_steps.pac_cached_train_step, cfg=tiny_cfg, r=R,
                                      kernel_impl="ref"))
    jloss, jap, _ = jstep(tiny_backbone, tiny_adapter, opt,
                          jax.tree.map(jnp.asarray, jc))
    tbp, tap = bridge.to_torch(_np(tiny_backbone)), bridge.to_torch(_np(tiny_adapter))
    B, S = tiny_batch["labels"].shape
    jpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def jloss_fn(a):
        num, den = jax_cs.cached_loss_parts(tiny_backbone, a, tiny_cfg,
                                            jax.tree.map(jnp.asarray, jc), jpos, R, impl="ref")
        return num / jnp.maximum(den, 1)

    jgrads = jax.grad(jloss_fn)(tiny_adapter)
    gmax = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jgrads))
    tpos = torch.arange(S, dtype=torch.int32).expand(B, S)
    for impl in ("cuda", "ref"):
        loss, ap, _ = steps.pac_cached_train_step(tbp, tap, adamw_init(tap), tc, cfg=torch_cfg,
                                                  r=R, kernel_impl=impl)
        assert abs(float(loss) - float(jloss)) < 2e-5, impl
        _assert_update_close(jap, ap, jgrads)
        ta = tree_map(lambda t: t.clone().requires_grad_(), tap)
        num, den = cached_loss_parts(tbp, ta, torch_cfg, tc, tpos, R, impl=impl)
        grads = torch.autograd.grad(num / den.clamp_min(1), tree_leaves(ta))
        it = iter(grads)
        _assert_tree_close(jgrads, tree_map(lambda _: next(it), ta),
                           atol=1e-4 * max(1.0, gmax))
