"""The port's baselines (``repro_torch.core.peft``: LoRA and Houlsby
adapters; ``full_``/``lora_``/``houlsby_train_step``) and its
``distillation_init`` against the JAX package.

Inputs come from numpy with fixed seeds; the JAX trees are carried across
with ``repro_torch.bridge``. Tolerances are the reference's own, those of
tests/test_torch_families.py: logits 1e-4 (abs and rel), a step's loss
2e-5 and its updated parameters 5e-5 under the clipped-gradient rule of
``_assert_update_close`` (an element whose gradient is within 100·eps of
0 is held to one AdamW step's reach, 2·lr).
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cached_step import _assert_update_close

from repro.configs import get_arch as jax_get_arch
from repro.core import peft as jax_peft
from repro.core import steps as jax_steps
from repro.core.init_methods import distillation_init as jax_distillation_init
from repro.core.init_methods import pruning_init as jax_pruning_init
from repro.core.parallel_adapters import init_adapter as jax_init_adapter
from repro.core.quantization import quantize_tree as jax_quantize_tree
from repro.models import backbone as jbb
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.configs.base import LayerSpec
from repro_torch.core import peft, steps
from repro_torch.core.init_methods import _distill, distillation_init
from repro_torch.core.opset import CudaOpSet, RefOpSet
from repro_torch.core.quantization import QTensor, quantize_tree, tree_leaves
from repro_torch.models import backbone as tbb
from repro_torch.optim import adamw_init

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
ARCHS = ["internlm2-1.8b", "gemma2-2b", "t5-base-pac", "musicgen-large", "mixtral-8x7b",
         "xlstm-125m", "jamba-1.5-large-398b", "qwen2-vl-7b"]
B, S = 2, 40  # S > gemma2's reduced window (32): its local layers mask
R = 4  # the distilled adapter's reduction, as tests/test_parallel_adapters.py:124


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=0, seq=S):
    """The same seeded batch for both packages: (jax, torch); musicgen is
    fed frame embeddings, as tests/test_torch_families.py feeds it."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, size=(B, seq)).astype(np.int32)}
    if cfg.frontend is not None:
        batch["embeds"] = (rng.standard_normal((B, seq, cfg.d_model)) * 0.3).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, size=(B, seq)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(the JAX reduced config, the port's, the JAX backbone)."""
    jcfg, tcfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    # one compiled program rather than each eager op's (the cold-cache cost)
    return jcfg, tcfg, jax.jit(jbb.init_backbone, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


def _seeded(tree, names, seed, scale):
    """``tree`` with the leaves under ``names`` redrawn from numpy (so the
    zero-initialised B and ``up`` carry a signal through the comparison)."""
    rng = np.random.default_rng(seed)
    return {**tree, "layers": [
        {k: (jnp.asarray((rng.standard_normal(v.shape) * scale).astype(np.float32))
             if k in names else v) for k, v in layer.items()}
        for layer in tree["layers"]]}


@functools.lru_cache(maxsize=None)
def _peft_params(arch):
    """JAX LoRA (B non-zero) and Houlsby (``up``, ``ln`` non-zero) trees."""
    jcfg, _, _ = _model(arch)
    lora = _seeded(jax_peft.init_lora(jax.random.PRNGKey(1), jcfg), ("b_q", "b_v"), 11, 0.05)
    houlsby = _seeded(jax_peft.init_houlsby(jax.random.PRNGKey(2), jcfg), ("up", "ln"), 12, 0.1)
    return lora, houlsby


@pytest.fixture(scope="module", autouse=True)
def _first_config_drawn():
    """The first config's trees drawn and its JAX baseline logits computed
    before any test of the module runs, so that no test depends on being
    the one that draws and compiles first."""
    jcfg, _, backbone = _model(ARCHS[0])
    lora, houlsby = _peft_params(ARCHS[0])
    jb = _batch(jcfg)[0]
    jax.jit(lambda bp, lp, hp: (jax_peft.lora_logits(bp, lp, jcfg, jb),
                                jax_peft.houlsby_logits(bp, hp, jcfg, jb)))(backbone, lora, houlsby)


# ---------------------------------------------------------------------------
# Inits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_inits_match_the_reference(arch):
    """``init_lora`` and ``init_houlsby``: the reference's shapes, dtypes
    and zeros, ``alpha`` = 2·rank, the Gaussian leaves at N(0, 1)·d^-0.5
    (mean and standard deviation within 5 % over their draws), and
    ``peft_param_count`` equal to the reference's."""
    jcfg, tcfg, _ = _model(arch)
    gen = torch.Generator().manual_seed(0)
    pairs = [(jax_peft.init_lora(jax.random.PRNGKey(1), jcfg), peft.init_lora(gen, tcfg)),
             (jax_peft.init_houlsby(jax.random.PRNGKey(2), jcfg), peft.init_houlsby(gen, tcfg))]
    for want, got in pairs:
        assert jax.tree.structure(_np(want)) == jax.tree.structure(bridge.to_numpy(got))
        assert peft.peft_param_count(got) == jax_peft.peft_param_count(want)
        for jl, tl in zip(jax.tree.leaves(want), jax.tree.leaves(bridge.to_numpy(got))):
            jl = np.asarray(jl)
            assert tl.shape == jl.shape and tl.dtype == np.float32
            if not jl.any():
                assert not tl.any()
            elif jl.ndim:
                z = tl * tcfg.d_model ** 0.5
                assert abs(z.mean()) < 0.05 and abs(z.std() - 1.0) < 0.05
    assert float(pairs[0][1]["alpha"]) == float(pairs[0][0]["alpha"]) == 16.0
    assert peft.LORA_TARGETS == jax_peft.LORA_TARGETS


# ---------------------------------------------------------------------------
# Logits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ["dense", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_peft_logits_match_jax(arch, quant):
    """``lora_logits`` and ``houlsby_logits`` against the reference's, B
    and ``up`` non-zero, on a dense and an int8-quantized backbone (the
    block dequantized first on both sides): 1e-4, the logits tolerance of
    tests/test_torch_families.py, or on xlstm eight times the reference's
    own move under another mLSTM chunking (that module's ``_ref_noise``
    rule)."""
    jcfg, tcfg, backbone = _model(arch)
    if quant == "int8":
        backbone = jax.jit(functools.partial(jax_quantize_tree, bits=8))(backbone)
    jb, tb = _batch(jcfg)
    tbp = bridge.to_torch(_np(backbone))
    lora, houlsby = _peft_params(arch)

    def wants(cfg):
        return jax.jit(lambda bp, lp, hp: (jax_peft.lora_logits(bp, lp, cfg, jb),
                                           jax_peft.houlsby_logits(bp, hp, cfg, jb)))(
            backbone, lora, houlsby)

    want_pair = wants(jcfg)
    noise = [0.0, 0.0]
    if any(s.kind == "mlstm" for s in jcfg.pattern):
        for div in (2, 4):
            twin = wants(dataclasses.replace(jcfg, mlstm_chunk=jcfg.mlstm_chunk // div))
            noise = [max(n, float(jnp.max(jnp.abs(a - b)))) for n, a, b in
                     zip(noise, want_pair, twin)]
    for want, n, tfn, params in zip(want_pair, noise, (peft.lora_logits, peft.houlsby_logits),
                                    (lora, houlsby)):
        got = tfn(tbp, bridge.to_torch(_np(params)), tcfg, tb).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=max(1e-4, 8 * n), rtol=1e-4)


def test_exact_erf_gelu_would_fail_houlsby(monkeypatch):
    """The reference's ``jax.nn.gelu`` is the tanh approximation; PyTorch's
    default gelu (exact erf) differs by ~1e-3, which the Houlsby comparison
    above catches."""
    jcfg, tcfg, backbone = _model("internlm2-1.8b")
    jb, tb = _batch(jcfg)
    _, houlsby = _peft_params("internlm2-1.8b")
    want = np.asarray(jax_peft.houlsby_logits(backbone, houlsby, jcfg, jb))
    args = (bridge.to_torch(_np(backbone)), bridge.to_torch(_np(houlsby)), tcfg, tb)
    np.testing.assert_allclose(peft.houlsby_logits(*args).numpy(), want, atol=1e-4, rtol=1e-4)
    gelu = torch.nn.functional.gelu
    monkeypatch.setattr(peft.F, "gelu", lambda x, approximate="none": gelu(x))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(peft.houlsby_logits(*args).numpy(), want, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_identity_start_is_the_backbone(arch):
    """LoRA's B and Houlsby's ``up`` start at zero, so both models' logits
    at init equal ``backbone_logits`` bit for bit (dense and int8)."""
    _, tcfg, backbone = _model(arch)
    _, tb = _batch(tcfg)
    gen = torch.Generator().manual_seed(3)
    lora, houlsby = peft.init_lora(gen, tcfg), peft.init_houlsby(gen, tcfg)
    for tbp in (bridge.to_torch(_np(backbone)),
                quantize_tree(bridge.to_torch(_np(backbone)), bits=8)):
        want = tbb.backbone_logits(tbp, tcfg, tb)
        assert torch.equal(peft.lora_logits(tbp, lora, tcfg, tb), want)
        assert torch.equal(peft.houlsby_logits(tbp, houlsby, tcfg, tb), want)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _jax_loss(technique, backbone, cfg, batch):
    """The reference step's loss as a function of its trained tree."""
    logits = {"full": lambda p: jbb.backbone_logits(p, cfg, batch),
              "lora": lambda p: jax_peft.lora_logits(backbone, p, cfg, batch),
              "adapters": lambda p: jax_peft.houlsby_logits(backbone, p, cfg, batch)}[technique]
    return lambda p: jbb.cross_entropy(logits(p), batch["labels"])


@pytest.mark.parametrize("arch,technique", [("internlm2-1.8b", "full"),
                                            ("internlm2-1.8b", "lora"),
                                            ("internlm2-1.8b", "adapters"),
                                            ("gemma2-2b", "full"),
                                            ("mixtral-8x7b", "full"),
                                            ("mixtral-8x7b", "lora"),
                                            ("mixtral-8x7b", "adapters"),
                                            ("xlstm-125m", "lora"),
                                            ("xlstm-125m", "adapters"),
                                            ("jamba-1.5-large-398b", "lora"),
                                            ("jamba-1.5-large-398b", "adapters"),
                                            ("qwen2-vl-7b", "full"),
                                            ("qwen2-vl-7b", "lora"),
                                            ("qwen2-vl-7b", "adapters")])
def test_baseline_step_matches_jax(arch, technique):
    """One step of each baseline against the reference's (jitted, with its
    gradients for the update rule): loss 2e-5, the updated tree 5e-5. On
    gemma2-2b (tied head) the embedding's gradient is the reference's
    within 1e-4·max|g|, and it is the sum of the lookup's and the head's
    (full fine-tuning updates both through the one leaf). On mixtral-8x7b
    reduced (MoE, capacity factor E: no token drops) the gradient runs
    through the router and the experts, as ``jax.grad``'s does."""
    jcfg, tcfg, backbone = _model(arch)
    jb, tb = _batch(jcfg, seq=16)
    tbp = bridge.to_torch(_np(backbone))
    lora, houlsby = _peft_params(arch)
    jtree, lr = {"full": (backbone, 1e-4), "lora": (lora, 1e-3),
                 "adapters": (houlsby, 1e-3)}[technique]
    ttree = tbp if technique == "full" else bridge.to_torch(_np(jtree))
    jstep = {"full": lambda t, o: jax_steps.full_train_step(t, o, jb, cfg=jcfg),
             "lora": lambda t, o: jax_steps.lora_train_step(backbone, t, o, jb, cfg=jcfg),
             "adapters": lambda t, o: jax_steps.houlsby_train_step(backbone, t, o, jb,
                                                                   cfg=jcfg)}[technique]
    tstep = {"full": lambda t, o: steps.full_train_step(t, o, tb, cfg=tcfg),
             "lora": lambda t, o: steps.lora_train_step(tbp, t, o, tb, cfg=tcfg),
             "adapters": lambda t, o: steps.houlsby_train_step(tbp, t, o, tb,
                                                               cfg=tcfg)}[technique]
    jloss = _jax_loss(technique, backbone, jcfg, jb)
    jout, jgrads = jax.jit(lambda t: (jstep(t, jax_adamw_init(t)), jax.grad(jloss)(t)))(jtree)
    tout = tstep(ttree, adamw_init(ttree))
    assert abs(float(tout[0]) - float(jout[0])) < 2e-5
    _assert_update_close(jout[1], tout[1], jgrads, lr=lr)
    assert int(tout[2]["count"]) == 1
    if arch != "gemma2-2b":
        return
    assert tcfg.tie_embeddings and "lm_head" not in tbp

    def embed_grad(lookup: bool, head: bool):
        """The loss's gradient in ``embed`` through the lookup, the head or both."""
        e = tbp["embed"].clone().requires_grad_(True)
        h, _ = tbb.backbone_forward(tbp, tcfg, {"embeds": (e if lookup else e.detach())[
            tb["tokens"].long()]})
        logits = tbb.logits_from_hidden(dict(tbp, embed=e if head else e.detach()), tcfg, h)
        return torch.autograd.grad(tbb.cross_entropy(logits, tb["labels"]), e)[0]

    both = embed_grad(True, True)
    want = np.asarray(jgrads["embed"])
    np.testing.assert_allclose(both.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    parts = embed_grad(True, False), embed_grad(False, True)
    assert all(p.abs().max() > 1e-3 * both.abs().max() for p in parts)
    torch.testing.assert_close(parts[0] + parts[1], both, atol=1e-6, rtol=1e-5)


def test_full_train_step_refuses_a_quantized_backbone():
    _, tcfg, backbone = _model("internlm2-1.8b")
    _, tb = _batch(tcfg, seq=8)
    q = quantize_tree(bridge.to_torch(_np(backbone)), bits=8)
    assert any(isinstance(t, QTensor) for t in tree_leaves(q))
    with pytest.raises(TypeError, match="no gradient"):
        steps.full_train_step(q, None, tb, cfg=tcfg)


def test_full_train_step_never_takes_the_cached_loss_head():
    """Full fine-tuning changes the head every step, so its logits come
    through ``logits_from_hidden``: no head is made and kept for its leaves
    (``loss_head``'s cache gains no entry)."""
    _, tcfg, backbone = _model("gemma2-2b")
    _, tb = _batch(tcfg, seq=8)
    tbp = bridge.to_torch(_np(backbone))
    opt = adamw_init(tbp)
    before = set(tbb._LOSS_HEADS)
    for _ in range(2):
        loss, tbp, opt = steps.full_train_step(tbp, opt, tb, cfg=tcfg)
        assert torch.isfinite(loss)
        assert set(tbb._LOSS_HEADS) <= before


@pytest.mark.parametrize("kind,slice_", [("mamba", "A6.5"), ("mlstm", "A6.5"),
                                         ("slstm", "A6.5"), ("moe", "A6.4")])
def test_non_dense_kinds_name_their_slice(kind, slice_):
    """The non-dense kinds, whose slices (A6.5 SSM, A6.4 MoE) have landed,
    run: on mixtral reduced, and on internlm2 reduced with its pattern
    made of the SSM kind (a backbone drawn for it), both baselines give
    finite logits of the batch's shape."""
    if kind == "moe":
        _, tcfg, backbone = _model("mixtral-8x7b")
        assert all(s.moe for s in tcfg.pattern)
        tbp = bridge.to_torch(_np(backbone))
    else:
        _, tcfg, _ = _model("internlm2-1.8b")
        tcfg = dataclasses.replace(tcfg, pattern=(LayerSpec(kind=kind),))
        tbp = tbb.init_backbone(torch.Generator().manual_seed(1), tcfg)
    _, tb = _batch(tcfg, seq=8)
    gen = torch.Generator().manual_seed(0)
    for got in (peft.lora_logits(tbp, peft.init_lora(gen, tcfg), tcfg, tb),
                peft.houlsby_logits(tbp, peft.init_houlsby(gen, tcfg), tcfg, tb)):
        assert got.shape == (B, 8, tcfg.vocab) and bool(torch.isfinite(got).all())


# ---------------------------------------------------------------------------
# Distillation
# ---------------------------------------------------------------------------


def _calib(cfg, seq=16):
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, cfg.vocab, size=(B, seq)).astype(np.int32) for _ in range(2)]
    return [{"tokens": jnp.asarray(t)} for t in toks], [{"tokens": torch.from_numpy(t)}
                                                       for t in toks]


def _reference_start(key, backbone, cfg, from_pruning):
    """The reference's start, rebuilt as src/repro/core/init_methods.py:211-219
    builds it: the pruned (or random) adapter, ``up`` redrawn from
    ``fold_in(key, 17)``."""
    adapter = (jax_pruning_init(key, backbone, cfg, R) if from_pruning
               else jax_init_adapter(key, cfg, R))
    up = adapter["up"]
    adapter["up"] = (jax.random.normal(jax.random.fold_in(key, 17), up.shape)
                     * up.shape[0] ** -0.5).astype(up.dtype)
    return adapter


@pytest.mark.parametrize("from_pruning", [True, False])
def test_distillation_matches_jax_from_its_start(from_pruning):
    """8 steps over 2 calibration batches from the reference's own start:
    every element of the adapter within 5e-5 of the reference's
    ``distillation_init``, but for a share ≤ 1e-4 of elements, held to 8
    unclipped AdamW steps' reach (8·2·lr): where a gradient passes within
    a few eps of 0, AdamW turns a last-bit difference into a fraction of
    lr (the rule of ``_assert_update_close``, over 8 steps); and the
    per-step loss falls."""
    jcfg, tcfg, backbone = _model("internlm2-1.8b")
    jcal, tcal = _calib(jcfg)
    key = jax.random.PRNGKey(5)
    want = jax_distillation_init(key, backbone, jcfg, jcal, r=R, steps=8,
                                 from_pruning=from_pruning)
    start = bridge.to_torch(_np(_reference_start(key, backbone, jcfg, from_pruning)))
    got, losses = _distill(start, bridge.to_torch(_np(backbone)), tcfg, tcal, r=R, steps=8)
    assert jax.tree.structure(_np(want)) == jax.tree.structure(bridge.to_numpy(got))
    diffs = np.concatenate([np.abs(t - np.asarray(j)).ravel() for j, t in
                            zip(jax.tree.leaves(want), jax.tree.leaves(bridge.to_numpy(got)))])
    assert diffs.max() <= 8 * 2 * 1e-3
    assert (diffs > 5e-5).mean() <= 1e-4, (diffs > 5e-5).sum()
    losses = [float(x) for x in losses]
    assert len(losses) == 8 and all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_distillation_on_ssm_configs_matches_jax(arch):
    """``distillation_init``'s loop on the SSM configs reduced, 4 steps
    from the reference's pruned start: the adapter within the rule of
    ``test_distillation_matches_jax_from_its_start`` (every element within
    4·2·lr, at most 1e-4 of them past 5e-5), and the loss after the last
    step below the first's."""
    jcfg, tcfg, backbone = _model(arch)
    jcal, tcal = _calib(jcfg)
    key = jax.random.PRNGKey(5)
    want = jax_distillation_init(key, backbone, jcfg, jcal, r=R, steps=4)
    start = bridge.to_torch(_np(_reference_start(key, backbone, jcfg, True)))
    got, losses = _distill(start, bridge.to_torch(_np(backbone)), tcfg, tcal, r=R, steps=4)
    assert jax.tree.structure(_np(want)) == jax.tree.structure(bridge.to_numpy(got))
    diffs = np.concatenate([np.abs(t - np.asarray(j)).ravel() for j, t in
                            zip(jax.tree.leaves(want), jax.tree.leaves(bridge.to_numpy(got)))])
    assert diffs.max() <= 4 * 2 * 1e-3
    assert (diffs > 5e-5).mean() <= 1e-4, (diffs > 5e-5).sum()
    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("from_pruning", [True, False])
def test_distillation_on_qwen2_vl_matches_jax(from_pruning):
    """``distillation_init``'s loop on qwen2-vl reduced (mrope: teacher and
    student on (3, B, S) positions), 4 steps from the reference's pruned or
    random start, at the rule of
    ``test_distillation_on_ssm_configs_matches_jax``."""
    jcfg, tcfg, backbone = _model("qwen2-vl-7b")
    jcal, tcal = _calib(jcfg)
    key = jax.random.PRNGKey(5)
    want = jax_distillation_init(key, backbone, jcfg, jcal, r=R, steps=4,
                                 from_pruning=from_pruning)
    start = bridge.to_torch(_np(_reference_start(key, backbone, jcfg, from_pruning)))
    got, losses = _distill(start, bridge.to_torch(_np(backbone)), tcfg, tcal, r=R, steps=4)
    diffs = np.concatenate([np.abs(t - np.asarray(j)).ravel() for j, t in
                            zip(jax.tree.leaves(want), jax.tree.leaves(bridge.to_numpy(got)))])
    assert diffs.max() <= 4 * 2 * 1e-3
    assert (diffs > 5e-5).mean() <= 1e-4, (diffs > 5e-5).sum()
    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_distillation_init_reduces_kl():
    """Twin of tests/test_parallel_adapters.py:124 (random start, 8 steps,
    finite leaves), and the loss of the distilled adapter on the first
    batch below its start's."""
    _, tcfg, backbone = _model("internlm2-1.8b")
    _, tcal = _calib(tcfg, seq=8)
    tbp = bridge.to_torch(_np(backbone))
    ap = distillation_init(torch.Generator().manual_seed(5), tbp, tcfg, tcal, r=R, steps=8,
                           from_pruning=False)
    assert all(torch.isfinite(t).all() for t in tree_leaves(ap))
    start = distillation_init(torch.Generator().manual_seed(5), tbp, tcfg, tcal, r=R, steps=0,
                              from_pruning=False)

    def kl(adapter):  # the loss of one step at lr 0 (the adapter does not move)
        return float(_distill(adapter, tbp, tcfg, tcal[:1], r=R, steps=1, lr=0.0)[1][0])

    assert kl(ap) < kl(start)


class _RefDenseAttention(RefOpSet):
    """The ``ref`` OpSet with the flash kernel's plain version (dense
    softmax attention) in place of ``ref``'s blocked attention, whose f32
    rounding differs from it by design."""

    def attention(self, q, k, v, cfg, spec):
        return CudaOpSet.attention(self, q, k, v, cfg, spec)


def test_distillation_cuda_opset_equals_ref_on_the_cpu():
    """``kernel_impl="cuda"`` on CPU tensors takes the kernels' plain
    versions for the teacher's int8 forward: the same adapter and losses as
    ``"ref"`` (its attention the flash kernel's plain version, which the
    ``cuda`` OpSet takes on the CPU), bit for bit."""
    jcfg, tcfg, backbone = _model("internlm2-1.8b")
    _, tcal = _calib(tcfg)
    tq = quantize_tree(bridge.to_torch(_np(backbone)), bits=8)
    runs = [distillation_init(torch.Generator().manual_seed(5), tq, tcfg, tcal, r=R, steps=3,
                              kernel_impl=impl) for impl in (_RefDenseAttention(), "cuda")]
    for a, b in zip(*(tree_leaves(r) for r in runs)):
        assert torch.equal(a, b)


def test_importing_the_baselines_leaves_jax_unloaded():
    code = ("import sys, repro_torch.core.peft, repro_torch.core.init_methods, "
            "repro_torch.core.steps; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("quant", ["dense", "int8"])
@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_pruning_init_on_ssm_matches_jax(arch, quant):
    """``pruning_init`` on the SSM configs reduced: mLSTM heads and gates,
    sLSTM channels and head blocks, Mamba inner channels (and jamba's MoE
    FFNs from their experts' mean), on the dense and the int8 backbone,
    bit for bit."""
    from test_torch_cached_step import _assert_tree_close

    from repro_torch.core.init_methods import pruning_init

    jcfg, tcfg, backbone = _model(arch)
    if quant == "int8":
        backbone = jax_quantize_tree(backbone, bits=8)
    want = jax_pruning_init(jax.random.PRNGKey(1), backbone, jcfg, r=4)
    got = pruning_init(torch.Generator().manual_seed(1), bridge.to_torch(_np(backbone)), tcfg,
                       r=4)
    _assert_tree_close(want, got, atol=0.0)


@pytest.mark.parametrize("quant", ["dense", "int8"])
def test_pruning_init_on_moe_matches_jax(quant):
    """``pruning_init`` on mixtral reduced: each MoE FFN pruned from its
    experts' mean, one period at a time in the port, the whole stacked
    leaf in the reference; on the dense and the int8 backbone, bit for
    bit."""
    from test_torch_cached_step import _assert_tree_close

    from repro_torch.core.init_methods import pruning_init

    jcfg, tcfg, backbone = _model("mixtral-8x7b")
    if quant == "int8":
        backbone = jax_quantize_tree(backbone, bits=8)
    want = jax_pruning_init(jax.random.PRNGKey(1), backbone, jcfg, r=4)
    got = pruning_init(torch.Generator().manual_seed(1), bridge.to_torch(_np(backbone)), tcfg,
                       r=4)
    _assert_tree_close(want, got, atol=0.0)


@pytest.mark.parametrize("quant", ["dense", "int8"])
def test_pruning_init_on_qwen2_vl_matches_jax(quant):
    """``pruning_init`` on qwen2-vl reduced (4 heads over one kv head),
    on the dense and the int8 backbone, bit for bit."""
    from test_torch_cached_step import _assert_tree_close

    from repro_torch.core.init_methods import pruning_init

    jcfg, tcfg, backbone = _model("qwen2-vl-7b")
    if quant == "int8":
        backbone = jax_quantize_tree(backbone, bits=8)
    want = jax_pruning_init(jax.random.PRNGKey(1), backbone, jcfg, r=4)
    got = pruning_init(torch.Generator().manual_seed(1), bridge.to_torch(_np(backbone)), tcfg,
                       r=4)
    _assert_tree_close(want, got, atol=0.0)
