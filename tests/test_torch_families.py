"""The configs of the port beside internlm2-1.8b (the paper's Table III
models, gemma2-2b, granite-20b, musicgen-large, the four MoE configs:
mixtral-8x7b, moonshot-v1-16b-a3b, grok-1-314b, kimi-k2-1t-a32b, the
SSM family: xlstm-125m and the hybrid jamba-1.5-large-398b, and the
vision-language qwen2-vl-7b with mrope) at ``reduced()`` against the JAX
package (the SSM configs' stepwise serving: tests/test_torch_ssm.py),
and the head widths 256 (gemma2) and 112 (kimi-k2) through the kernels'
plain versions.

For each config the inputs come from numpy with a fixed seed (musicgen
and qwen2-vl, whose frontends are stubs, are fed embeddings,
``{"embeds"}``, as tests/test_backbone_smoke.py feeds musicgen), the
parameters are the JAX tree's carried across with
``repro_torch.bridge``, and the tolerances are the reference's own, the
ones tests/test_torch_cached_step.py and tests/test_torch_serve.py use:
backbone logits, one ``pac_train_step`` (loss, the updated adapter, the
activations), one ``pac_cached_train_step`` over an int8 cache (loss and
gradients, ``cuda`` and ``ref``), and the prefill/decode equivalence of
tests/test_backbone_smoke.py:104-123 on both sides. qwen2-vl runs them on
the default positions (every mrope stream alike), and once more with
distinct t/h/w streams in the batch (:func:`test_mrope_streams_match_jax`).

A reduced MoE config routes with capacity factor E (the reference's
``reduced()``), so no token drops and the two packages' routes agree.

xlstm's mLSTM divides by max(|n·q|, e^-m): where n·q nears that floor a
last-bit change of a sum moves the quotient by many ulps, and 12 such
blocks compound it. The reference's own results move so when only the
order of its f32 sums changes (the mLSTM chunk halved, an equal
function: tests/test_ssm.py:36): its logits by ~8e-4, its taps by
~3e-3, its adapter gradients by ~2e-4 (a gradient that near 0 flips
sign, so its AdamW update by 2·lr), its cached-step gradients by
~1e-4. :func:`_ref_noise` measures that move, and a config with mLSTM
blocks is held to ``NOISE`` (8) times it where that exceeds the
tolerance the others are held to.

``reduced()`` sets hd = d / n_heads = 64, so no reduced config reaches
gemma2's 256 or kimi-k2's 112: a variant of each is built the same way in
both packages (gemma2 with 2 heads of 256 over one kv head; kimi reduced,
an MoE model, with 8 heads of 112 over 2 kv heads), and its
paged prefill and decode (int8 and f32 pages; gemma2's with window and
soft-cap on) and the two attention kernels alone are held against the JAX
Pallas kernels in interpret mode (flash 3e-5, tests/test_kernels.py:105;
paged 2e-4, tests/test_decode_parity.py:36).
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cached_step import _assert_tree_close, _assert_update_close, _cached, _to_port
from test_torch_mrope import _streams

from repro.configs import get_arch as jax_get_arch
from repro.core import steps as jax_steps
from repro.core.parallel_adapters import gather_adapters, init_adapter, stack_adapters
from repro.core.quantization import quantize_tree
from repro.kernels import cached_step as jax_cs
from repro.kernels.flash_attention import flash_attention_tpu
from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro.models import backbone as jbb
from repro.optim import adamw_init as jax_adamw_init
from repro.serve import paging as jax_paging
from repro.serve.decode import paged_pac_decode_step as jax_decode_step
from repro.serve.decode import paged_prefill as jax_prefill
from repro.serve.paging import quantize_kv_pages as jax_quantize_kv_pages
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import steps
from repro_torch.core.quantization import tree_leaves, tree_map
from repro_torch.kernels.cached_step import cached_loss_parts
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import backbone as tbb
from repro_torch.optim import adamw_init
from repro_torch.serve import paging
from repro_torch.serve.decode import paged_pac_decode_step, paged_prefill

torch.set_num_threads(2)
R = 4
ARCHS = ["t5-base-pac", "bart-large-pac", "t5-large-pac", "gemma2-2b", "granite-20b",
         "musicgen-large", "mixtral-8x7b", "moonshot-v1-16b-a3b", "grok-1-314b",
         "kimi-k2-1t-a32b", "xlstm-125m", "jamba-1.5-large-398b", "qwen2-vl-7b"]
#: a tolerance's multiple of the reference's own f32 move (_ref_noise): the
#: twins reorder the mLSTM's sums only, the port every op's
NOISE = 8
B, S = 2, 40  # S > gemma2's reduced window (32): its local layers mask


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=0, seq=S):
    """The same seeded batch for both packages: (jax, torch)."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, size=(B, seq)).astype(np.int32)}
    if cfg.frontend is not None:  # musicgen, qwen2-vl: the stub frontend's embeddings
        batch["embeds"] = (rng.standard_normal((B, seq, cfg.d_model)) * 0.3).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, size=(B, seq)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(the JAX reduced config, the port's, backbone, adapter), the JAX
    trees drawn once per config."""
    jcfg, tcfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    backbone = jbb.init_backbone(jax.random.PRNGKey(0), jcfg)
    adapter = init_adapter(jax.random.PRNGKey(1), jcfg, r=R)
    return jcfg, tcfg, backbone, adapter


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """The reference's epoch-1 step and its adapter gradients."""
    jcfg, _, backbone, adapter = _model(arch)
    jb, _ = _batch(jcfg)
    out = jax_steps.pac_train_step(backbone, adapter, jax_adamw_init(adapter), jb, cfg=jcfg, r=R)
    grads = jax.grad(lambda a: jax_steps.pac_loss_fn(a, backbone, jcfg, jb, R))(adapter)
    return out, grads


MAPS_CLEAR_AT = 30000  # of the kernel's default vm.max_map_count, 65530


@pytest.fixture(autouse=True)
def _programs_released():
    """The compiled JAX programs dropped after a test once the process
    holds ``MAPS_CLEAR_AT`` memory maps. Each XLA:CPU executable holds a
    few, and this module, run in one process, compiles more than
    ``vm.max_map_count`` allows: past it the next compile, load or run
    aborts the process."""
    yield
    maps = Path("/proc/self/maps")
    if maps.exists() and len(maps.read_bytes().splitlines()) > MAPS_CLEAR_AT:
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _first_config_drawn():
    """The first config's trees drawn and its JAX logits computed before
    any test of the module runs, so that no test depends on being the one
    that draws and compiles first; after the module, its compiled JAX
    programs dropped, so that the next module in the process starts with
    few memory maps (``_programs_released``)."""
    jcfg, _, backbone, _ = _model(ARCHS[0])
    jbb.backbone_logits(backbone, jcfg, _batch(jcfg)[0])
    yield
    jax.clear_caches()


def _positions(cfg):
    """The implicit positions of a (B, S) batch: (B, S), or (3, B, S)
    under mrope; (jax, torch)."""
    lead = (3,) if cfg.rope == "mrope" else ()
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), lead + (B, S))
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


def _max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@functools.lru_cache(maxsize=None)
def _ref_noise(arch) -> dict:
    """How far the reference's own logits, epoch-1 loss, taps, adapter
    gradients and cached-step gradients move, at most, when its mLSTM
    chunk is cut to a half or a quarter (the same function, its f32 sums
    in other orders); all 0 without mLSTM blocks. At xlstm-125m reduced the
    loss moves 3.8e-6 and 1.1e-5 (the port's loss lies 2.3e-5 from the
    reference's, past the fixed 2e-5 and within ``NOISE`` times this move)."""
    jcfg, _, backbone, adapter = _model(arch)
    noise = dict(logits=0.0, loss=0.0, acts=0.0, grads=0.0, cached_grads=0.0)
    if not any(s.kind == "mlstm" for s in jcfg.pattern):
        return noise
    jb, _ = _batch(jcfg)
    (_, _, _, acts), grads = _jax_step(arch)
    jcj = jax.tree.map(jnp.asarray, _cached("int8", *acts, jb["labels"], True))
    jpos = _positions(jcfg)[0]

    def cached_grads(cfg):
        def loss(a):
            num, den = jax_cs.cached_loss_parts(backbone, a, cfg, jcj, jpos, R, impl="ref")
            return num / jnp.maximum(den, 1)
        return jax.grad(loss)(adapter)

    logits, c_grads = jbb.backbone_logits(backbone, jcfg, jb), cached_grads(jcfg)
    loss = _jax_step(arch)[0][0]
    for div in (2, 4):
        twin = dataclasses.replace(jcfg, mlstm_chunk=jcfg.mlstm_chunk // div)
        t_loss, _, _, t_acts = jax_steps.pac_train_step(backbone, adapter,
                                                        jax_adamw_init(adapter), jb, cfg=twin,
                                                        r=R)
        t_grads = jax.grad(lambda a: jax_steps.pac_loss_fn(a, backbone, twin, jb, R))(adapter)
        moved = dict(logits=_max_diff(logits, jbb.backbone_logits(backbone, twin, jb)),
                     loss=abs(float(loss) - float(t_loss)),
                     acts=_max_diff(acts, t_acts), grads=_max_diff(grads, t_grads),
                     cached_grads=_max_diff(c_grads, cached_grads(twin)))
        noise = {k: max(v, moved[k]) for k, v in noise.items()}
    return noise


@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_logits_match_jax(arch):
    """1e-4, or ``NOISE`` times the reference's own move (:func:`_ref_noise`)."""
    jcfg, tcfg, backbone, _ = _model(arch)
    jb, tb = _batch(jcfg)
    want = np.asarray(jbb.backbone_logits(backbone, jcfg, jb))
    got = tbb.backbone_logits(bridge.to_torch(_np(backbone)), tcfg, tb).numpy()
    atol = max(1e-4, NOISE * _ref_noise(arch)["logits"])
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)


@pytest.mark.parametrize("kernel_impl", ["ref", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_pac_train_step_matches_jax(arch, kernel_impl):
    """One epoch-1 step (f32 backbone, f32 taps): the loss within 2e-5, the
    updated adapter within 5e-5 (the clipped-gradient rule of
    ``_assert_update_close``), the activations within 1e-4; where the
    reference's own move (:func:`_ref_noise`) is larger, ``NOISE`` times
    it (xlstm's loss: its own move 1.1e-5, so 9.2e-5, against which the
    port's loss lies 2.3e-5 off), and the update of an element whose
    gradient lies within ``NOISE`` times the gradients' move of 0 within
    one step's reach."""
    jcfg, tcfg, backbone, adapter = _model(arch)
    (loss, ap, _, acts), jgrads = _jax_step(arch)
    noise = _ref_noise(arch)
    _, tb = _batch(jcfg)
    tap = bridge.to_torch(_np(adapter))
    got = steps.pac_train_step(bridge.to_torch(_np(backbone)), tap, adamw_init(tap), tb,
                               cfg=tcfg, r=R, kernel_impl=kernel_impl)
    assert abs(float(got[0]) - float(loss)) < max(2e-5, NOISE * noise["loss"])
    _assert_update_close(ap, got[1], jgrads, flip=max(1e-6, NOISE * noise["grads"]))
    for g, w in zip(got[3], acts):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=max(1e-4, NOISE * noise["acts"]),
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_pac_cached_train_step_int8_matches_jax(arch):
    """The epoch-1 activations in an int8 cache, then one cached step under
    ``cuda`` and ``ref`` against JAX ``kernel_impl="ref"`` on the same
    entries: loss 2e-5, gradients 1e-4·max(1, |g|max), the update 5e-5
    (or ``NOISE`` times the reference's own move, :func:`_ref_noise`,
    where that is larger, as in :func:`test_pac_train_step_matches_jax`)."""
    jcfg, tcfg, backbone, adapter = _model(arch)
    (_, _, _, (b0, taps, bf)), _ = _jax_step(arch)
    jb, _ = _batch(jcfg)
    jc = _cached("int8", b0, taps, bf, jb["labels"], True)
    tc = _to_port(jc, jcfg.d_model)
    jcj = jax.tree.map(jnp.asarray, jc)
    opt = jax_adamw_init(adapter)
    jloss, jap, _ = jax_steps.pac_cached_train_step(backbone, adapter, opt, jcj, cfg=jcfg, r=R,
                                                    kernel_impl="ref")
    jpos, tpos = _positions(jcfg)

    def jloss_fn(a):
        num, den = jax_cs.cached_loss_parts(backbone, a, jcfg, jcj, jpos, R, impl="ref")
        return num / jnp.maximum(den, 1)

    jgrads = jax.grad(jloss_fn)(adapter)
    gmax = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jgrads))
    noise = _ref_noise(arch)["cached_grads"]
    tbp, tap = bridge.to_torch(_np(backbone)), bridge.to_torch(_np(adapter))
    for impl in ("cuda", "ref"):
        loss, ap, _ = steps.pac_cached_train_step(tbp, tap, adamw_init(tap), tc, cfg=tcfg, r=R,
                                                  kernel_impl=impl)
        assert abs(float(loss) - float(jloss)) < 2e-5, impl
        _assert_update_close(jap, ap, jgrads, flip=max(1e-6, NOISE * noise))
        ta = tree_map(lambda t: t.clone().requires_grad_(), tap)
        num, den = cached_loss_parts(tbp, ta, tcfg, tc, tpos, R, impl=impl)
        grads = torch.autograd.grad(num / den.clamp_min(1), tree_leaves(ta))
        it = iter(grads)
        _assert_tree_close(jgrads, tree_map(lambda _: next(it), ta),
                           atol=max(1e-4 * max(1.0, gmax), NOISE * noise))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_equivalence_on_both_sides(arch):
    """tests/test_backbone_smoke.py:104-123 on both sides: S = 10 tokens
    (or frames) decoded one at a time against the linear cache give the
    full forward's logits within 2e-3 of their scale, in each package;
    and the port's ``prefill_step`` and ``decode_step`` logits equal the
    reference's within 1e-4, the decode's within ``NOISE`` times the
    reference's own move where that is larger: with mLSTM blocks, its
    decode against its own full forward at its mLSTM chunk, a half and a
    quarter of it (xlstm-125m: 3.2e-5, 3.2e-5, 4.5e-5, so 3.6e-4; the
    port's decode lies 1.2e-4 from the reference's on 1 of 10240 values)."""
    jcfg, tcfg, backbone, _ = _model(arch)
    seq = 10
    jb, tb = _batch(jcfg, seed=3, seq=seq)
    key = "embeds" if "embeds" in jb else "tokens"
    tbp = bridge.to_torch(_np(backbone))
    h, _ = jbb.backbone_forward(backbone, jcfg, jb)
    jfull = np.asarray(jbb.logits_from_hidden(backbone, jcfg, h))
    tfull = tbb.logits_from_hidden(tbp, tcfg, tbb.backbone_forward(tbp, tcfg, tb)[0]).numpy()
    jcache, tcache = jbb.init_cache(jcfg, B, seq), tbb.init_cache(tcfg, B, seq)
    jdec, tdec = [], []
    for t in range(seq):
        lg, jcache = jax_steps.decode_step(backbone, {key: jb[key][:, t:t + 1]}, jcache,
                                           jnp.int32(t), cfg=jcfg)
        jdec.append(np.asarray(lg))
        lg, tcache = steps.decode_step(tbp, {key: tb[key][:, t:t + 1]}, tcache, t, cfg=tcfg,
                                       kernel_impl="cuda")
        tdec.append(lg.numpy())
    jdec, tdec = np.concatenate(jdec, 1), np.concatenate(tdec, 1)
    for full, dec in ((jfull, jdec), (tfull, tdec)):
        assert np.abs(dec - full).max() / (np.abs(full).max() + 1e-6) < 2e-3
    own = 0.0
    if any(s.kind == "mlstm" for s in jcfg.pattern):
        for div in (1, 2, 4):
            twin = dataclasses.replace(jcfg, mlstm_chunk=jcfg.mlstm_chunk // div)
            full = jbb.logits_from_hidden(backbone, twin, jbb.backbone_forward(backbone, twin, jb)[0])
            own = max(own, float(np.abs(jdec - np.asarray(full)).max()))
    np.testing.assert_allclose(tdec, jdec, atol=max(1e-4, NOISE * own), rtol=1e-4)
    want = np.asarray(jax_steps.prefill_step(backbone, jb, cfg=jcfg))
    got = steps.prefill_step(tbp, tb, cfg=tcfg, kernel_impl="cuda").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_tied_head_loss_equals_the_untied_path():
    """gemma2's tied head: the cached loss and the gradient of its hidden
    state equal those of the same backbone untied, with ``lm_head`` set to
    ``embed``ᵀ (a separate contiguous tensor); the loss head is made once
    for the life of the head's leaf."""
    jcfg, tcfg, backbone, adapter = _model("gemma2-2b")
    (_, _, _, (b0, taps, bf)), _ = _jax_step("gemma2-2b")
    jb, _ = _batch(jcfg)
    tc = _to_port(_cached("int8", b0, taps, bf, jb["labels"], True), jcfg.d_model)
    tied = bridge.to_torch(_np(quantize_tree(backbone, bits=8)))
    untied = dict(tied, lm_head=tbb.head_weight(tied, tcfg).clone())
    ucfg = dataclasses.replace(tcfg, tie_embeddings=False)
    assert tbb.loss_head(tied, tcfg) is tbb.loss_head(tied, tcfg)
    assert tbb.loss_head(tied, tcfg).is_contiguous()
    tpos = torch.arange(S, dtype=torch.int32).expand(B, S)
    out = {}
    for name, (bp, cfg) in {"tied": (tied, tcfg), "untied": (untied, ucfg)}.items():
        ta = tree_map(lambda t: t.clone().requires_grad_(), bridge.to_torch(_np(adapter)))
        num, den = cached_loss_parts(bp, ta, cfg, tc, tpos, R, impl="cuda")
        loss = num / den.clamp_min(1)
        out[name] = (float(loss.detach()), torch.autograd.grad(loss, tree_leaves(ta)))
    assert out["tied"][0] == out["untied"][0]
    for a, b in zip(out["tied"][1], out["untied"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kernel_impl", ["ref", "cuda"])
def test_mrope_streams_match_jax(kernel_impl):
    """qwen2-vl reduced with distinct t/h/w position streams in the batch
    (each row a text prefix, an image grid and text after it): the
    backbone logits within 1e-4; one ``pac_train_step``, loss 2e-5, the
    update 5e-5, the activations 1e-4; the int8 cached step whose cached
    batch carries the same ``positions``, loss 2e-5 and gradients
    1e-4·max(1, |g|max) — the tolerances of the tests above. The logits
    differ from those of the default (equal-stream) positions by far more
    than 1e-4, so the streams reach the attention."""
    arch = "qwen2-vl-7b"
    jcfg, tcfg, backbone, adapter = _model(arch)
    pos = _streams(B, S, seed=11).to(torch.int32)
    jb, tb = _batch(jcfg)
    jb, tb = dict(jb, positions=jnp.asarray(pos.numpy())), dict(tb, positions=pos)
    tbp, tap = bridge.to_torch(_np(backbone)), bridge.to_torch(_np(adapter))
    want = np.asarray(jbb.backbone_logits(backbone, jcfg, jb))
    got = tbb.backbone_logits(tbp, tcfg, tb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    plain = np.asarray(jbb.backbone_logits(backbone, jcfg, _batch(jcfg)[0]))
    assert np.abs(want - plain).max() > 1e-2

    loss, ap, _, acts = jax_steps.pac_train_step(backbone, adapter, jax_adamw_init(adapter), jb,
                                                 cfg=jcfg, r=R)
    jgrads = jax.grad(lambda a: jax_steps.pac_loss_fn(a, backbone, jcfg, jb, R))(adapter)
    out = steps.pac_train_step(tbp, tap, adamw_init(tap), tb, cfg=tcfg, r=R,
                               kernel_impl=kernel_impl)
    assert abs(float(out[0]) - float(loss)) < 2e-5
    _assert_update_close(ap, out[1], jgrads)
    for g, w in zip(out[3], acts):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)

    jc = dict(_cached("int8", *acts, jb["labels"], True), positions=pos.numpy())
    tc = _to_port(jc, jcfg.d_model)
    jcj = jax.tree.map(jnp.asarray, jc)
    jloss, jap, _ = jax_steps.pac_cached_train_step(backbone, adapter, jax_adamw_init(adapter),
                                                    jcj, cfg=jcfg, r=R, kernel_impl="ref")

    def jloss_fn(a):
        num, den = jax_cs.cached_loss_parts(backbone, a, jcfg, jcj, jcj["positions"], R,
                                            impl="ref")
        return num / jnp.maximum(den, 1)

    jgrads = jax.grad(jloss_fn)(adapter)
    gmax = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jgrads))
    closs, cap, _ = steps.pac_cached_train_step(tbp, tap, adamw_init(tap), tc, cfg=tcfg, r=R,
                                                kernel_impl=kernel_impl)
    assert abs(float(closs) - float(jloss)) < 2e-5
    _assert_update_close(jap, cap, jgrads)
    ta = tree_map(lambda t: t.clone().requires_grad_(), tap)
    num, den = cached_loss_parts(tbp, ta, tcfg, tc, tc["positions"], R, impl=kernel_impl)
    grads = torch.autograd.grad(num / den.clamp_min(1), tree_leaves(ta))
    it = iter(grads)
    _assert_tree_close(jgrads, tree_map(lambda _: next(it), ta), atol=1e-4 * max(1.0, gmax))


# ---------------------------------------------------------------------------
# head widths 256 and 112
# ---------------------------------------------------------------------------

PAGE, MAX_LEN, N_STEPS = 8, 96, 3
PROMPTS = [list(range(3, 3 + 50)), [7, 1, 4], list(range(100, 100 + 37))]  # > window 32


def _wide(get, hd):
    """gemma2-2b reduced with 2 heads of 256 over one kv head, or kimi-k2
    reduced (MoE) with 8 heads of 112 over 2 kv heads (one kv head would
    make W_k and W_v 112 wide, under ``quant_matmul``'s 128-wide
    quantization blocks; kimi's own are 8 x 112 = 896)."""
    if hd == 256:
        return dataclasses.replace(get("gemma2-2b").reduced(), n_heads=2, n_kv_heads=1,
                                   head_dim=256)
    return dataclasses.replace(get("kimi-k2-1t-a32b").reduced(), n_heads=8, n_kv_heads=2,
                               head_dim=112)


@functools.lru_cache(maxsize=None)
def _model_wide(hd):
    jcfg, tcfg = _wide(jax_get_arch, hd), _wide(get_arch, hd)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) and tcfg.hd == hd
    backbone = quantize_tree(jbb.init_backbone(jax.random.PRNGKey(5), jcfg), bits=8,
                             min_size=1024)
    bank = stack_adapters([init_adapter(jax.random.PRNGKey(6 + i), jcfg, r=R) for i in range(2)])
    abatch = gather_adapters(bank, jnp.arange(len(PROMPTS)) % 2)
    return jcfg, tcfg, backbone, abatch


def _arr(t) -> np.ndarray:
    return bridge.to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _pool_f32(entry):
    """A pool's K and V as f32 numpy (int8 dequantized), null page dropped."""
    out = []
    for name in ("k", "v"):
        e = entry[name]
        if isinstance(e, dict):
            q, scale = (_arr(e[k]) for k in ("q", "scale"))
            e = q.astype(np.float32) * scale[..., None]
        out.append(_arr(e).astype(np.float32)[:, 1:])
    return out


@functools.lru_cache(maxsize=None)
def _ref_pool_move(hd) -> float:
    """The reference's own move of the prefilled f32 pools of
    :func:`_paged_serving_matches_pallas`'s inputs: the largest K/V
    difference among its ``ref`` and ``pallas`` OpSets, each compiled (as
    the tests run them) and eager (``jax.disable_jit``, the form the port's
    eager ops follow; C5 found rope's the largest such move). At hd 256:
    ref against pallas 4.5e-6, each compiled form 8.9e-6-9.8e-6 from its
    own eager form and up to 1.09e-5 from the other's; the port's pools
    lie 5.9e-6-7.1e-6 from the eager forms, 8.9e-6-1.22e-5 from the
    compiled ones (pallas: 8.9e-6 under ``ref``, 1.02e-5 under ``cuda``)."""
    jcfg, _, backbone, abatch = _model_wide(hd)
    max_pages = MAX_LEN // PAGE
    table = paging.PageTable(paging.PageAllocator(len(PROMPTS) * max_pages + 1), PAGE, max_pages)
    for i, p in enumerate(PROMPTS):
        table.open(i, len(p))
    bt, lengths = table.dense(range(len(PROMPTS)))
    toks = np.zeros((len(PROMPTS), 64), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    pools = []
    for impl in ("ref", "pallas"):
        for eager in (False, True):
            jpools = jax_paging.init_pools(jcfg, table.allocator.n_pages, PAGE, len(PROMPTS), "f32")
            with jax.disable_jit(eager):
                _, jpools, _ = jax_prefill(
                    backbone, abatch, jnp.asarray(toks), jnp.asarray(lengths), jpools,
                    jnp.asarray(bt), cfg=jcfg, max_len=MAX_LEN, r=R, kernel_impl=impl,
                    **({"interpret": True} if impl == "pallas" else {}))
            pools.append([_pool_f32(jp) for jp in jpools])
    return max(float(np.abs(x - y).max()) for i, a in enumerate(pools) for b in pools[i + 1:]
               for pa, pb in zip(a, b) for x, y in zip(pa, pb))


def _paged_serving_matches_pallas(hd, policy, kernel_impl):
    jcfg, tcfg, backbone, abatch = _model_wide(hd)
    tb, ta = bridge.to_torch(_np(backbone)), bridge.to_torch(_np(abatch))
    max_pages = MAX_LEN // PAGE
    table = paging.PageTable(paging.PageAllocator(len(PROMPTS) * max_pages + 1), PAGE, max_pages)
    for i, p in enumerate(PROMPTS):
        table.open(i, len(p))
    n_pages = table.allocator.n_pages
    jpools = jax_paging.init_pools(jcfg, n_pages, PAGE, len(PROMPTS), policy)
    tpools = paging.init_pools(tcfg, n_pages, PAGE, policy, "cpu")
    bt, lengths = table.dense(range(len(PROMPTS)))
    toks = np.zeros((len(PROMPTS), 64), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    jl, jpools, jac = jax_prefill(
        backbone, abatch, jnp.asarray(toks), jnp.asarray(lengths), jpools, jnp.asarray(bt),
        cfg=jcfg, max_len=MAX_LEN, r=R, kernel_impl="pallas", interpret=True)
    tl, tpools, tac = paged_prefill(
        tb, ta, torch.from_numpy(toks), torch.from_numpy(lengths), tpools, torch.from_numpy(bt),
        cfg=tcfg, max_len=MAX_LEN, r=R, kernel_impl=kernel_impl)
    assert np.max(np.abs(np.asarray(jl) - tl.numpy())) < 2e-4
    # an f32 pool within 1e-5, or the reference's own move where that is
    # larger (:func:`_ref_pool_move`)
    pool_tol = 1e-5 if policy == "int8" else max(1e-5, _ref_pool_move(hd))
    for jp, tp in zip(jpools, tpools):
        for want, got in zip(_pool_f32(jp), _pool_f32(tp)):
            atol = pool_tol + (np.abs(want).max() / 127 if policy == "int8" else 0.0)
            np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    tpools, tac = bridge.to_torch(_np(jpools)), bridge.to_torch(_np(jac))
    tok = np.argmax(np.asarray(jl[:, 0]), axis=-1).astype(np.int32)[:, None]
    for _ in range(N_STEPS):
        for i in range(len(PROMPTS)):
            table.extend_to(i, table.length(i) + 1)
        bt, lengths = table.dense(range(len(PROMPTS)))
        jl, jpools, jac = jax_decode_step(
            backbone, abatch, jnp.asarray(tok), jpools, jnp.asarray(bt), jnp.asarray(lengths),
            jac, cfg=jcfg, r=R, kernel_impl="pallas", interpret=True)
        tl, tpools, tac = paged_pac_decode_step(
            tb, ta, torch.from_numpy(tok), tpools, torch.from_numpy(bt),
            torch.from_numpy(lengths), tac, cfg=tcfg, r=R, kernel_impl=kernel_impl)
        want, got = np.asarray(jl[:, 0]), tl[:, 0].numpy()
        assert np.max(np.abs(want - got)) < 2e-4
        np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))
        tok = np.argmax(want, axis=-1).astype(np.int32)[:, None]
        for i in range(len(PROMPTS)):
            table.append_token(i)


@pytest.mark.parametrize("kernel_impl", ["ref", "cuda"])
@pytest.mark.parametrize("policy", ["int8", "f32"])
def test_hd256_paged_serving_matches_pallas(policy, kernel_impl):
    """The hd = 256 variant (window 32 on its local layers, attention
    soft-cap 50, final soft-cap 30; prompts of 50 and 37 tokens cross the
    window) through the JAX ``pallas`` OpSet in interpret mode and the
    port's OpSets (their kernel wrappers take the plain versions here).
    Paged prefill: logits within the reference's paged tolerance, the page
    pools equal once dequantized, an int8 code within one step of its scale
    (a last-ulp K/V difference of the two packages' f32 sums may move it),
    an f32 pool within 1e-5 or the reference's own move
    (:func:`_ref_pool_move`, 1.09e-5 here), whichever is larger.
    Then three decode steps from the reference's prefilled pools and
    adapter caches, as tests/test_decode_parity.py:70 runs its two
    OpSets from one prefill: logits within 2e-4 (both policies) and equal
    greedy tokens at every step."""
    _paged_serving_matches_pallas(256, policy, kernel_impl)


@pytest.mark.parametrize("kernel_impl", ["ref", "cuda"])
@pytest.mark.parametrize("policy", ["int8", "f32"])
def test_hd112_paged_serving_matches_pallas(policy, kernel_impl):
    """The same at kimi-k2's head width 112 on its reduced MoE model (8
    heads over 2 kv heads, n_rep 4): prefill routes the 3 x 64 padded
    tokens, each decode step the 3 new ones at twice the capacity factor,
    through the MoE FFN of both packages."""
    _paged_serving_matches_pallas(112, policy, kernel_impl)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flash_matches_pallas(hd, window, cap):
    q, k, v = _randn((4, 128, hd), 31), _randn((2, 128, hd), 32), _randn((2, 128, hd), 33)
    kr, vr = (np.repeat(t, 2, axis=0) for t in (k, v))
    want = np.asarray(flash_attention_tpu(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
                                          window=window, attn_softcap=cap, bq=64, bk=64,
                                          interpret=True))
    got = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), window=window,
                          attn_softcap=cap).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


@pytest.mark.parametrize("window,cap", [(None, None), (32, 50.0), (None, 30.0)])
def test_hd256_flash_matches_pallas(window, cap):
    """``flash_attention`` alone at hd = 256 (B·H = 4 over 2 kv heads,
    S = 128, causal) against the JAX Pallas kernel in interpret mode, KV
    repeated for it: atol 3e-5."""
    _flash_matches_pallas(256, window, cap)


@pytest.mark.parametrize("window,cap", [(None, None), (32, 50.0), (None, 30.0)])
def test_hd112_flash_matches_pallas(window, cap):
    """The same at hd = 112."""
    _flash_matches_pallas(112, window, cap)


def _paged_attention_matches_pallas(hd, policy):
    rng = np.random.default_rng(9)
    Bq, hkv, n_rep, page, max_pages = 3, 4, 2, 16, 5
    lengths = np.array([0, 40, 75], np.int32)
    n_pages = Bq * max_pages + 1
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    bt = np.zeros((Bq, max_pages), np.int32)
    for b in (1, 2):
        n = -(-(int(lengths[b]) + 1) // page)
        bt[b, :n] = perm[b * max_pages:b * max_pages + n]
    q = _randn((Bq, hkv, n_rep, hd), 41)
    kf, vf = _randn((n_pages, page, hkv, hd), 42), _randn((n_pages, page, hkv, hd), 43)
    kw = dict(window=32, attn_softcap=50.0)
    if policy == "int8":
        (kq, ks), (vq, vs) = (jax_quantize_kv_pages(jnp.asarray(t)) for t in (kf, vf))
        jargs, jscales = (kq, vq), dict(k_scale=ks, v_scale=vs)
        targs = tuple(torch.from_numpy(np.array(t)) for t in (kq, vq))
        tscales = dict(k_scale=torch.from_numpy(np.array(ks)),
                       v_scale=torch.from_numpy(np.array(vs)))
    else:
        jargs = tuple(jnp.asarray(t) for t in (kf, vf))
        targs = tuple(torch.from_numpy(t) for t in (kf, vf))
        if policy == "bf16":
            jargs = tuple(t.astype(jnp.bfloat16) for t in jargs)
            targs = tuple(t.bfloat16() for t in targs)
        jscales, tscales = {}, {}
    want = np.asarray(jax_paged_attention(jnp.asarray(q), *jargs, jnp.asarray(bt),
                                          jnp.asarray(lengths), **jscales, **kw, interpret=True))
    got = paged_attention(torch.from_numpy(q), *targs, torch.from_numpy(bt),
                          torch.from_numpy(lengths), **tscales, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=3e-2 if policy == "bf16" else 2e-4, rtol=0)


@pytest.mark.parametrize("policy", ["int8", "f32", "bf16"])
def test_hd256_paged_attention_matches_pallas(policy):
    """``paged_attention`` alone at hd = 256 (B = 3, Hkv = 4, n_rep = 2,
    pages of 16, lengths 0 (a padding row), 40 and 75), window 32 and
    soft-cap 50, against the JAX Pallas kernel in interpret mode: atol
    2e-4 (bf16 3e-2)."""
    _paged_attention_matches_pallas(256, policy)


@pytest.mark.parametrize("policy", ["int8", "f32", "bf16"])
def test_hd112_paged_attention_matches_pallas(policy):
    """The same at hd = 112."""
    _paged_attention_matches_pallas(112, policy)
