"""The reference's bf16 backbone through the port, against the JAX package.

The reference holds a bf16 backbone (its f32 draw cast to bf16, every
float leaf) to its ``ref`` OpSet at ``_TOL["bf16"] = 3e-2``
(tests/test_opset.py:35-48, :119). The same cast goes across through
``repro_torch.bridge`` at reduced internlm2-1.8b, and at the reduced
gemma2-2b variant of head width 256 (2 heads of 256 over one kv head,
window 32 on every other layer, both soft-caps, the tied head: built as
tests/test_torch_families.py builds it; ids ``gemma2-hd256-...``), and the
port's ``ref`` and ``cuda`` OpSets (the ``cuda`` kernels' plain versions
on the CPU) are held to the reference's ``pallas`` OpSet in interpret
mode:

* the epoch-1 sweep of tests/test_opset.py:119's bf16 case: loss, adapter
  gradients and taps at 3e-2 (gradients by their scale, taps at 10x by
  theirs, as there);
* a cached step on the epoch-1 activations (bf16 entries) with the bf16
  head kept in bf16: its inputs are exact in both packages and its math
  f32, so it meets the f32 cached step's bounds (loss 2e-5, gradients
  1e-4·max(1, |g|max), tests/test_torch_cached_step.py);
* paged prefill and 3 decode steps over int8, bf16 and f32 KV pages
  (gemma2's prompts past its window):
  logits at 3e-2, or twice the reference's own move between its compiled
  and eager forms where that is larger (0.021-0.031: the same bf16
  roundings placed otherwise, as the port's eager ops place them), equal
  greedy tokens;
* single-user decode over the linear cache against ``pac_decode_step``:
  logits at 3e-2, equal greedy tokens;
* the flash, paged attention and CE kernels' plain versions with bf16
  operands against the Pallas kernels in interpret mode (flash and paged
  attention at head widths 64, 112, 128 and 256);
* the two promotion faults: a bf16 backbone tensor times an f32 adapter
  weight raised in ``adapter_forward`` (epoch-1 ``ref`` step) and in
  ``adapter_prefill`` (every paged prefill); both now promote as JAX does
  and are held to the reference's functions on the same inputs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import parallel_adapters as jpa
from repro.core import steps as jax_steps
from repro.core.opset import get_opset as jax_get_opset
from repro.kernels import cached_step as jax_cs
from repro.kernels.flash_attention import flash_attention_tpu
from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro.models import backbone as jbb
from repro.optim import adamw_init as jax_adamw_init
from repro.serve import paging as jax_paging
from repro.serve.decode import paged_pac_decode_step as jax_decode_step
from repro.serve.decode import paged_prefill as jax_prefill
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import parallel_adapters as tpa
from repro_torch.core import steps
from repro_torch.core.opset import get_opset
from repro_torch.core.quantization import tree_leaves, tree_map
from repro_torch.kernels import ref as kref
from repro_torch.kernels.cached_step import cached_loss_parts
from repro_torch.models import backbone as tbb
from repro_torch.optim import adamw_init
from repro_torch.serve import paging
from repro_torch.serve.decode import paged_pac_decode_step, paged_prefill

torch.set_num_threads(2)
R = 4
#: the reference's bf16 tolerance (tests/test_opset.py:38)
TOL = 3e-2
#: two bf16 roundings of one f32 value a last bit apart differ by at most one
#: bf16 ulp: 2^-7 of the value at most
BF16_RTOL = 2.0 ** -7
#: the port's serving logits may lie this many times the reference's own move
#: between its compiled and eager forms from it (the move of bf16 roundings
#: placed otherwise, which is what the port's eager ops do: C5's FORM_FACTOR)
FORM_FACTOR = 2


INTERNLM2, GEMMA2 = "internlm2-1.8b", "gemma2-2b"


def _by_arch(cases, gemma2_cases=None):
    """pytest params ``(arch, *case)``: internlm2-1.8b's ``cases`` under
    their plain ids, then the gemma2-2b variant's (``cases`` unless given)
    under ids prefixed ``gemma2-hd256``."""
    def pid(case):
        return "-".join(str(x) for x in case)

    out = [pytest.param(INTERNLM2, *c, id=pid(c)) for c in cases]
    return out + [pytest.param(GEMMA2, *c, id="gemma2-hd256-" + pid(c))
                  for c in (cases if gemma2_cases is None else gemma2_cases)]


def _cfg(get, arch):
    """``arch`` reduced; gemma2-2b with 2 heads of 256 over one kv head
    (``reduced()`` sets hd = d / n_heads = 64), as
    tests/test_torch_families.py's ``_wide`` builds it."""
    if arch == GEMMA2:
        return dataclasses.replace(get(GEMMA2).reduced(), n_heads=2, n_kv_heads=1, head_dim=256)
    return get(arch).reduced()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _model(arch=INTERNLM2):
    """(jax cfg, port cfg, the bf16 backbone (the reference's cast of its
    f32 draw), the f32 adapter), as tests/test_opset.py draws them."""
    jcfg, tcfg = _cfg(jax_get_arch, arch), _cfg(get_arch, arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    bp = jbb.init_backbone(jax.random.PRNGKey(0), jcfg)
    bp = jax.tree.map(lambda t: t.astype(jnp.bfloat16) if t.dtype == jnp.float32 else t, bp)
    ap = jpa.init_adapter(jax.random.PRNGKey(1), jcfg, r=R)
    return jcfg, tcfg, bp, ap


def _port(tree):
    return bridge.to_torch(_np(tree))


def _batch(cfg, B, S, seed):
    """The same seeded batch for both packages: (jax, torch)."""
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
         for k in ("tokens", "labels")}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def test_the_port_draws_and_bridges_the_bf16_backbone():
    """``init_backbone(dtype=torch.bfloat16)`` draws as the reference draws
    a bf16 tree (each leaf drawn in f32, then cast): every float leaf bf16;
    the bridged reference cast keeps its bits."""
    jcfg, tcfg, bp, _ = _model()
    own = tbb.init_backbone(torch.Generator().manual_seed(0), tcfg, dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(own))
    bridged = _port(bp)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(bridged))
    np.testing.assert_array_equal(_f32(bridged["embed"]), _f32(bp["embed"]))
    assert tbb.loss_head(bridged, tcfg).dtype == torch.bfloat16  # no f32 copy of the head


# ---------------------------------------------------------------------------
# Epoch 1: tests/test_opset.py:119's bf16 case
# ---------------------------------------------------------------------------


def _jax_pallas_loss(ap, bp, cfg, batch):
    """tests/test_opset.py's ``_pallas_loss``: the pallas epoch-1 loss as
    ``pac_train_step(kernel_impl="pallas")`` builds it (f32 tap policy)."""
    ops = jax_get_opset("pallas", "f32", True)
    b_final, taps, x, positions = jbb.backbone_forward(
        bp, cfg, batch, collect_taps=True, return_inputs=True, ops=ops)
    b0_s, taps, bf_s = jax.lax.stop_gradient((ops.emit_tap(x), taps, ops.emit_tap(b_final)))
    cached = {"b0": b0_s, "taps": taps, "b_final": bf_s, "labels": batch["labels"]}
    num, den = jax_cs.cached_loss_parts(bp, ap, cfg, cached, positions, R, impl="pallas",
                                        interpret=True)
    return num / jnp.maximum(den, 1)


@functools.lru_cache(maxsize=None)
def _jax_epoch1(B, S, arch=INTERNLM2):
    jcfg, _, bp, ap = _model(arch)
    jb, _ = _batch(jcfg, B, S, seed=B * 100 + S)
    loss, grads = jax.value_and_grad(_jax_pallas_loss)(ap, bp, jcfg, jb)
    _, taps = jbb.backbone_forward(bp, jcfg, jb, collect_taps=True,
                                   ops=jax_get_opset("pallas", "f32", True))
    return float(loss), grads, taps


def _port_epoch1(impl, B, S, arch=INTERNLM2):
    """The port's epoch-1 loss, adapter gradients and taps under ``impl``,
    composed as ``steps.pac_train_step`` composes them."""
    jcfg, tcfg, bp, ap = _model(arch)
    _, tb = _batch(jcfg, B, S, seed=B * 100 + S)
    tbp = _port(bp)
    ops = get_opset(impl)
    with torch.no_grad():
        b_final, taps, x, positions = tbb.backbone_forward(tbp, tcfg, tb, collect_taps=True,
                                                           return_inputs=True, ops=ops)
    ta = tree_map(lambda t: t.clone().requires_grad_(), _port(ap))
    if impl == "ref":
        loss = tbb.cross_entropy(tpa.pac_logits(tbp, ta, tcfg, x, taps, b_final, positions, R),
                                 tb["labels"])
    else:
        cached = {"b0": ops.emit_tap(x), "taps": taps, "b_final": ops.emit_tap(b_final),
                  "labels": tb["labels"]}
        num, den = cached_loss_parts(tbp, ta, tcfg, cached, positions, R, impl=impl)
        loss = num / den.clamp_min(1)
    grads = torch.autograd.grad(loss, tree_leaves(ta))
    it = iter(grads)
    return float(loss.detach()), tree_map(lambda _: next(it), ta), taps


@pytest.mark.parametrize("arch,B,S,impl", _by_arch(
    [(B, S, impl) for B, S in ((1, 5), (2, 17), (3, 33)) for impl in ("ref", "cuda")],
    [(2, 40, impl) for impl in ("ref", "cuda")]))
def test_epoch1_bf16_backbone_matches_pallas(arch, B, S, impl):
    """Loss within 3e-2, each adapter gradient within 3e-2 of its scale,
    the taps within 10x that of theirs (tests/test_opset.py:119-148), at
    ragged (B, S) as the reference's sweep draws them; gemma2's at S 40,
    past its window of 32."""
    want_loss, want_grads, want_taps = _jax_epoch1(B, S, arch)
    loss, grads, taps = _port_epoch1(impl, B, S, arch)
    assert abs(loss - want_loss) < TOL, (loss, want_loss)
    for a, b in zip(jax.tree.leaves(want_grads), tree_leaves(grads)):
        a, b = _f32(a), _f32(b)
        scale = max(float(np.abs(a).max()), 1e-3)
        assert float(np.abs(a - b).max()) < TOL * max(scale, 1.0)
    want_taps = _f32(want_taps)
    assert taps.dtype == torch.bfloat16
    ref_mag = max(float(np.abs(want_taps).max()), 1.0)
    assert float(np.abs(want_taps - _f32(taps)).max()) < TOL * 10 * ref_mag


def test_epoch1_step_runs_under_both_opsets():
    """The step itself (the first promotion fault raised here under
    ``ref``): ``pac_train_step`` under ``ref`` and ``cuda`` within 3e-2 of
    the reference's ``pallas`` step, the activations in bf16."""
    jcfg, tcfg, bp, ap = _model()
    jb, tb = _batch(jcfg, 2, 12, seed=5)
    want = jax_steps.pac_train_step(bp, ap, jax_adamw_init(ap), jb, cfg=jcfg, r=R,
                                    kernel_impl="pallas", interpret=True)
    tap = _port(ap)
    for impl in ("ref", "cuda"):
        got = steps.pac_train_step(_port(bp), tap, adamw_init(tap), tb, cfg=tcfg, r=R,
                                   kernel_impl=impl)
        assert abs(float(got[0]) - float(want[0])) < TOL, impl
        assert all(t.dtype == torch.bfloat16 for t in got[3]), impl


# ---------------------------------------------------------------------------
# The cached step with a bf16 head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,impl", _by_arch([("ref",), ("cuda",)]))
def test_cached_step_with_a_bf16_head_matches_pallas(arch, impl):
    """The reference's epoch-1 activations (bf16 entries) as the cached
    batch, the head bf16 in both packages (gemma2's tied head: the
    embedding's bf16 transpose, with the final soft-cap 30): loss within
    2e-5 and gradients within 1e-4·max(1, |g|max) of the reference's
    ``pallas`` cached loss (interpret). The port's ``cuda`` head reaches its
    CE kernel in bf16."""
    jcfg, tcfg, bp, ap = _model(arch)
    S = 40 if arch == GEMMA2 else 12  # gemma2's past its window
    jb, tb = _batch(jcfg, 2, S, seed=7)
    (_, _, _, (b0, taps, bf)) = jax_steps.pac_train_step(bp, ap, jax_adamw_init(ap), jb,
                                                         cfg=jcfg, r=R)
    assert b0.dtype == taps.dtype == bf.dtype == jnp.bfloat16
    jc = {"b0": b0, "taps": taps, "b_final": bf, "labels": jb["labels"]}
    jpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (2, S))

    def jloss(a):
        num, den = jax_cs.cached_loss_parts(bp, a, jcfg, jc, jpos, R, impl="pallas",
                                            interpret=True)
        return num / jnp.maximum(den, 1)

    want, jgrads = jax.value_and_grad(jloss)(ap)
    tbp = _port(bp)
    assert tbb.loss_head(tbp, tcfg).dtype == torch.bfloat16
    tc = {"b0": _port(b0), "taps": _port(taps), "b_final": _port(bf), "labels": tb["labels"]}
    ta = tree_map(lambda t: t.clone().requires_grad_(), _port(ap))
    num, den = cached_loss_parts(tbp, ta, tcfg, tc, torch.arange(S).expand(2, S), R,
                                 impl=impl)
    loss = num / den.clamp_min(1)
    grads = torch.autograd.grad(loss, tree_leaves(ta))
    assert abs(float(loss.detach()) - float(want)) < 2e-5
    gmax = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jgrads))
    for a, b in zip(jax.tree.leaves(jgrads), grads):
        np.testing.assert_allclose(_f32(b), _f32(a), atol=1e-4 * max(1.0, gmax), rtol=0)
    tap = _port(ap)
    loss, _, _ = steps.pac_cached_train_step(tbp, tap, adamw_init(tap), tc, cfg=tcfg, r=R,
                                             kernel_impl=impl)
    assert abs(float(loss) - float(want)) < 2e-5


# ---------------------------------------------------------------------------
# Serving: paged prefill and decode over int8, bf16 and f32 pages
# ---------------------------------------------------------------------------

#: each model's prompts, page size and max_len: gemma2's past its window of 32, as
#: tests/test_torch_families.py serves its hd-256 variant
SERVING = {INTERNLM2: ([[5, 7, 11, 2, 9], [3, 1], [8, 8, 4, 6]], 4, 16),
           GEMMA2: ([list(range(3, 53)), [7, 1, 4], list(range(100, 137))], 8, 96)}
N_STEPS = 3


@functools.lru_cache(maxsize=None)
def _bank(arch=INTERNLM2):
    jcfg, _, _, ap = _model(arch)
    bank = jpa.stack_adapters([ap, jpa.init_adapter(jax.random.PRNGKey(2), jcfg, r=R)])
    return jpa.gather_adapters(bank, jnp.arange(len(SERVING[arch][0])) % 2)


def _serve(arch, run):
    """``arch``'s prompts' paged prefill, then ``N_STEPS`` greedy decode
    steps, through ``run(kind, ...)`` on fresh pools: the last-token
    logits of each step."""
    prompts, page, max_len = SERVING[arch]
    max_pages = max_len // page
    table = paging.PageTable(paging.PageAllocator(len(prompts) * max_pages + 1), page, max_pages)
    for i, p in enumerate(prompts):
        table.open(i, len(p))
    toks = np.zeros((len(prompts), max(map(len, prompts))), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    bt, lengths = table.dense(range(len(prompts)))
    state = run("init", table.allocator.n_pages)
    logits, state = run("prefill", state, toks, lengths, bt)
    outs = [logits]
    for _ in range(N_STEPS):
        tok = np.argmax(outs[-1], axis=-1).astype(np.int32)[:, None]
        for i in range(len(prompts)):
            table.extend_to(i, table.length(i) + 1)
        bt, lengths = table.dense(range(len(prompts)))
        logits, state = run("decode", state, tok, lengths, bt)
        outs.append(logits)
        for i in range(len(prompts)):
            table.append_token(i)
    return outs


@functools.lru_cache(maxsize=None)
def _jax_serve(arch, policy, impl="pallas", eager=False):
    """The reference's per-step logits under ``impl``, compiled as it runs,
    or ``eager`` (``jax.disable_jit``: every op rounded to bf16 on its own,
    where XLA's fusions keep f32 between ops)."""
    jcfg, _, bp, _ = _model(arch)
    abatch = _bank(arch)
    prompts, page, max_len = SERVING[arch]
    kw = {"interpret": True} if impl == "pallas" else {}

    def run(kind, *a):
        if kind == "init":
            return jax_paging.init_pools(jcfg, a[0], page, len(prompts), policy), None
        (pools, acache), x, lengths, bt = a
        with jax.disable_jit(eager):
            if kind == "prefill":
                lg, pools, acache = jax_prefill(
                    bp, abatch, jnp.asarray(x), jnp.asarray(lengths), pools, jnp.asarray(bt),
                    cfg=jcfg, max_len=max_len, r=R, kernel_impl=impl, **kw)
            else:
                lg, pools, acache = jax_decode_step(
                    bp, abatch, jnp.asarray(x), pools, jnp.asarray(bt), jnp.asarray(lengths),
                    acache, cfg=jcfg, r=R, kernel_impl=impl, **kw)
        return _f32(lg[:, 0]), (pools, acache)

    return _serve(arch, run)


@functools.lru_cache(maxsize=None)
def _serve_own_move(arch, policy) -> float:
    """The reference's own move of its serving logits over ``policy`` pages
    between its compiled and eager forms (``ref`` OpSet, whose logits equal
    ``pallas``'s here), the largest over the steps: 0.030 over int8 pages,
    0.031 over bf16 and f32 ones, past 3e-2 itself."""
    return max(float(np.abs(a - b).max())
               for a, b in zip(_jax_serve(arch, policy, "ref"),
                               _jax_serve(arch, policy, "ref", True)))


@pytest.mark.parametrize("arch,policy,impl", _by_arch(
    [(policy, impl) for policy in ("int8", "bf16", "f32") for impl in ("ref", "cuda")]))
def test_paged_serving_bf16_backbone_matches_pallas(arch, policy, impl):
    """The bf16 backbone served over ``policy`` KV pages (prefill, then 3
    decode steps, a 2-adapter bank, ragged prompts): each step's logits
    within 3e-2 of the reference's ``pallas`` OpSet (interpret), or
    ``FORM_FACTOR`` times the reference's own move where that is larger
    (:func:`_serve_own_move`; the port lies 0.024-0.033 off, the
    reference's two forms 0.021-0.031 apart), and equal greedy tokens.
    gemma2's greedy tokens are held where the reference's top-2 margin
    exceeds that bound, as ``chip_smoke.py``'s ``bf16_logits_gate`` holds
    them: over int8 pages its row 0 meets a near-tie at the third decode
    step (margin 0.0205, under the reference's own move of 0.028 between
    its two forms), where the port, 0.037 off, picks the runner-up.
    ``paged_prefill`` raised here before the repair (the second promotion
    fault, in ``adapter_prefill``)."""
    jcfg, tcfg, bp, _ = _model(arch)
    tbp, ta = _port(bp), _port(_bank(arch))
    _, page, max_len = SERVING[arch]

    def run(kind, *a):
        if kind == "init":
            return paging.init_pools(tcfg, a[0], page, policy, "cpu"), None
        (pools, acache), x, lengths, bt = a
        if kind == "prefill":
            lg, pools, acache = paged_prefill(
                tbp, ta, torch.from_numpy(x), torch.from_numpy(lengths), pools,
                torch.from_numpy(bt), cfg=tcfg, max_len=max_len, r=R, kernel_impl=impl)
            assert all(c["k"].dtype == torch.float32 for c in acache)  # the adapter's own dtype
        else:
            lg, pools, acache = paged_pac_decode_step(
                tbp, ta, torch.from_numpy(x), pools, torch.from_numpy(bt),
                torch.from_numpy(lengths), acache, cfg=tcfg, r=R, kernel_impl=impl)
        assert lg.dtype == torch.float32
        return _f32(lg[:, 0]), (pools, acache)

    tol = max(TOL, FORM_FACTOR * _serve_own_move(arch, policy))
    for want, got in zip(_jax_serve(arch, policy), _serve(arch, run)):
        assert float(np.abs(want - got).max()) < tol
        top2 = np.sort(want, -1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0] > tol) if arch == GEMMA2 else slice(None)
        np.testing.assert_array_equal(np.argmax(got, -1)[decided], np.argmax(want, -1)[decided])


PERSONAL_PROMPT, PERSONAL_STEPS = 6, 10


@functools.lru_cache(maxsize=None)
def _jax_personal(impl="pallas", eager=False, arch=INTERNLM2):
    """The reference's ``pac_decode_step`` over the linear f32 cache (B =
    2): ``PERSONAL_PROMPT`` prompt tokens, then greedy ones, one at a time;
    each step's (logits, token fed next). ``eager``: under
    ``jax.disable_jit`` (every op rounded to bf16 on its own)."""
    jcfg, _, bp, ap = _model(arch)
    B, L = 2, 12
    prompt = np.random.default_rng(11).integers(0, jcfg.vocab, size=(B, PERSONAL_PROMPT))
    cache, acache = jbb.init_cache(jcfg, B, L), jpa.init_adapter_cache(jcfg, B, L, R)
    tok, out = prompt[:, :1].astype(np.int32), []
    kw = {"interpret": True} if impl == "pallas" else {}
    for t in range(PERSONAL_STEPS):
        with jax.disable_jit(eager):
            lg, cache, acache = jax_steps.pac_decode_step(
                bp, ap, {"tokens": jnp.asarray(tok)}, cache, acache, jnp.int32(t), cfg=jcfg,
                r=R, kernel_impl=impl, **kw)
        lg = _f32(lg[:, 0])
        nxt = (prompt[:, t + 1:t + 2] if t + 1 < PERSONAL_PROMPT
               else np.argmax(lg, -1)[:, None]).astype(np.int32)
        out.append((lg, tok, nxt))
        tok = nxt
    return out


@pytest.mark.parametrize("arch,impl", _by_arch([("ref",), ("cuda",)]))
def test_personal_decode_bf16_backbone_matches_pac_decode_step(arch, impl):
    """Single-user decode over the linear f32 cache: a prompt of 6 tokens
    then 4 greedy tokens, one at a time, fed the reference's tokens, against
    its ``pac_decode_step`` (``pallas``, interpret): logits within 3e-2 each
    step, or ``FORM_FACTOR`` times the reference's own move between its
    compiled and eager forms where that is larger (0.020-0.026 a step, so
    0.052: the port lies 0.037 off at the 7th step), and equal greedy
    tokens. Under
    ``cuda`` the λ-mix runs ``adapter_fuse`` on the bf16 taps, its output
    in f32 (JAX's promotion, the reference's f32 mix)."""
    jcfg, tcfg, bp, ap = _model(arch)
    tbp, tap = _port(bp), _port(ap)
    B, L = 2, 12
    own = max(float(np.abs(a[0] - b[0]).max())
              for a, b in zip(_jax_personal("ref", arch=arch),
                              _jax_personal("ref", True, arch)))
    tol = max(TOL, FORM_FACTOR * own)
    tcache, tac = tbb.init_cache(tcfg, B, L), tpa.init_adapter_cache(tcfg, B, L, R)
    for t, (want, tok, nxt) in enumerate(_jax_personal(arch=arch)):
        tl, tcache, tac = steps.pac_decode_step(
            tbp, tap, {"tokens": torch.from_numpy(tok)}, tcache, tac, t, cfg=tcfg, r=R,
            kernel_impl=impl)
        got = _f32(tl[:, 0])
        assert float(np.abs(want - got).max()) < tol, (t, own)
        np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


# ---------------------------------------------------------------------------
# The two promotion faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["adapter_forward", "adapter_prefill"])
def test_bf16_backbone_tensor_meets_the_f32_adapter_in_f32(fn):
    """Regression for the two raises: ``b0 @ downs[0]`` (bf16 @ f32) raised
    ``expected m1 and m2 to have the same dtype`` in ``adapter_forward``
    and ``expected scalar type Float but found BFloat16`` in
    ``adapter_prefill``. Both now promote as JAX does (bf16 with f32 gives
    f32) and keep the carry in its dtype, as the reference's
    ``mixed.astype(a_prev.dtype)``: the side network (and the prefill's
    adapter K/V, f32) within 1e-5 of the reference's function on the same
    bf16 inputs, its math f32 on both sides."""
    jcfg, tcfg, _, ap = _model()
    B, S = 2, 9
    rng = np.random.default_rng(3)
    b0 = jnp.asarray(rng.standard_normal((B, S, jcfg.d_model)), jnp.bfloat16)
    taps = jnp.asarray(rng.standard_normal((jcfg.n_periods, B, S, jcfg.d_model)), jnp.bfloat16)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    tpos = torch.from_numpy(pos.copy())
    if fn == "adapter_forward":
        want = jpa.adapter_forward(ap, jcfg, b0, taps, jnp.asarray(pos), R)
        got = tpa.adapter_forward(_port(ap), tcfg, _port(b0), _port(taps), tpos, R)
        pairs = [(want, got)]
    else:
        want, wc = jpa.adapter_prefill(ap, jcfg, b0, taps, jnp.asarray(pos), 16, R)
        got, gc = tpa.adapter_prefill(_port(ap), tcfg, _port(b0), _port(taps), tpos, 16, R)
        pairs = [(want, got)] + [(w[k], g[k]) for w, g in zip(wc, gc) for k in ("k", "v")]
    for w, g in pairs:
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(_f32(g), _f32(w), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The kernels' plain versions with bf16 operands
# ---------------------------------------------------------------------------


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _by_hd(cases):
    """pytest params ``(hd, *case)`` over the kernels' head widths: hd 128's
    under their plain ids, the others' prefixed ``hd64`` and so on."""
    return [pytest.param(hd, *c, id=("" if hd == 128 else f"hd{hd}-")
                         + "-".join(str(x) for x in c))
            for hd in (64, 112, 128, 256) for c in cases]


@pytest.mark.parametrize("hd,window,cap", _by_hd([(None, None), (16, 30.0)]))
def test_flash_plain_version_takes_bf16_as_the_pallas_kernel(hd, window, cap):
    """q, k, v bf16 (B·H = 4, S = 64, causal) at each head width the bf16
    branch takes on the card: the plain version's O is bf16, as the Pallas
    kernel's (``flash_attention.py:101``), and the two lie one bf16
    rounding apart at most (both sum in f32)."""
    q, k, v = (jnp.asarray(_rand((4, 64, hd), s), jnp.bfloat16) for s in (1, 2, 3))
    want = flash_attention_tpu(q, k, v, causal=True, window=window, attn_softcap=cap,
                               interpret=True)
    got = kref.flash_attention_ref(_port(q), _port(k), _port(v), causal=True, window=window,
                                   attn_softcap=cap)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("hd,pages", _by_hd([("int8",), ("bf16",), ("f32",)]))
def test_paged_plain_version_takes_a_bf16_q_as_the_pallas_kernel(hd, pages):
    """A bf16 q (B = 3, Hkv = 2, n_rep = 2, page 4) at each head width the
    kernel takes a bf16 q at on the card, over int8 (scaled), bf16 and f32
    pages: the output f32, as the Pallas kernel's, within the reference's
    paged tolerance 2e-4 (tests/test_decode_parity.py:36)."""
    B, hkv, n_rep, page, max_pages = 3, 2, 2, 4, 5
    n_pages = B * max_pages + 1
    q = jnp.asarray(_rand((B, hkv, n_rep, hd), 4), jnp.bfloat16)
    kv = [_rand((n_pages, page, hkv, hd), s) for s in (5, 6)]
    scales = {}
    if pages == "int8":
        scales = {n: jnp.asarray(np.abs(_rand((n_pages, page, hkv), s, 0.02)))
                  for n, s in (("k_scale", 7), ("v_scale", 8))}
        kv = [jnp.asarray(np.clip(np.round(x * 40), -127, 127), jnp.int8) for x in kv]
    else:
        kv = [jnp.asarray(x, jnp.bfloat16 if pages == "bf16" else jnp.float32) for x in kv]
    bt = jnp.asarray((np.arange(B * max_pages) + 1).reshape(B, max_pages), jnp.int32)
    lengths = jnp.asarray([3, 17, 9], jnp.int32)
    want = jax_paged_attention(q, *kv, bt, lengths, interpret=True, **scales)
    got = kref.paged_attention_ref(_port(q), *(_port(x) for x in kv), _port(bt), _port(lengths),
                                   **{n: _port(s) for n, s in scales.items()})
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4, rtol=0)


@pytest.mark.parametrize("h_dtype,w_dtype", [("f32", "bf16"), ("bf16", "bf16"),
                                             ("bf16", "f32")])
def test_ce_plain_versions_take_bf16_as_the_pallas_kernels(h_dtype, w_dtype):
    """``ce_fwd``'s and ``ce_bwd``'s plain versions with a bf16 h, W or both
    (T = 37, d = 130, V = 517, soft-cap 30) against ``_ce_fwd_impl`` and
    ``_ce_bwd_impl`` in interpret mode: both cast each tile to f32, so nll
    and lse meet the f32 cached step's 2e-5; ``dh`` in h's dtype (the
    reference's), within 1e-5 of its scale in f32 and one bf16 rounding in
    bf16."""
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    T, d, V = 37, 130, 517
    h = jnp.asarray(_rand((T, d), 9), dt[h_dtype])
    w = jnp.asarray(_rand((d, V), 10, d ** -0.5), dt[w_dtype])
    labels = jnp.asarray(np.random.default_rng(12).integers(0, V, T), jnp.int32)
    g = jnp.asarray(_rand((T,), 13))
    nll, lse = jax_cs._ce_fwd_impl(h, w, labels, 30.0, 128, 512, True)
    dh = jax_cs._ce_bwd_impl(h, w, labels, lse, g, 30.0, 128, 512, True)
    tnll, tlse = kref.ce_fwd_ref(_port(h), _port(w), _port(labels), 30.0)
    tdh = kref.ce_bwd_ref(_port(h), _port(w), _port(labels), tlse, _port(g), 30.0)
    np.testing.assert_allclose(_f32(tnll), _f32(nll), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_f32(tlse), _f32(lse), atol=2e-5, rtol=0)
    assert tdh.dtype == (torch.bfloat16 if h_dtype == "bf16" else torch.float32)
    assert dh.dtype == dt[h_dtype]
    if h_dtype == "bf16":
        np.testing.assert_allclose(_f32(tdh), _f32(dh), rtol=BF16_RTOL, atol=1e-6)
    else:
        np.testing.assert_allclose(_f32(tdh), _f32(dh), atol=1e-5 * float(np.abs(_f32(dh)).max()))
