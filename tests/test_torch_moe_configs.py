"""moonshot-v1-16b-a3b's and grok-1-314b's real routing against the JAX
package, and the depth cut the card runs grok at.

``reduced()`` cuts an MoE config to 4 experts at capacity factor E, so
no token drops (tests/test_torch_families.py). Here each config keeps
its published ``MoESpec`` (moonshot 64 experts top-6, grok 8 experts
top-2, capacity factor 1.25) at ``reduced()``'s widths with ``d_expert``
narrowed to reduced's; the same ``dataclasses.replace`` is applied to
both packages' configs. The batch's tokens are Zipf-distributed, as a
text's are: frequent tokens pile onto their experts and the capacity
drops routes in every layer, which the port's route recorder shows.
Against the reference: the backbone logits, the epoch-1 taps and one
int8 ``pac_cached_train_step`` (``cuda`` and ``ref``), at the tolerances
of tests/test_torch_families.py (logits 1e-4, taps 1e-4, loss 2e-5,
gradients 1e-4·max(1, |g|max), the update 5e-5).

The card's serving check compares the ``cuda`` OpSet's routes with
``ref``'s in every layer; routing is discontinuous, and through
moonshot's 48 layers a flipped token's request carries its move on.
:func:`_reference_route_move` measures how far the reference's own
routes move when every MoE layer's router input moves by one f32 ulp
(JAX's ``route`` at the config's experts, top-k, capacity factor and
depth, the smoke's serving batch): where it moves (moonshot), the
smoke gates each layer's own flips, ``ref`` following the ``cuda`` run's
routes, at mixtral's 99.9 %, and the free-running share is printed.

``chip_smoke.py`` runs grok at full width over a depth cut; the cut
keeps every field of the reference's config but ``name`` and
``n_layers``. Neither package's trainer session can plan grok on its
Jetson Nano-H pool at any size (one 4.9 GB INT8 layer is more than a
4 GiB device holds), so the smoke opens its grok sessions with a
single-device layout; a session so opened trains as one that planned.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cached_step import _assert_tree_close, _assert_update_close, _cached, _to_port

from repro.configs import get_arch as jax_get_arch
from repro.core import steps as jax_steps
from repro.core.parallel_adapters import init_adapter
from repro.core.planner import JETSON_NANO_H as JAX_NANO_H
from repro.core.planner import HybridParallelismPlanner as JaxPlanner
from repro.kernels import cached_step as jax_cs
from repro.launch.costs import resolve_cost_model as jax_cost_model
from repro.models import backbone as jbb
from repro.models import moe as jmoe
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.configs import base as config_base
from repro_torch.configs import get_arch
from repro_torch.core import steps
from repro_torch.core.quantization import tree_leaves, tree_map
from repro_torch.kernels.cached_step import cached_loss_parts
from repro_torch.core.opset import get_opset
from repro_torch.models import backbone as tbb
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import _capacity, record_routes
from repro_torch.optim import adamw_init
from repro_torch.runtime import EdgeSession, EpochReport, EpochRunner, RunSpec
from repro_torch.runtime.session import resolve_layout

torch.set_num_threads(2)
R = 4
B, S = 2, 64
ARCHS = ["moonshot-v1-16b-a3b", "grok-1-314b"]
ROOT = Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _routed(cfg):
    """``cfg.reduced()`` with the published routing: E, top-k and the
    capacity factor kept, ``d_expert`` reduced's."""
    red = cfg.reduced()
    return dataclasses.replace(red, name=red.name + "-routed",
                               moe=dataclasses.replace(cfg.moe, d_expert=red.moe.d_expert))


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX config, the port's, the JAX backbone and adapter)."""
    jcfg, tcfg = _routed(jax_get_arch(arch)), _routed(get_arch(arch))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    backbone = jbb.init_backbone(jax.random.PRNGKey(0), jcfg)
    adapter = init_adapter(jax.random.PRNGKey(1), jcfg, r=R)
    return jcfg, tcfg, backbone, adapter


def _batch(cfg, seed=0):
    """Zipf-distributed tokens and labels (the same for both packages)."""
    rng = np.random.default_rng(seed)
    tokens = (np.minimum(rng.zipf(1.3, size=(B, S)), cfg.vocab) - 1).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    jcfg, _, backbone, adapter = _model(arch)
    jb, _ = _batch(jcfg)
    return jax_steps.pac_train_step(backbone, adapter, jax_adamw_init(adapter), jb, cfg=jcfg,
                                    r=R)


@pytest.mark.parametrize("arch", ARCHS)
def test_routed_config_keeps_the_published_routing(arch):
    """E, top-k and capacity factor 1.25 are the published config's, the
    widths reduced's; the capacity cut is below the tokens an expert could
    take, so routes can drop."""
    jcfg, tcfg, _, _ = _model(arch)
    full = get_arch(arch)
    assert (tcfg.moe.n_experts, tcfg.moe.top_k, tcfg.moe.capacity_factor) == (
        full.moe.n_experts, full.moe.top_k, 1.25)
    assert tcfg.moe.d_expert == full.reduced().moe.d_expert
    assert tcfg.d_model == full.reduced().d_model and tcfg.n_layers == full.reduced().n_layers
    assert _capacity(B * S, tcfg.moe) < B * S


@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_logits_match_jax_with_drops(arch):
    """Logits within 1e-4 (rtol 1e-4), and every MoE layer of the port's
    forward drops routes over capacity."""
    jcfg, tcfg, backbone, _ = _model(arch)
    jb, tb = _batch(jcfg)
    want = np.asarray(jbb.backbone_logits(backbone, jcfg, jb))
    with record_routes() as routes:
        got = tbb.backbone_logits(bridge.to_torch(_np(backbone)), tcfg, tb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert len(routes) == tcfg.n_layers
    dropped = [int((~r["kept"]).sum()) for r in routes]
    assert all(n > 0 for n in dropped), dropped


@pytest.mark.parametrize("kernel_impl", ["ref", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_epoch1_step_matches_jax_with_drops(arch, kernel_impl):
    """One epoch-1 step: loss within 2e-5, the taps and final hidden state
    within 1e-4 (rtol 1e-4)."""
    jcfg, tcfg, backbone, adapter = _model(arch)
    loss, _, _, acts = _jax_step(arch)
    _, tb = _batch(jcfg)
    tap = bridge.to_torch(_np(adapter))
    got = steps.pac_train_step(bridge.to_torch(_np(backbone)), tap, adamw_init(tap), tb,
                               cfg=tcfg, r=R, kernel_impl=kernel_impl)
    assert abs(float(got[0]) - float(loss)) < 2e-5
    for g, w in zip(got[3], acts):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_pac_cached_train_step_int8_matches_jax(arch):
    """The reference's epoch-1 activations in an int8 cache, then one
    cached step under ``cuda`` and ``ref`` against JAX ``ref`` on the same
    entries: loss 2e-5, gradients 1e-4·max(1, |g|max), the update 5e-5."""
    jcfg, tcfg, backbone, adapter = _model(arch)
    b0, taps, bf = _jax_step(arch)[3]
    jb, _ = _batch(jcfg)
    jc = _cached("int8", b0, taps, bf, jb["labels"], True)
    tc = _to_port(jc, jcfg.d_model)
    jcj = jax.tree.map(jnp.asarray, jc)
    jloss, jap, _ = jax_steps.pac_cached_train_step(backbone, adapter, jax_adamw_init(adapter),
                                                    jcj, cfg=jcfg, r=R, kernel_impl="ref")
    jpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    tpos = torch.from_numpy(np.asarray(jpos).copy())

    def jloss_fn(a):
        num, den = jax_cs.cached_loss_parts(backbone, a, jcfg, jcj, jpos, R, impl="ref")
        return num / jnp.maximum(den, 1)

    jgrads = jax.grad(jloss_fn)(adapter)
    gmax = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jgrads))
    tbp, tap = bridge.to_torch(_np(backbone)), bridge.to_torch(_np(adapter))
    for impl in ("cuda", "ref"):
        loss, ap, _ = steps.pac_cached_train_step(tbp, tap, adamw_init(tap), tc, cfg=tcfg, r=R,
                                                  kernel_impl=impl)
        assert abs(float(loss) - float(jloss)) < 2e-5, impl
        _assert_update_close(jap, ap, jgrads)
        ta = tree_map(lambda t: t.clone().requires_grad_(), tap)
        num, den = cached_loss_parts(tbp, ta, tcfg, tc, tpos, R, impl=impl)
        grads = torch.autograd.grad(num / den.clamp_min(1), tree_leaves(ta))
        it = iter(grads)
        _assert_tree_close(jgrads, tree_map(lambda _: next(it), ta), atol=1e-4 * max(1.0, gmax))


# ---------------------------------------------------------------------------
# the reference's own route move: the smoke's route bound
# ---------------------------------------------------------------------------

#: sign draws of the one-ulp move (the largest share over them is kept)
MOVE_DRAWS = 4


def _serving_batch(cfg, seed=0):
    """The smoke's serving wave: 8 prompts of 64-480 seeded tokens padded
    to 512 with token 0 (``mixtral_serving_phase``'s draw)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 481, size=8)
    toks = np.zeros((8, 512), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, size=int(n))
    return toks


def _reference_route_move(arch, n_layers):
    """The largest share of tokens, over the MoE layers and ``MOVE_DRAWS``
    draws, that JAX's ``route`` sends otherwise when each layer's router
    input moves by one f32 ulp (each element up or down at random),
    against the unmoved forward: the reference's backbone at ``reduced()``
    width with ``arch``'s experts, top-k and capacity factor, ``n_layers``
    deep, on the smoke's serving batch (T = 4096, padding included, as the
    smoke counts it)."""
    full = jax_get_arch(arch)
    red = full.reduced()
    cfg = dataclasses.replace(red, n_layers=n_layers,
                              moe=dataclasses.replace(full.moe, d_expert=red.moe.d_expert))
    params = jbb.init_backbone(jax.random.PRNGKey(0), cfg)
    x0, pos = jbb.embed_inputs(params, cfg, {"tokens": jnp.asarray(_serving_batch(cfg))})
    route_of = jbb.moe_forward

    def layer(p, x, key, move):
        routes = []

        def moved_moe(pp, h, spec, **kw):
            if move:
                up = jax.random.bernoulli(key, 0.5, h.shape)
                h = jnp.nextafter(h, jnp.where(up, jnp.inf, -jnp.inf).astype(h.dtype))
            routes.append(_jax_route_flags(pp, h, spec))
            return route_of(pp, h, spec, **kw)

        jbb.moe_forward = moved_moe
        try:
            out = jbb.apply_block(p, x, cfg, cfg.pattern[0], pos)
        finally:
            jbb.moe_forward = route_of
        return out, routes[0]

    step = jax.jit(layer, static_argnums=3)

    def run(draw):
        x, out = x0, []
        for i in range(cfg.n_periods):
            p = jax.tree.map(lambda a: a[i], params["blocks"][0])
            x, r = step(p, x, jax.random.PRNGKey(1000 * max(draw, 0) + i), draw >= 0)
            out.append(jax.tree.map(np.asarray, r))
        return out

    base, worst = run(-1), 0.0
    for draw in range(MOVE_DRAWS):
        for (ea, ka), (eb, kb) in zip(base, run(draw)):
            worst = max(worst, float(np.mean(~((ea == eb).all(-1) & (ka == kb).all(-1)))))
    return worst


def _jax_route_flags(p, x, spec):
    """(top_e (T, K), kept (T, K)) of the reference's routing without a
    mesh: the experts each token picked and whether each took it."""
    T = x.shape[0] * x.shape[1]
    C = jmoe._capacity(T, spec)
    probs = jax.nn.softmax(x.reshape(T, -1).astype(jnp.float32) @ p["router"], axis=-1)
    top_p, top_e = jax.lax.top_k(probs, spec.top_k)
    prio = jnp.zeros((T, spec.n_experts), jnp.float32).at[jnp.arange(T)[:, None], top_e].set(top_p)
    gate, idx = jax.lax.top_k(prio.T, C)
    taken = jnp.zeros((spec.n_experts, T + 1), bool).at[
        jnp.arange(spec.n_experts)[:, None], jnp.where(gate > 0.0, idx, T)].set(True)
    return top_e, jnp.take_along_axis(taken[:, :T].T, top_e, axis=1)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "grok-1-314b"])
def test_smoke_route_gates_rest_on_the_reference_move(arch, _smoke_registry):
    """The smoke's ``ROUTE_OWN_MOVE`` entry for ``arch`` is the reference's
    own move under one ulp a layer, at the depth the smoke runs (moonshot's
    48, grok's cut); the free-running route share is gated exactly where
    that move is 0 (grok, and mixtral, which has no entry), and the move
    is small beside the 0.1 % the forced comparison allows a layer."""
    smoke = _smoke()
    name = arch if arch != "grok-1-314b" else smoke.grok_cut().name
    move = _reference_route_move(arch, get_arch(name).n_layers)
    assert smoke.ROUTE_OWN_MOVE.get(arch, 0.0) == move
    assert smoke.route_free_gated(name) == (move == 0.0)
    assert smoke.route_free_gated("mixtral-8x7b")
    assert move < 1.0 - smoke.ROUTE_SHARE_MIN


# ---------------------------------------------------------------------------
# the port's own route move against the reference's (ROADMAP C5)
# ---------------------------------------------------------------------------

#: the port's router-logit move a layer may reach this many times the reference's own
#: move between its compiled and eager forms (its 99.9th percentile and its maximum over
#: the 48 layers): the same f32 ops rounded in another order, as the port's are
FORM_FACTOR = 2
#: f32 ulps each draw below moves a block's output by: ``FORM_FACTOR``, the factor the port
#: is allowed over the reference's own move a layer, applied to the reference's elementary
#: rounding move (one ulp) as the carried move's yardstick (ROADMAP C5). One-ulp draws (64
#: drawn) reach 4 tokens in the worst layer and 12 in all from draw 36 on, where the port's
#: ``ref`` routes 4 and 13: a draw of 1, 2 or 3 ulps moves the router logits 9-10 / 16-20 row
#: ulps a layer (p99.9 / max, printed), the port 16.0 / 35.0-38.0
OWN_MOVE_ULPS = FORM_FACTOR
#: draws of that move, more than ``MOVE_DRAWS``: enough that the worst draw is stable. Over
#: 64 draws of two ulps the worst layer reaches 6 tokens from draw 13 on and 52 in all from
#: draw 4 on
OWN_MOVE_DRAWS = 32


def _row_ulps(got, want):
    """|got - want| in f32 ulps of each row's largest |want| (a token's
    router input or logits): the unit of a rounding move, which an
    element near 0 would blow up."""
    w = np.asarray(want, np.float64).reshape(-1, want.shape[-1])
    g = np.asarray(got, np.float64).reshape(w.shape)
    unit = np.spacing(np.abs(w).max(-1, keepdims=True).astype(np.float32)).astype(np.float64)
    return np.abs(g - w) / unit


def _moved(a, b):
    """Tokens whose experts or kept flags differ between two route records."""
    (ea, ka), (eb, kb) = a, b
    return int((~((ea == eb).all(-1) & (ka == kb).all(-1))).sum())


def _worst(moves) -> np.ndarray:
    """(99.9th percentile, maximum) of row-ulp moves, the largest over layers."""
    return np.max([[np.percentile(u, 99.9), u.max()] for u in moves], axis=0)


@functools.lru_cache(maxsize=None)
def _own_route_moves(arch="moonshot-v1-16b-a3b", n_layers=48):
    """The reference at ``_reference_route_move``'s config, depth and batch
    (reduced widths, the published routing, the smoke's serving batch),
    layer by layer under ``jax.jit`` as it runs: each layer's block input,
    router logits and routes. Then two of its own moves:

    * ``form``: each layer run eagerly on the same block input, its router
      logits against the compiled run's, in row ulps (the 99.9th
      percentile and maximum, the largest over the layers): XLA fuses and
      reorders the same f32 ops (rope's most: its cos and sin fused under
      ``jit``);
    * ``carried``: over ``OWN_MOVE_DRAWS`` draws of random signs, each
      block's output moved by ``OWN_MOVE_ULPS`` f32 ulps, so that the move
      carries forward through the later layers as a forward rounding
      otherwise in every op does, and the tokens each layer then routes
      otherwise;
    * ``draw``: the router-logit move a layer of one such draw, each layer
      fed the compiled run's input moved so (the 99.9th percentile and
      maximum in row ulps, the largest over the layers): the size of the
      drawn move, beside ``form`` and the port's own."""
    full = jax_get_arch(arch)
    red = full.reduced()
    cfg = dataclasses.replace(red, n_layers=n_layers,
                              moe=dataclasses.replace(full.moe, d_expert=red.moe.d_expert))
    params = jbb.init_backbone(jax.random.PRNGKey(0), cfg)
    x0, pos = jbb.embed_inputs(params, cfg, {"tokens": jnp.asarray(_serving_batch(cfg))})
    route_of = jbb.moe_forward

    def layer(p, x, key=None, move=False):
        seen = []

        def recorded(pp, h, spec, **kw):
            logits = h.reshape(-1, h.shape[-1]).astype(jnp.float32) @ pp["router"]
            seen.append((logits, _jax_route_flags(pp, h, spec)))
            return route_of(pp, h, spec, **kw)

        jbb.moe_forward = recorded
        try:
            out = jbb.apply_block(p, x, cfg, cfg.pattern[0], pos)
        finally:
            jbb.moe_forward = route_of
        if move:
            up = jax.random.bernoulli(key, 0.5, out.shape)
            to = jnp.where(up, jnp.inf, -jnp.inf).astype(out.dtype)
            for _ in range(OWN_MOVE_ULPS):
                out = jnp.nextafter(out, to)
        return out, seen[0]

    step = jax.jit(layer, static_argnums=3)

    def run(draw):
        x, xs, seen = x0, [], []
        for i in range(cfg.n_periods):
            p = jax.tree.map(lambda a: a[i], params["blocks"][0])
            xs.append(np.array(x))  # a writable copy, for torch.from_numpy
            x, r = step(p, x, jax.random.PRNGKey(1000 * max(draw, 0) + i), draw >= 0)
            seen.append(jax.tree.map(np.asarray, r))
        return xs, seen

    xs, base = run(-1)
    form = _worst([_row_ulps(np.asarray(layer(jax.tree.map(lambda a: a[i], params["blocks"][0]),
                                              jnp.asarray(x))[1][0]), base[i][0])
                   for i, x in enumerate(xs)])
    carried = np.array([[_moved(r[1], b[1]) for r, b in zip(run(d)[1], base)]
                        for d in range(OWN_MOVE_DRAWS)])
    # a layer's router logits from its compiled input moved as a draw moves
    # the previous block's output (the draw's key of that layer)
    draw = []
    for i, x in enumerate(xs):
        x = jnp.asarray(x)
        up = jax.random.bernoulli(jax.random.PRNGKey(i), 0.5, x.shape)
        to = jnp.where(up, jnp.inf, -jnp.inf).astype(x.dtype)
        for _ in range(OWN_MOVE_ULPS if i else 0):
            x = jnp.nextafter(x, to)
        draw.append(_row_ulps(np.asarray(step(jax.tree.map(lambda a: a[i], params["blocks"][0]), x,
                                              None, False)[1][0]), base[i][0]))
    return {"params": jax.tree.map(np.asarray, params), "pos": np.asarray(pos), "xs": xs,
            "base": base, "form": form, "carried": carried, "draw": _worst(draw)}


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_port_route_move_is_within_the_references_own(impl):
    """ROADMAP C5: does the smoke's forced route gate hide a port fault?
    At moonshot's routing, 48 layers deep on the smoke's serving batch
    (``_own_route_moves``), under the port's ``impl`` OpSet (its kernels'
    plain versions here):

    * a layer's own move: each layer of the port fed the reference's input
      to that layer, its router logits against the reference's in row
      ulps, the 99.9th percentile and the maximum over the layers, within
      ``FORM_FACTOR`` times the reference's own move between its compiled
      and eager forms;
    * the route share: the port run freely through the 48 layers routes
      otherwise, against the reference's compiled forward, no more tokens
      in its worst layer, nor in all, than the reference's own forward
      does in its worst draw under ``OWN_MOVE_ULPS`` ulps a layer on its
      block outputs: a move whose router-logit move a layer (printed) is
      no larger than the port's own. (Under one ulp a layer on the router
      input alone, ``ROUTE_OWN_MOVE``,
      the move does not carry forward, and the reference's worst layer
      moves 1 token of 4096, test_smoke_route_gates_rest_on_the_reference_move.)"""
    own = _own_route_moves()
    tcfg = dataclasses.replace(_routed(get_arch("moonshot-v1-16b-a3b")), n_layers=48)
    ops = get_opset(impl)
    blocks = bridge.to_torch(own["params"])["blocks"]
    pos = torch.from_numpy(own["pos"].copy())
    logits = []
    real = moe_mod.route

    def spy(p, x, spec, *a, **k):
        r = real(p, x, spec, *a, **k)
        logits.append(r["logits"].numpy().reshape(-1, spec.n_experts))
        return r

    moe_mod.route = spy
    try:
        with torch.no_grad():
            for i in range(tcfg.n_periods):  # each layer from the reference's input
                tbb.apply_block(tbb.period_slice(blocks, i)[0], torch.from_numpy(own["xs"][i]),
                                tcfg, tcfg.pattern[0], pos, ops=ops)
            x = torch.from_numpy(own["xs"][0])
            with record_routes() as routes:  # freely through the 48 layers
                for i in range(tcfg.n_periods):
                    x = tbb.apply_block(tbb.period_slice(blocks, i)[0], x, tcfg,
                                        tcfg.pattern[0], pos, ops=ops)
    finally:
        moe_mod.route = real
    move = _worst([_row_ulps(lg, b[0]) for lg, b in zip(logits, own["base"])])
    K = tcfg.moe.top_k
    free = [_moved((r["top_e"].numpy().reshape(-1, K), r["kept"].numpy().reshape(-1, K)), b[1])
            for r, b in zip(routes, own["base"])]
    carried = own["carried"]
    print(f"C5 {impl}: router logits a layer p99.9 {move[0]:.2f}, max {move[1]:.2f} row ulps "
          f"(the reference's compiled against eager: {own['form'][0]:.2f}, "
          f"{own['form'][1]:.2f}; a draw's: {own['draw'][0]:.2f}, {own['draw'][1]:.2f}); tokens "
          f"routed otherwise: worst layer {max(free)}, in all "
          f"{sum(free)} (the reference's own under {OWN_MOVE_ULPS} ulps a layer, worst draw: "
          f"{carried.max()}, {carried.sum(1).max()}; in all by draw {carried.sum(1).tolist()})")
    assert np.all(move <= FORM_FACTOR * own["form"]), (move, own["form"])
    assert max(free) <= carried.max(), (free, carried.max(1))
    assert sum(free) <= carried.sum(1).max(), (free, carried.sum(1))


def test_port_rope_matches_the_references_eager_form():
    """Where a layer's move starts: rope at moonshot's reduced hd 64 over
    the serving batch's 512 positions. The port's matches the reference's
    eager rope within 2 row ulps; the reference's compiled rope (cos and
    sin fused by XLA) moves from its eager one, and the port's lies no
    further from it than that move and the 2 ulps."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    x = np.random.default_rng(0).standard_normal((8, 512, 4, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(512, dtype=np.int32), (8, 512)).copy()
    eager = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    compiled = np.asarray(jax.jit(lambda a, b: jlayers.apply_rope(a, b, 10000.0))(
        jnp.asarray(x), jnp.asarray(pos)))
    port = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy()
    (own, ours, to_compiled) = (_worst([_row_ulps(a, b)]) for a, b in (
        (compiled, eager), (port, eager), (port, compiled)))
    print(f"rope row ulps (p99.9, max): the reference compiled against eager {own}, the port "
          f"against its eager form {ours} and its compiled form {to_compiled}")
    assert ours[1] <= 2 and to_compiled[1] <= own[1] + 2


# ---------------------------------------------------------------------------
# the smoke's grok depth cut, and the planner that cannot place grok
# ---------------------------------------------------------------------------


@pytest.fixture
def _smoke_registry():
    """The configs registry as it was before the test: the cut the smoke
    registers does not outlive it (other tests list the 14 configs)."""
    config_base.list_archs()  # every module's config registered first
    saved = dict(config_base._REGISTRY)
    yield
    config_base._REGISTRY.clear()
    config_base._REGISTRY.update(saved)


def _smoke():
    """``chip_smoke.py`` as a module: its import needs no card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_grok_cut_keeps_the_reference_config(_smoke_registry):
    """The cut differs from the reference's grok-1-314b in ``name`` and
    ``n_layers`` alone; its depth is even, at least 2, a multiple of the
    period and below the published 64; ``RunSpec`` resolves its name."""
    smoke = _smoke()
    cut = smoke.grok_cut()
    ref = jax_get_arch("grok-1-314b")
    got, want = dataclasses.asdict(cut), dataclasses.asdict(ref)
    assert {k for k in want if got[k] != want[k]} == {"name", "n_layers"}
    assert cut.n_layers == smoke.GROK_LAYERS
    assert cut.n_layers >= 2 and cut.n_layers % 2 == 0 and cut.n_layers % cut.period == 0
    assert cut.n_layers < ref.n_layers
    assert (cut.d_model, cut.n_heads, cut.n_kv_heads, cut.moe.d_expert, cut.moe.n_experts,
            cut.moe.top_k, cut.vocab, cut.attn_softcap) == (6144, 48, 8, 32768, 8, 2, 131072, 30.0)
    assert smoke.grok_cut() is cut  # registered once, then looked up
    assert RunSpec(arch=cut.name, quant=8).arch_config() == cut


def test_the_smoke_registers_no_config_on_import(_smoke_registry):
    """Importing the smoke leaves the registry at the 14 configs; only
    :func:`grok_cut` adds its cut."""
    before = sorted(config_base._REGISTRY)
    _smoke()
    assert sorted(config_base._REGISTRY) == before


def _jax_plan(cfg, pool, batch=4, n_micro=4, seq=512):
    """The reference session's offline plan (``repro/runtime/session.py``
    ``_build_plan``) for a single-process INT8 run."""
    cost = jax_cost_model(False, micro_batch=max(1, batch // n_micro), quant_bits=8)
    return JaxPlanner(cost.period_costs(cfg, "pac", seq_len=seq), [JAX_NANO_H] * pool, batch,
                      n_micro).plan(max_stages=None)


@pytest.mark.parametrize("pool", [4, 16, 64])
def test_neither_planner_places_grok_on_a_nano_pool(pool, _smoke_registry):
    """grok at full depth and at the smoke's cut: both packages' offline
    plans refuse ("no feasible plan"), so neither session opens grok by
    itself; moonshot plans on the smoke's pool with the reference's plan."""
    smoke = _smoke()
    for name in ("grok-1-314b", smoke.grok_cut().name):
        spec = RunSpec(arch=name, quant=8, batch=4, seq=512, pool=pool)
        with pytest.raises(RuntimeError, match="no feasible plan"):
            resolve_layout(spec)
        jcfg = jax_get_arch("grok-1-314b")
        if name != "grok-1-314b":
            jcfg = dataclasses.replace(jcfg, name=name, n_layers=smoke.GROK_LAYERS)
        with pytest.raises(RuntimeError, match="no feasible plan"):
            _jax_plan(jcfg, pool)
    lay = resolve_layout(RunSpec(arch="moonshot-v1-16b-a3b", quant=8, batch=4, seq=512,
                                 pool=smoke.MOONSHOT_POOL))
    want = _jax_plan(jax_get_arch("moonshot-v1-16b-a3b"), smoke.MOONSHOT_POOL)
    assert lay.lines[0] == "edge-pool plan: " + want.describe().splitlines()[0]


def test_a_session_on_a_single_device_layout_trains_as_one_that_planned():
    """The smoke's way to open a config no pool plan holds: a session
    given a one-device layout with no plan runs the epochs of one that
    resolved its own layout, loss for loss (reduced grok with its real
    routing, int8 backbone and cache, full then cached)."""
    smoke = _smoke()
    spec = RunSpec(arch="grok-1-314b", reduced=True, quant=8, cache_compress="int8",
                   kernels="cuda", epochs=2, steps_per_epoch=2, batch=2, seq=16, seed=0)
    runs = []
    for layout in (None, smoke.single_device_layout(spec, "test")):
        s = EdgeSession(spec, device="cpu", layout=layout).open()
        runs.append([(e.mode, e.mean_loss) for e in EpochRunner(s).events()
                     if isinstance(e, EpochReport)])
        s.close()
    assert runs[0] == runs[1]
    assert [m for m, _ in runs[0]] == ["full", "cached"]
