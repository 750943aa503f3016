"""The port's MoE (``repro_torch.models.moe``) against the JAX package.

Twins of tests/test_moe.py's eleven tests on the port, then the two
packages side by side on the same numpy inputs and bridged parameters:
the routes (each token's experts, each expert's dispatched tokens and
which of them are kept) equal exactly, the output within 1e-5 and the
aux losses within 1e-6 (or one f32 ulp of the reference's value, where
more), at capacity factors 1.0, 1.25 and E and one or two groups, and
at the published routings (64 experts top-6, 8 top-2) at 1.0 and 1.25;
repeated token rows (exact priority ties at the capacity boundary) keep
the reference's tokens; the gradients to the router and the experts
equal ``jax.grad``'s within 1e-5. Also the route recorder and the replay
of recorded routes, the expert leaves drawn and quantized one period at
a time (the codes of the stacked leaf quantized whole, the router left
f32), and the cuda OpSet's dequantization of an MoE block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _propcheck import given, settings
from _propcheck import strategies as st

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import MoESpec as JaxMoESpec
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.configs.base import LayerSpec, MoESpec
from repro_torch.core.opset import get_opset
from repro_torch.core.quantization import QTensor, dequantize, quantize, quantize_tree
from repro_torch.models import moe
from repro_torch.models.backbone import init_backbone
from repro_torch.models.layers import LeafMaker

torch.set_num_threads(2)


def _spec(E=4, K=2, cf=8.0):
    return MoESpec(n_experts=E, top_k=K, d_expert=32, capacity_factor=cf)


def _params(seed, d, spec):
    return moe.init_moe(LeafMaker(torch.Generator().manual_seed(seed)), d, spec)


def _x(shape, seed, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


# ---------------------------------------------------------------------------
# twins of tests/test_moe.py
# ---------------------------------------------------------------------------


def test_capacity_matches_dense_when_no_drop():
    spec = _spec(cf=8.0)  # capacity >= T: nothing dropped
    p = _params(0, 16, spec)
    x = _x((2, 8, 16), 1)
    torch.testing.assert_close(moe.moe_forward(p, x, spec), moe.moe_forward_dense(p, x, spec),
                               atol=1e-5, rtol=0)


def test_capacity_drops_bounded():
    spec = _spec(cf=1.0)
    p = _params(2, 16, spec)
    _, aux = moe.moe_forward(p, _x((4, 16, 16), 3), spec, return_aux=True)
    assert 0.0 <= float(aux["dropped_frac"]) < 0.7
    assert float(aux["load_balance"]) >= 0.99


def test_aux_losses_finite_and_balanced_router_is_optimal():
    spec = _spec(E=4, K=1, cf=8.0)
    p = dict(_params(4, 16, spec))
    p["router"] = torch.zeros_like(p["router"])  # uniform router: load_balance 1
    _, aux = moe.moe_forward(p, _x((2, 32, 16), 5), spec, return_aux=True)
    assert abs(float(aux["load_balance"]) - 1.0) <= 0.15
    assert all(np.isfinite(float(v)) for v in aux.values())


@settings(max_examples=10, deadline=None)
@given(E=st.sampled_from([2, 4, 8]), K=st.integers(1, 3), seed=st.integers(0, 100))
def test_moe_output_finite_property(E, K, seed):
    K = min(K, E)
    spec = MoESpec(n_experts=E, top_k=K, d_expert=16, capacity_factor=2.0)
    p = _params(seed, 8, spec)
    x = _x((2, 8, 8), seed + 1)
    out = moe.moe_forward(p, x, spec)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_moe_grads_flow_to_router_and_experts():
    spec = _spec()
    p = {k: v.requires_grad_() for k, v in _params(6, 16, spec).items()}
    loss = torch.sum(torch.square(moe.moe_forward(p, _x((2, 8, 16), 7), spec)))
    loss.backward()
    assert float(p["router"].grad.abs().max()) > 0
    assert float(p["wi"].grad.abs().max()) > 0


def test_grouped_routing_matches_global_when_capacity_ample():
    spec = _spec(cf=16.0)
    p = _params(8, 16, spec)
    x = _x((4, 8, 16), 9)
    torch.testing.assert_close(moe.moe_forward(p, x, spec, n_groups=1),
                               moe.moe_forward(p, x, spec, n_groups=4), atol=1e-5, rtol=0)


def test_grouped_routing_is_group_independent():
    spec = _spec(cf=1.0)  # drops happen, but per group
    p = _params(10, 16, spec)
    x = _x((2, 16, 16), 11)
    out = moe.moe_forward(p, x, spec, n_groups=2)
    x2 = x.clone()
    x2[1] = x[1].flip(0)  # shuffle group 1's tokens
    out2 = moe.moe_forward(p, x2, spec, n_groups=2)
    torch.testing.assert_close(out[0], out2[0], atol=1e-6, rtol=0)


@settings(max_examples=10, deadline=None)
@given(G=st.sampled_from([1, 2, 4]), seed=st.integers(0, 50))
def test_grouped_routing_finite_property(G, seed):
    spec = MoESpec(n_experts=4, top_k=2, d_expert=16, capacity_factor=1.5)
    p = _params(seed, 8, spec)
    x = _x((4, 8, 8), seed + 1)
    out, aux = moe.moe_forward(p, x, spec, return_aux=True, n_groups=G)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert 0.0 <= float(aux["dropped_frac"]) <= 1.0


def test_capacity_rounding_sublane_and_cap():
    spec = _spec(E=4, K=2, cf=1.0)
    assert moe._capacity(100, spec) % 8 == 0
    assert moe._capacity(2, spec) <= 2
    assert moe._capacity(1, spec) == 1
    for T in (1, 2, 7, 8, 100, 513):
        for cf in (1.0, 1.25, 2.5, 4.0):
            jspec = JaxMoESpec(n_experts=4, top_k=2, d_expert=32, capacity_factor=cf)
            assert moe._capacity(T, _spec(cf=cf)) == jmoe._capacity(T, jspec)
    assert moe._auto_groups(8, 16, spec) == 1


def test_stable_topk_is_jax_top_k():
    """The port's top-k equals ``jax.lax.top_k`` in values and indices,
    ties (a quarter of the entries repeat) in ascending index order."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    x[..., 8:12] = x[..., 0:1]  # exact ties with column 0
    x[0, 0, :] = 0.0  # a row of ties only
    v1, i1 = moe._topk(torch.from_numpy(x), 5)
    v2, i2 = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(v1.numpy(), np.asarray(v2))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i2))


def test_grouped_routing_drop_rate_near_global():
    spec = MoESpec(n_experts=8, top_k=2, d_expert=16, capacity_factor=1.25)
    p = _params(20, 32, spec)
    x = _x((8, 64, 32), 21)
    _, aux1 = moe.moe_forward(p, x, spec, return_aux=True, n_groups=1)
    _, aux4 = moe.moe_forward(p, x, spec, return_aux=True, n_groups=4)
    assert float(aux4["dropped_frac"]) <= float(aux1["dropped_frac"]) + 0.05


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

E, D = 4, 32


def _pair(cf, n_experts=E, top_k=2):
    """(the JAX spec, the port's, the JAX params, the bridged params)."""
    jspec = JaxMoESpec(n_experts=n_experts, top_k=top_k, d_expert=24, capacity_factor=cf)
    spec = MoESpec(n_experts=n_experts, top_k=top_k, d_expert=24, capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(30), D, jspec)
    return jspec, spec, jp, bridge.to_torch(jax.tree.map(np.asarray, jp))


def _jax_routes(p, x, spec, G):
    """The reference's routing (``repro.models.moe.moe_forward``'s steps
    up to ``valid``), as it runs without a mesh."""
    B, S, d = x.shape
    Tg = (B // G) * S
    C = jmoe._capacity(Tg, spec)
    probs = jax.nn.softmax(x.reshape(G, Tg, d).astype(jnp.float32) @ p["router"], axis=-1)
    top_p, top_e = jax.lax.top_k(probs, spec.top_k)

    def _assign(tp, te):
        return jnp.zeros((Tg, spec.n_experts), jnp.float32).at[
            jnp.arange(Tg)[:, None], te].set(tp)

    prio = jnp.swapaxes(jax.vmap(_assign)(top_p, top_e), 1, 2)
    gate, idx = jax.lax.top_k(prio, C)
    return {"top_e": top_e, "idx": idx, "valid": gate > 0.0, "gate": gate}


def _check_against_jax(x_np, cf, G, n_experts=E, top_k=2):
    jspec, spec, jp, tp = _pair(cf, n_experts, top_k)
    x = torch.from_numpy(x_np)
    want = _jax_routes(jp, jnp.asarray(x_np), jspec, G)
    got = moe.route(tp, x, spec, n_groups=G)
    for k in ("top_e", "idx", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x_np), jspec, return_aux=True, n_groups=G)
    out, aux = moe.moe_forward(tp, x, spec, return_aux=True, n_groups=G)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    for k in ("load_balance", "router_z", "dropped_frac"):
        # 1e-6, or one f32 ulp of the reference's value where that is more:
        # at 64 experts router_z is ~22 (ulp 1.9e-6), and the reference's
        # mean of its squared lse lies 1.4e-6 from the exact mean
        tol = max(1e-6, float(np.spacing(np.float32(jaux[k]))))
        assert abs(float(aux[k]) - float(jaux[k])) <= tol, k
    return got, aux


#: (experts, top-k) of the published configs' routing: moonshot-v1-16b-a3b's
#: 64 top-6 and grok-1-314b's (and mixtral's) 8 top-2
ROUTINGS = [(64, 6), (8, 2)]


@pytest.mark.parametrize("n_experts,top_k,cf,G", [
    pytest.param(E, 2, cf, G, id=f"{cf}-{G}") for cf in (1.0, 1.25, float(E)) for G in (1, 2)
] + [pytest.param(n, k, cf, 1, id=f"E{n}-top{k}-{cf}-1")
     for n, k in ROUTINGS for cf in (1.0, 1.25)])
def test_moe_forward_matches_jax(n_experts, top_k, cf, G):
    """Routes equal exactly, the output within 1e-5, the aux within 1e-6;
    tokens drop below cf E and none at E. The published routings run on
    4 x 32 tokens (moonshot's 64 experts a capacity of 16 at 1.25, 16 at
    1.0), and drop at both capacity factors."""
    shape = (4, 12, D) if n_experts == E else (4, 32, D)
    got, aux = _check_against_jax(_x(shape, 31).numpy(), cf, G, n_experts, top_k)
    if cf == float(n_experts):
        assert float(aux["dropped_frac"]) == 0.0
    elif cf == 1.0 or n_experts != E:
        assert float(aux["dropped_frac"]) > 0.0


@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_repeated_tokens_at_the_capacity_boundary_keep_jax_tokens(cf):
    """Three distinct token rows repeated 36, 6 and 6 times, so the
    priorities an expert sees come in exact ties and the first row's two
    experts get more tokens than their capacity: the cut runs through a
    run of equal priorities, and the port keeps the reference's tokens
    (lower index first)."""
    base = _x((3, D), 32).numpy()
    x = np.repeat(base, [36, 6, 6], axis=0)[np.random.default_rng(33).permutation(48)]
    got, aux = _check_against_jax(x.reshape(4, 12, D), cf, 1)
    assert float(aux["dropped_frac"]) > 0.0


def test_moe_gradients_match_jax_grad():
    """At capacity factor 1.25 (tokens drop): d(mean(out²))/d(router,
    wi, wg, wo) and d/dx within 1e-5 of ``jax.grad``'s."""
    jspec, spec, jp, tp = _pair(1.25)
    x_np = _x((4, 12, D), 34).numpy()

    def jloss(p, x):
        return jnp.mean(jnp.square(jmoe.moe_forward(p, x, jspec)))

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x_np))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = torch.from_numpy(x_np).requires_grad_()
    torch.mean(torch.square(moe.moe_forward(tp, x, spec))).backward()
    for k in ("router", "wi", "wg", "wo"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)


def test_route_recorder_reports_kept_routes():
    """Each call inside ``record_routes`` appends its (B, S, K) experts and
    kept flags: a kept route is one the expert dispatched and kept; the
    dropped share equals ``dropped_frac``; outside the block nothing is
    recorded."""
    _, spec, _, tp = _pair(1.0)
    x = _x((4, 12, D), 35)
    with moe.record_routes() as routes:
        _, aux = moe.moe_forward(tp, x, spec, return_aux=True)
        moe.moe_forward(tp, x[:2], spec)
    moe.moe_forward(tp, x, spec)
    assert len(routes) == 2 and routes[1]["top_e"].shape == (2, 12, 2)
    r = moe.route(tp, x, spec)
    kept = routes[0]["kept"].reshape(-1, 2)
    top_e = routes[0]["top_e"].reshape(-1, 2)
    for t in range(top_e.shape[0]):
        for k in range(2):
            e = int(top_e[t, k])
            taken = bool(((r["idx"][0, e] == t) & r["valid"][0, e]).any())
            assert bool(kept[t, k]) == taken
    assert abs((1.0 - float(kept.float().mean())) - float(aux["dropped_frac"])) < 1e-6


def _followed(p, x, spec, rec):
    """What following the record ``rec`` gives, token by token: each kept
    recorded expert's gated MLP, weighted by this input's probability."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    out = torch.zeros_like(xt)
    for t, (es, ks) in enumerate(zip(rec["top_e"].reshape(-1, spec.top_k),
                                     rec["kept"].reshape(-1, spec.top_k))):
        for e, k in zip(es.tolist(), ks.tolist()):
            if k:
                h = torch.nn.functional.silu(xt[t] @ p["wg"][e]) * (xt[t] @ p["wi"][e])
                out[t] += probs[t, e] * (h @ p["wo"][e])
    return out.reshape(B, S, d)


@pytest.mark.parametrize("n_experts,top_k", [(E, 2)] + ROUTINGS)
def test_replayed_routes_are_followed_and_own_choices_recorded(n_experts, top_k):
    """Under ``replay_routes`` a call follows another input's recorded
    routes (each kept expert gated by this input's probability, within
    1e-5 of the token-by-token sum) and records its own routing, which
    equals what it records unreplayed; replaying a call's own routes gives
    its output bit for bit, at capacity factor 1.0 (routes dropped)."""
    _, spec, _, tp = _pair(1.0, n_experts, top_k)
    x, other = _x((4, 32, D), 36), _x((4, 32, D), 37)
    with moe.record_routes() as own:
        want = moe.moe_forward(tp, x, spec)
    with moe.record_routes() as theirs:
        moe.moe_forward(tp, other, spec)
    assert not bool(theirs[0]["kept"].all())  # the record drops routes
    with moe.replay_routes(own), moe.record_routes() as again:
        got = moe.moe_forward(tp, x, spec)
    assert torch.equal(got, want)
    with moe.replay_routes(theirs), moe.record_routes() as chosen:
        followed = moe.moe_forward(tp, x, spec)
    torch.testing.assert_close(followed, _followed(tp, x, spec, theirs[0]), atol=1e-5, rtol=0)
    for rec in (again[0], chosen[0]):
        assert all(torch.equal(rec[k], own[0][k]) for k in ("top_e", "kept"))


def test_replay_refuses_a_record_it_cannot_follow():
    """More calls than records, a record left over, and a record of
    another shape each raise."""
    _, spec, _, tp = _pair(1.0)
    x = _x((4, 12, D), 38)
    with moe.record_routes() as recs:
        moe.moe_forward(tp, x, spec)
    with pytest.raises(ValueError, match="more MoE calls"):
        with moe.replay_routes(recs):
            moe.moe_forward(tp, x, spec)
            moe.moe_forward(tp, x, spec)
    with pytest.raises(ValueError, match="not replayed"):
        with moe.replay_routes(recs + recs):
            moe.moe_forward(tp, x, spec)
    with pytest.raises(ValueError, match="does not match"):
        with moe.replay_routes(recs):
            moe.moe_forward(tp, x[:2], spec)


def test_expert_leaves_quantize_per_period_as_the_stacked_leaf():
    """``init_backbone(quant_bits=8)`` draws an MoE expert leaf one period
    at a time and quantizes each: the codes and scales equal those of the
    same f32 draws stacked and quantized whole (quantization runs along
    the last axis), the router stays f32, and an unquantized draw from the
    same seed holds those f32 values."""
    cfg = get_arch("mixtral-8x7b").reduced()
    qb = init_backbone(torch.Generator().manual_seed(3), cfg, quant_bits=8)
    fb = init_backbone(torch.Generator().manual_seed(3), cfg)
    for qf, ff in zip(qb["blocks"], fb["blocks"]):
        assert not isinstance(qf["ffn"]["router"], QTensor)
        torch.testing.assert_close(qf["ffn"]["router"], ff["ffn"]["router"], atol=0, rtol=0)
        for name in ("wi", "wg", "wo"):
            q, whole = qf["ffn"][name], quantize(ff["ffn"][name], 8)
            assert q.q.shape[:2] == (cfg.n_periods, cfg.moe.n_experts)
            assert torch.equal(q.q, whole.q) and torch.equal(q.scale, whole.scale)
    tree = quantize_tree(fb, bits=8)
    assert not isinstance(tree["blocks"][0]["ffn"]["router"], QTensor)


def test_cuda_opset_dequantizes_moe_experts_only():
    """The ``cuda`` OpSet keeps the attention projections quantized for
    ``quant_matmul`` and dequantizes an MoE FFN's experts (the reference's
    pallas OpSet does the same); the router passes through f32."""
    cfg = get_arch("mixtral-8x7b").reduced()
    qb = init_backbone(torch.Generator().manual_seed(4), cfg, quant_bits=8)
    block = {k: (v[0] if not isinstance(v, dict) else
                 {n: t[0] for n, t in v.items()}) for k, v in qb["blocks"][0].items()}
    spec = LayerSpec(kind="attn", moe=True, window=cfg.pattern[0].window)
    out = get_opset("cuda").prepare_block(block, spec)
    assert isinstance(out["mixer"]["wq"], QTensor)
    for name in ("wi", "wg", "wo"):
        assert not isinstance(out["ffn"][name], QTensor)
        torch.testing.assert_close(out["ffn"][name], dequantize(block["ffn"][name]),
                                   atol=0, rtol=0)
    assert torch.equal(out["ffn"]["router"], block["ffn"]["router"])


def test_reduced_moe_configs_keep_the_reference_spec():
    for arch in ("mixtral-8x7b", "moonshot-v1-16b-a3b", "grok-1-314b", "kimi-k2-1t-a32b"):
        cfg, ref = get_arch(arch).reduced(), jax_get_arch(arch).reduced()
        assert cfg.moe.capacity_factor == ref.moe.capacity_factor == float(cfg.moe.n_experts)
        assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert) == (
            ref.moe.n_experts, ref.moe.top_k, ref.moe.d_expert)
