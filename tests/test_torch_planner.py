"""The port's planner (paper Alg. 1) and its cost functions against the
JAX reference's, on the CPU.

* ``model_layer_costs`` and ``period_costs`` equal the reference's field
  by field (``==``) for every technique and quantization, on
  internlm2-1.8b and its reduced form;
* plans equal the reference's on the same costs and devices — every
  stage's layers, devices, split and times, the phase latencies and
  ``describe()`` — for ``plan()``, ``plan(max_stages=)``,
  ``plan(available=)``, the heterogeneity-oblivious planner,
  ``plan_pure_dp``, ``plan_pure_pp`` and ``brute_force_plan``, over
  seeded random costs and pools (a property);
* ``simulate_plan`` equals the reference's;
* twins of ``tests/test_planner.py``'s nine tests against the port's
  planner. Where those use a paper model the port has no config for
  (t5-base, bart-large), the cost rows are the reference's, carried
  over as numpy rows into the port's ``LayerCost``.
"""

import dataclasses
import itertools
import json
import random

import numpy as np
import pytest
from _propcheck import given, settings, strategies as st

from repro.configs import get_arch as jax_arch
from repro.core import pipeline as jax_pipeline
from repro.core import planner as J
from repro_torch.configs import get_arch
from repro_torch.core import planner as P
from repro_torch.core.pipeline import simulate_plan

TECHNIQUES = ("pac", "pac_cached", "lora", "adapters", "full")
ENV_A = [P.JETSON_NANO_H] * 4
ENV_B = [P.JETSON_NANO_H, P.JETSON_NANO_L, P.JETSON_TX2_H, P.JETSON_TX2_L]


def to_jax(items):
    """Port LayerCosts or DeviceProfiles as the reference's (same fields)."""
    kinds = {P.LayerCost: J.LayerCost, P.DeviceProfile: J.DeviceProfile}
    return [kinds[type(x)](**dataclasses.asdict(x)) for x in items]


def same_plan(mine, ref) -> None:
    """Every field of two plans equal: ``==`` on each float."""
    if ref is None:
        assert mine is None
        return
    assert json.loads(mine.to_json()) == json.loads(ref.to_json())
    assert mine.minibatch_latency == ref.minibatch_latency
    assert mine.describe() == ref.describe()
    assert mine.stage_partition() == P.StagePartition(**dataclasses.asdict(
        ref.stage_partition()))


def _cfgs(name):
    return get_arch(name), jax_arch(name)


# ---------------------------------------------------------------------------
# Cost functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("quant_bits", [None, 8, 4])
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_costs_equal_the_reference(technique, quant_bits, reduced):
    mine, ref = _cfgs("internlm2-1.8b")
    if reduced:
        mine, ref = mine.reduced(), ref.reduced()
    for seq in (128, 512):
        got = P.model_layer_costs(mine, technique, seq_len=seq, quant_bits=quant_bits)
        want = J.model_layer_costs(ref, technique, seq_len=seq, quant_bits=quant_bits)
        assert [dataclasses.astuple(c) for c in got] == [dataclasses.astuple(c) for c in want]
        got = P.period_costs(mine, technique, seq_len=seq, quant_bits=quant_bits)
        want = J.period_costs(ref, technique, seq_len=seq, quant_bits=quant_bits)
        assert [dataclasses.astuple(c) for c in got] == [dataclasses.astuple(c) for c in want]


def test_unknown_technique_and_bad_period_are_refused():
    cfg = get_arch("internlm2-1.8b").reduced()
    with pytest.raises(ValueError):
        P.model_layer_costs(cfg, "prefix")
    with pytest.raises(ValueError):
        P.aggregate_periods(P.model_layer_costs(cfg), 3)


# ---------------------------------------------------------------------------
# Plans against the reference (property over seeded random inputs)
# ---------------------------------------------------------------------------


def _random_inputs(seed, n_layers, flops):
    rng = random.Random(seed)
    devs = [P.DeviceProfile(f"d{i}", f, rng.choice([1e8, 5e8, 8 * 2 ** 30]),
                            rng.choice([125e6, 1e9])) for i, f in enumerate(flops)]
    costs = [P.LayerCost(fwd_flops=rng.uniform(1e9, 5e10), bwd_flops=rng.uniform(1e9, 1e11),
                         param_bytes=rng.uniform(1e6, 1e8), trainable_bytes=rng.uniform(1e5, 1e7),
                         act_bytes=rng.uniform(1e5, 1e7),
                         resident_act_bytes=rng.uniform(1e5, 1e7))
             for _ in range(n_layers)]
    return costs, devs


@settings(max_examples=12, deadline=None)
@given(flops=st.lists(st.floats(1e9, 1e12), min_size=1, max_size=4),
       n_layers=st.integers(1, 5), mb=st.integers(1, 4), micro=st.integers(1, 4),
       seed=st.integers(0, 10_000))
def test_plans_equal_the_reference(flops, n_layers, mb, micro, seed):
    costs, devs = _random_inputs(seed, n_layers, flops)
    jc, jd = to_jax(costs), to_jax(devs)

    def both(fn):
        try:
            mine = fn(P, costs, devs)
        except RuntimeError as e:  # no feasible plan: both must say so
            with pytest.raises(RuntimeError, match=str(e)):
                fn(J, jc, jd)
            return
        same_plan(mine, fn(J, jc, jd))

    both(lambda m, c, d: m.HybridParallelismPlanner(c, d, mb, micro).plan())
    both(lambda m, c, d: m.HybridParallelismPlanner(c, d, mb, micro).plan(max_stages=2))
    both(lambda m, c, d: m.HybridParallelismPlanner(
        c, d, mb, micro, heterogeneity_aware=False).plan())
    subset = sorted(random.Random(seed).sample(range(len(devs)), max(1, len(devs) - 1)))
    both(lambda m, c, d: m.HybridParallelismPlanner(c, d, mb, micro).plan(available=subset))
    both(lambda m, c, d: m.plan_pure_dp(c, d, mb, micro))
    both(lambda m, c, d: m.plan_pure_pp(c, d, mb, micro))
    both(lambda m, c, d: m.brute_force_plan(c, d, mb, micro))


def test_replanning_a_subset_reuses_the_planner():
    """plan(available=) on one planner equals a fresh planner over the
    same devices, and the reference's."""
    costs, devs = _random_inputs(7, 4, [2e11, 6e11, 3e11, 1e12])
    devs = [dataclasses.replace(d, memory_bytes=8 * 2 ** 30) for d in devs]
    mine = P.HybridParallelismPlanner(costs, devs, 4, 2)
    ref = J.HybridParallelismPlanner(to_jax(costs), to_jax(devs), 4, 2)
    same_plan(mine.plan(), ref.plan())
    for avail in ((0, 2, 3), (1,), (3, 1)):
        same_plan(mine.plan(available=avail), ref.plan(available=avail))
    with pytest.raises(ValueError):
        mine.plan(available=(0, 0))
    with pytest.raises(ValueError):
        mine.plan(available=(4,))


def test_internlm2_plans_equal_the_reference():
    """Period-granular plans of full internlm2-1.8b, as the trainer and
    the smoke make them: 4 Nano (high power) and a heterogeneous pool."""
    mine, ref = _cfgs("internlm2-1.8b")
    pc = P.period_costs(mine, "pac", seq_len=512, quant_bits=8)
    jpc = J.period_costs(ref, "pac", seq_len=512, quant_bits=8)
    for devs in (ENV_A, ENV_B):
        same_plan(P.HybridParallelismPlanner(pc, devs, 2, 2).plan(max_stages=4),
                  J.HybridParallelismPlanner(jpc, to_jax(devs), 2, 2).plan(max_stages=4))
    need = sum(c.param_bytes + 2 * c.trainable_bytes for c in pc)
    devs = [dataclasses.replace(d, memory_bytes=need * 0.5)
            for d in (P.JETSON_NANO_L, P.JETSON_TX2_H, P.JETSON_NANO_H)]
    plan = P.HybridParallelismPlanner(pc, devs, 2, 2).plan(max_stages=3)
    same_plan(plan, J.HybridParallelismPlanner(jpc, to_jax(devs), 2, 2).plan(max_stages=3))
    assert plan.stage_partition().boundaries == (0, 5, 16, 24)  # the smoke's ragged plan


# ---------------------------------------------------------------------------
# simulate_plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("devices", ["A", "B"])
def test_simulate_plan_equals_the_reference(devices):
    devs = ENV_A if devices == "A" else ENV_B
    mine, ref = _cfgs("internlm2-1.8b")
    pc = P.period_costs(mine, "pac", seq_len=128, quant_bits=8)
    jpc = J.period_costs(ref, "pac", seq_len=128, quant_bits=8)
    for micro in (1, 2, 4):
        plans = [P.HybridParallelismPlanner(pc, devs, 4, micro).plan(max_stages=s)
                 for s in (1, 2, 4)]
        refs = [J.HybridParallelismPlanner(jpc, to_jax(devs), 4, micro).plan(max_stages=s)
                for s in (1, 2, 4)]
        for plan, rplan in zip(plans, refs):
            assert simulate_plan(plan) == jax_pipeline.simulate_plan(rplan)
            comm = [1e6 * (i + 1) for i in range(plan.n_stages)]
            assert simulate_plan(plan, comm) == jax_pipeline.simulate_plan(rplan, comm)


def test_simulate_plan_hand_built_stages_use_the_1_to_2_split():
    """Stages without recorded fwd/bwd times fall back to tf:tb = 1:2,
    as in the reference."""
    st_ = [P.Stage(0, 0, (P.JETSON_NANO_H,), (2,), 3.0), P.Stage(1, 1, (P.JETSON_NANO_H,), (2,), 6.0)]
    plan = P.Plan(st_, 2, 3, 0.0, 0.0, 0.0)
    rplan = J.Plan([J.Stage(s.layer_start, s.layer_end, tuple(to_jax(s.devices)),
                            s.samples_per_device, s.stage_time) for s in st_], 2, 3, 0.0, 0.0, 0.0)
    got = simulate_plan(plan)
    assert got == jax_pipeline.simulate_plan(rplan)
    assert got["per_stage_busy"] == [9.0, 18.0]


# ---------------------------------------------------------------------------
# Twins of tests/test_planner.py
# ---------------------------------------------------------------------------


def _costs(tech="pac", arch="t5-base-pac", L=None, seq=128):
    """Per-layer costs: the port's own for an arch it has; for a paper
    model it has no config for, the reference's cost rows carried over
    as numpy rows."""
    try:
        c = P.model_layer_costs(get_arch(arch), tech, seq_len=seq)
    except KeyError:
        rows = np.array([dataclasses.astuple(x)
                         for x in J.model_layer_costs(jax_arch(arch), tech, seq_len=seq)])
        c = [P.LayerCost(*(float(v) for v in row)) for row in rows]
    return c[:L] if L else c


def test_planner_beats_or_matches_pure_baselines():
    for tech in ("pac", "full", "lora"):
        costs = _costs(tech)
        hp = P.HybridParallelismPlanner(costs, ENV_A, 4, 4).plan()
        for base in (P.plan_pure_dp(costs, ENV_A, 4, 4), P.plan_pure_pp(costs, ENV_A, 4, 4)):
            if base is not None:
                assert hp.minibatch_latency <= base.minibatch_latency + 1e-9


def test_full_ft_ooms_on_dp_but_not_hp():
    """Paper Table V: Standalone/DP OOM for full FT; PP/HP survive."""
    costs = _costs("full", arch="bart-large-pac")
    assert P.plan_pure_dp(costs, ENV_A, 4, 4) is None
    hp = P.HybridParallelismPlanner(costs, ENV_A, 4, 4).plan()
    assert hp.n_stages > 1  # must partition to fit


def test_pac_relaxes_memory_pressure():
    """PAC+ fits with fewer stages than full FT (lighter activations)."""
    full = P.HybridParallelismPlanner(_costs("full"), ENV_A, 4, 4).plan()
    pac = P.HybridParallelismPlanner(_costs("pac"), ENV_A, 4, 4).plan()
    assert pac.minibatch_latency < full.minibatch_latency


def test_dp_matches_brute_force_small():
    costs = _costs("full", L=5, seq=64)
    devs = [P.JETSON_NANO_H, P.JETSON_TX2_H, P.JETSON_NANO_L]
    dp = P.HybridParallelismPlanner(costs, devs, 3, 2).plan()
    bf = P.brute_force_plan(costs, devs, 3, 2)
    assert dp.minibatch_latency <= bf.minibatch_latency + 1e-9


@settings(max_examples=8, deadline=None)
@given(flops=st.lists(st.floats(1e9, 1e12), min_size=2, max_size=4),
       L=st.integers(2, 5), seed=st.integers(0, 50))
def test_dp_optimality_property(flops, L, seed):
    """Planner DP ≡ brute force over random device pools: optimal stage
    balance (Eq. 3) for every stage count."""
    rng = random.Random(seed)
    devs = [P.DeviceProfile(f"d{i}", f, 8 * 2 ** 30, 125e6) for i, f in enumerate(flops)]
    costs = [P.LayerCost(fwd_flops=rng.uniform(1e9, 5e10), bwd_flops=rng.uniform(1e9, 1e11),
                         param_bytes=rng.uniform(1e6, 1e8), trainable_bytes=1e6, act_bytes=1e6,
                         resident_act_bytes=rng.uniform(1e5, 1e7))
             for _ in range(L)]
    p = P.HybridParallelismPlanner(costs, devs, 2, 2)
    p.plan()
    n = len(devs)
    for s in range(1, min(n, L) + 1):
        w_dp, cfgs = p._w(L - 1, n, s)
        if cfgs is None:
            continue
        best = P.INF
        for cuts in itertools.combinations(range(L - 1), s - 1):
            bounds = [(a + 1, b) for a, b in zip((-1,) + cuts, cuts + (L - 1,))]
            for dcuts in itertools.combinations(range(1, n), s - 1):
                dbounds = [(a, b) for a, b in zip((0,) + dcuts, dcuts + (n,))]
                worst = 0.0
                for (x, y), (da, db) in zip(bounds, dbounds):
                    t, _ = p.stage_dispatch(x, y, tuple(range(da, db)), 2)
                    worst = max(worst, t)
                best = min(best, worst)
        assert w_dp <= best + 1e-9


def test_infeasible_raises():
    tiny = [P.DeviceProfile("t", 1e9, 1 << 20)] * 2  # 1 MB devices
    with pytest.raises(RuntimeError, match="no feasible plan"):
        P.HybridParallelismPlanner(_costs("full"), tiny, 4, 4).plan()


def test_heterogeneity_aware_beats_oblivious():
    """Paper Fig. 12: het-aware planning ≤ uniform-split planning."""
    costs = _costs("pac", arch="bart-large-pac")
    het = P.HybridParallelismPlanner(costs, ENV_B, 8, 4).plan()
    obl = P.HybridParallelismPlanner(costs, ENV_B, 8, 4, heterogeneity_aware=False).plan()
    assert het.minibatch_latency <= obl.minibatch_latency + 1e-9


def test_stage_dispatch_respects_speed_ordering():
    """Faster devices get ≥ samples of slower ones in one group."""
    costs = _costs("pac", L=4)
    pl = P.HybridParallelismPlanner(costs, [P.JETSON_NANO_L, P.JETSON_TX2_H], 8, 2)
    t, split = pl.stage_dispatch(0, 3, (0, 1), 8)
    assert split[1] >= split[0]  # tx2-h is ~2.7x faster than nano-l


def test_layer_costs_reflect_techniques():
    """PAC+ backward ≪ LoRA backward ≪ full backward (paper Fig. 13a),
    on the port's internlm2-1.8b."""
    cfg = get_arch("internlm2-1.8b")
    full = sum(c.bwd_flops for c in P.model_layer_costs(cfg, "full"))
    lora = sum(c.bwd_flops for c in P.model_layer_costs(cfg, "lora"))
    pac = sum(c.bwd_flops for c in P.model_layer_costs(cfg, "pac"))
    pac_total = sum(c.fwd_flops + c.bwd_flops for c in P.model_layer_costs(cfg, "pac"))
    cached = sum(c.fwd_flops + c.bwd_flops for c in P.model_layer_costs(cfg, "pac_cached"))
    assert pac < 0.15 * full  # ~92% backward reduction in the paper
    assert lora <= full
    assert cached < 0.2 * pac_total  # cache removes the backbone forward


# ---------------------------------------------------------------------------
# MoE configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_moe_plans_equal_the_reference(arch):
    """An MoE config's analytic costs (the experts priced at top_k of E
    for compute, all E for memory) and its plans on 4 Nano (high power)
    and the heterogeneous pool equal the reference's with ``==``."""
    mine, ref = _cfgs(arch)
    for technique in TECHNIQUES:
        got = P.period_costs(mine, technique, seq_len=512, quant_bits=8)
        want = J.period_costs(ref, technique, seq_len=512, quant_bits=8)
        assert [dataclasses.astuple(c) for c in got] == [dataclasses.astuple(c) for c in want]
    pc = P.period_costs(mine, "pac", seq_len=512, quant_bits=8)
    jpc = J.period_costs(ref, "pac", seq_len=512, quant_bits=8)
    big = [dataclasses.replace(d, memory_bytes=d.memory_bytes * 64) for d in ENV_B]
    for devs in (ENV_A, ENV_B, big):
        try:
            want = J.HybridParallelismPlanner(jpc, to_jax(devs), 2, 2).plan(max_stages=4)
        except RuntimeError as e:  # the model does not fit the pool: both refuse
            with pytest.raises(RuntimeError, match=str(e)):
                P.HybridParallelismPlanner(pc, devs, 2, 2).plan(max_stages=4)
            assert devs is not big
            continue
        same_plan(P.HybridParallelismPlanner(pc, devs, 2, 2).plan(max_stages=4), want)


def test_calibrated_model_counts_an_moe_step_on_meta():
    """``CalibratedCostModel`` counts mixtral reduced's PAC+ steps on the
    meta device (the stable top-k, the scatter and the dispatch gather run
    there): the counted forward of a period is within 2x of the analytic
    one, and the experts' three products are counted at their capacity
    (every expert over all T tokens at reduced()'s capacity factor E)."""
    from repro_torch.launch.costs import CalibratedCostModel, count_step_flops

    cfg = get_arch("mixtral-8x7b").reduced()
    base = P.period_costs(cfg, "pac", seq_len=32)
    got = CalibratedCostModel(micro_batch=2).period_costs(cfg, "pac", seq_len=32)
    assert len(got) == len(base) and all(c.fwd_flops > 0 and c.bwd_flops > 0 for c in got)
    assert 0.5 <= got[0].fwd_flops / base[0].fwd_flops <= 2.0
    one = dataclasses.replace(cfg, n_layers=cfg.period)
    no_ffn = dataclasses.replace(one, pattern=tuple(dataclasses.replace(s, ffn=False)
                                                    for s in one.pattern))
    experts = count_step_flops(one, "pac", 2, 32) - count_step_flops(no_ffn, "pac", 2, 32)
    E, C = cfg.moe.n_experts, 2 * 32  # capacity factor E: C = T
    assert experts >= 3 * 2 * E * C * cfg.d_model * cfg.moe.d_expert


def test_calibrated_model_counts_an_mrope_step_on_meta():
    """``CalibratedCostModel`` counts qwen2-vl reduced's PAC+ steps (mrope:
    (3, B, S) positions on the meta device): the counted forward of a
    period within 2x of the analytic one, both techniques counted."""
    from repro_torch.launch.costs import CalibratedCostModel, count_step_flops

    cfg = get_arch("qwen2-vl-7b").reduced()
    base = P.period_costs(cfg, "pac", seq_len=32)
    got = CalibratedCostModel(micro_batch=2).period_costs(cfg, "pac", seq_len=32)
    assert len(got) == len(base) and all(c.fwd_flops > 0 and c.bwd_flops > 0 for c in got)
    assert 0.5 <= got[0].fwd_flops / base[0].fwd_flops <= 2.0
    assert count_step_flops(cfg, "pac_cached", 2, 32) > 0
