"""Plan-driven execution in the port against the JAX reference's, on the
CPU: the planner's plan as the run's contract.

* ``StagePartition`` (shape, masks, refusals), ``Plan.stage_partition``
  and ``aggregate_periods`` as in ``tests/test_plan_execution.py``, and
  equal to the reference's objects;
* plan JSON crosses between the packages both ways; an unknown version
  is refused;
* ``plan_mesh_shape`` (the twin of ``make_plan_mesh``'s layout rule);
* the calibrated cost model holds the reference's own contract at
  reduced size, counted on the ``meta`` device;
* ``RunSpec``'s plan fields and the session's plan resolution raise the
  reference's errors, word for word;
* the reported lines (``plan:``, ``edge-pool plan:``, the notes) and the
  layout that ``--plan auto`` picks, with and without ``micro``, equal
  the JAX session's for the same flags (one JAX subprocess opens those
  sessions on 4 forced host devices);
* a planner-made ragged 3-stage plan of a 5-period config on 3 gloo
  ranks matches the JAX reference's single-device loss, gradients and
  taps, and a whole ``EdgeSession`` replay of it matches the port's
  single-process run step by step;
* the trainer CLI: ``--plan auto --pool 4 --micro 2`` runs dp=2 x pp=2
  with ``--dp 2 --stages 2``'s losses, and ``--save-plan`` replays.

Spawned ranks run with a gloo timeout of 60 s and a 120 s deadline.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import planner as J
from repro.core.pipeline import simulate_plan as jax_simulate_plan
from repro.runtime import RunSpec as JaxSpec
from repro.runtime import RunSpecError as JaxSpecError
from repro_torch import bridge
from repro_torch.configs import base as configs_base
from repro_torch.configs import get_arch, register
from repro_torch.core import planner as P
from repro_torch.core import steps
from repro_torch.core.pipeline import simulate_plan
from repro_torch.core.quantization import tree_leaves
from repro_torch.launch.costs import (AnalyticCostModel, CalibratedCostModel, CostModel,
                                      count_step_flops, resolve_cost_model)
from repro_torch.launch.mesh import EdgeMesh, plan_mesh_shape, spawn
from repro_torch.runtime import EdgeSession, EpochRunner, RunHooks, RunSpec, RunSpecError
from repro_torch.runtime.session import Layout, resolve_layout

REPO = Path(__file__).resolve().parents[1]
GLOO_TIMEOUT, DEADLINE = 60.0, 120.0
B, S, R = 4, 16, 4


# ---------------------------------------------------------------------------
# StagePartition: the executable artifact
# ---------------------------------------------------------------------------


def test_stage_partition_shape_and_masks():
    kw = dict(boundaries=(0, 2, 6, 10), samples_per_device=((4,), (4,), (2, 2)), n_micro=2)
    p, ref = P.StagePartition(**kw), J.StagePartition(**kw)
    assert p.n_stages == 3 and p.n_periods == 10
    assert p.periods_per_stage == (2, 4, 4) and p.max_periods == 4
    assert not p.is_uniform
    assert p.masks() == ((True, True, False, False), (True, True, True, True),
                         (True, True, True, True))
    for name in ("n_stages", "n_periods", "periods_per_stage", "max_periods", "is_uniform"):
        assert getattr(p, name) == getattr(ref, name)
    assert p.masks() == ref.masks() and dataclasses.asdict(p) == dataclasses.asdict(ref)
    u = P.StagePartition(boundaries=(0, 5, 10), samples_per_device=((4,), (4,)), n_micro=2)
    assert u.is_uniform and u.masks() == ((True,) * 5, (True,) * 5)


@pytest.mark.parametrize("kw", [
    dict(boundaries=(1, 3), samples_per_device=((1,),), n_micro=1),
    dict(boundaries=(0, 3, 2), samples_per_device=((1,), (1,)), n_micro=1),
    dict(boundaries=(0,), samples_per_device=(), n_micro=1),
    dict(boundaries=(0, 2, 4), samples_per_device=((1,),), n_micro=1),  # splits/stages
])
def test_stage_partition_rejects_bad_boundaries(kw):
    with pytest.raises(ValueError) as mine:
        P.StagePartition(**kw)
    with pytest.raises(ValueError) as ref:
        J.StagePartition(**kw)
    assert str(mine.value) == str(ref.value)


def test_plan_partition_from_planner_is_executable():
    cfg = get_arch("internlm2-1.8b").reduced()
    plan = P.HybridParallelismPlanner(P.period_costs(cfg, "pac", seq_len=32),
                                      [P.JETSON_NANO_H] * 4, 4, 2).plan()
    part = plan.stage_partition()
    assert part.n_periods == cfg.n_periods
    assert sum(part.periods_per_stage) == cfg.n_periods
    assert part.n_micro == plan.micro_batches
    ref = J.HybridParallelismPlanner(J.period_costs(jax_arch("internlm2-1.8b").reduced(), "pac",
                                                    seq_len=32), [J.JETSON_NANO_H] * 4, 4, 2).plan()
    assert dataclasses.asdict(part) == dataclasses.asdict(ref.stage_partition())


def _paper_layer_costs(arch, technique, seq):
    """The reference's per-layer cost rows of a paper model the port has
    no config for, as the port's ``LayerCost``s (numpy rows)."""
    rows = np.array([dataclasses.astuple(c)
                     for c in J.model_layer_costs(jax_arch(arch), technique, seq_len=seq)])
    return [P.LayerCost(*(float(v) for v in row)) for row in rows]


def test_layer_granularity_plan_refuses_off_period_cut():
    """A plan cut inside a period is a report, not a contract."""
    costs = _paper_layer_costs("t5-base-pac", "full", 64)
    plan = P.HybridParallelismPlanner(costs, [P.JETSON_NANO_H] * 4, 2, 4).plan()
    assert plan.n_stages > 1  # the reference's inputs give an interior cut
    with pytest.raises(ValueError, match="not a period boundary"):
        plan.stage_partition(layers_per_period=len(costs))


def test_aggregate_periods_sums_flops_keeps_boundary_act():
    cfg = dataclasses.replace(get_arch("internlm2-1.8b").reduced(), n_layers=6)
    layer = P.model_layer_costs(cfg, "pac", seq_len=64)
    per = P.aggregate_periods(layer, 2)
    assert len(per) == 3
    assert per[0].fwd_flops == sum(c.fwd_flops for c in layer[:2])
    assert per[0].act_bytes == layer[1].act_bytes  # the boundary activation, not the sum
    ref = J.aggregate_periods([J.LayerCost(*dataclasses.astuple(c)) for c in layer], 2)
    assert [dataclasses.astuple(c) for c in per] == [dataclasses.astuple(c) for c in ref]
    with pytest.raises(ValueError):
        P.aggregate_periods(layer, len(layer) + 1)


# ---------------------------------------------------------------------------
# Plan JSON across the packages
# ---------------------------------------------------------------------------


def test_plan_json_crosses_both_ways(tmp_path):
    cfg = get_arch("internlm2-1.8b").reduced()
    env_b = [P.JETSON_NANO_H, P.JETSON_NANO_L, P.JETSON_TX2_H, P.JETSON_TX2_L]
    mine = P.HybridParallelismPlanner(P.period_costs(cfg, "pac", seq_len=32), env_b, 4, 2).plan()
    ref = J.HybridParallelismPlanner(
        J.period_costs(jax_arch("internlm2-1.8b").reduced(), "pac", seq_len=32),
        [J.DeviceProfile(**dataclasses.asdict(d)) for d in env_b], 4, 2).plan()
    assert mine.to_json() == ref.to_json()
    into_ref = J.Plan.load(mine.save(str(tmp_path / "port.json")))
    into_port = P.Plan.load(ref.save(str(tmp_path / "ref.json")))
    for back, orig in ((into_ref, mine), (into_port, ref)):
        assert back.describe() == orig.describe()
        assert back.minibatch_latency == orig.minibatch_latency
        assert dataclasses.asdict(back.stage_partition()) == dataclasses.asdict(
            orig.stage_partition())
        for a, b in zip(back.stages, orig.stages):
            assert (a.fwd_time, a.bwd_time) == (b.fwd_time, b.bwd_time)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert simulate_plan(into_port) == jax_simulate_plan(into_ref)


def test_plan_json_rejects_unknown_version():
    with pytest.raises(ValueError, match="unsupported plan version 99"):
        P.Plan.from_json('{"version": 99}')


def test_layout_json_round_trips():
    spec = RunSpec(reduced=True, plan="auto", pool=4, micro=2, epochs=1, batch=4, seq=16)
    lay = resolve_layout(spec)
    assert Layout.from_json(lay.to_json()) == lay
    report = resolve_layout(RunSpec(reduced=True, batch=4, seq=16))
    assert report.partition is None and Layout.from_json(report.to_json()) == report


@pytest.mark.parametrize("boundaries,pool,mb,want", [
    ((0, 1, 2), 4, 2, (2, 2)),     # the --plan auto layout
    ((0, 1, 3, 5), 3, 2, (1, 3)),  # a ragged 3-stage plan on 3 devices
    ((0, 2, 4), 8, 3, (3, 2)),     # dp 4 would not divide the 3-row micro-batch
    ((0, 2), 4, 4, (4, 1)),
    ((0, 1, 2, 3, 4), 2, 2, (1, 4)),  # a pool smaller than the stages: one row
])
def test_plan_mesh_shape(boundaries, pool, mb, want):
    part = P.StagePartition(boundaries=boundaries, n_micro=1,
                            samples_per_device=((mb,),) * (len(boundaries) - 1))
    assert plan_mesh_shape(part, pool, mb) == want


# ---------------------------------------------------------------------------
# Cost models
# ---------------------------------------------------------------------------


def test_calibrated_cost_model_meets_the_reference_contract():
    """Memory stays analytic, the counted backbone forward is within 25 %
    of the analytic, the trainable side counts the head/CE the closed
    form omits, and other techniques pass through (the reference's
    ``test_hlo_calibrated_cost_model``)."""
    cfg = get_arch("internlm2-1.8b").reduced()
    ana, cal = AnalyticCostModel(), CalibratedCostModel(micro_batch=2)
    assert isinstance(ana, CostModel) and isinstance(cal, CostModel)
    base = ana.period_costs(cfg, "pac", seq_len=16)
    pc = cal.period_costs(cfg, "pac", seq_len=16)
    assert len(pc) == cfg.n_periods == len(base)
    for b, c in zip(base, pc):
        assert c.param_bytes == b.param_bytes and c.trainable_bytes == b.trainable_bytes
        assert c.resident_act_bytes == b.resident_act_bytes and c.act_bytes == b.act_bytes
        assert c.fwd_flops == pytest.approx(b.fwd_flops, rel=0.25)
        assert c.bwd_flops > b.bwd_flops
    for tech in ("full", "lora", "adapters"):
        assert cal.period_costs(cfg, tech, seq_len=16) == ana.period_costs(cfg, tech, seq_len=16)
    assert ana.period_costs(cfg, "pac", seq_len=16) == P.period_costs(cfg, "pac", seq_len=16)
    assert isinstance(resolve_cost_model(True, 2, 8), CalibratedCostModel)
    assert resolve_cost_model(False, 2, 8) == AnalyticCostModel(quant_bits=8)


def test_flop_count_runs_on_the_meta_device():
    """The count allocates nothing: the trees and activations are meta
    tensors, so no seeded draw runs and the head costs no memory. One
    period more adds one period's count; int8 weights count the same."""
    cfg = get_arch("internlm2-1.8b").reduced()
    one = dataclasses.replace(cfg, n_layers=1)
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    f1 = count_step_flops(one, "pac", 2, 16)
    f2 = count_step_flops(cfg, "pac", 2, 16)
    c1, c2 = count_step_flops(one, "pac_cached", 2, 16), count_step_flops(cfg, "pac_cached", 2, 16)
    assert f2 > f1 > c1 > 0 and c2 > c1
    assert (f2 - c2) == pytest.approx(2 * (f1 - c1), rel=1e-6)  # the backbone forward
    assert count_step_flops(cfg, "pac", 2, 16, quant_bits=8) == f2
    assert (torch.cuda.memory_allocated() if torch.cuda.is_available() else 0) == before
    with pytest.raises(ValueError):
        count_step_flops(cfg, "lora", 2, 16)


# ---------------------------------------------------------------------------
# RunSpec and plan resolution: the reference's errors
# ---------------------------------------------------------------------------


def _saved_plan(tmp_path, name, cfg_name, micro, pool=3):
    """A plan of ``cfg_name`` saved by the reference's planner."""
    if cfg_name == "plan5p":
        base = jax_arch("internlm2-1.8b").reduced()
        cfg = dataclasses.replace(base, name="plan5p", n_layers=5 * base.period)
    else:
        cfg = jax_arch(cfg_name).reduced()
    plan = J.HybridParallelismPlanner(J.period_costs(cfg, "pac", seq_len=16),
                                      [J.JETSON_NANO_H] * pool, 1, micro).plan()
    return plan.save(str(tmp_path / name))


def _both_raise(fn):
    with pytest.raises(RunSpecError) as mine:
        fn(RunSpec)
    with pytest.raises(JaxSpecError) as ref:
        fn(JaxSpec)
    assert str(mine.value) == str(ref.value)
    return str(mine.value)


def test_runspec_plan_fields_raise_the_reference_errors(tmp_path):
    five = _saved_plan(tmp_path, "five.json", "plan5p", 2, pool=3)
    assert P.Plan.load(five).n_stages == 3
    assert "pool must be >= 1" in _both_raise(lambda K: K(reduced=True, pool=0).validate())
    assert "cannot load plan file" in _both_raise(
        lambda K: K(reduced=True, plan=str(tmp_path / "none.json")).validate())
    (tmp_path / "bad.json").write_text('{"version": 7}')
    assert "unsupported plan version 7" in _both_raise(
        lambda K: K(reduced=True, plan=str(tmp_path / "bad.json")).validate())
    msg = _both_raise(lambda K: K(reduced=True, plan=five, pool=2).validate())
    assert msg == ("pool 2 is smaller than the saved plan's 3 stages; pass pool >= 3 or "
                   "replan with plan='auto'")
    # plan mode lifts the dp and period checks; micro still divides the batch
    for kw in ({"plan": "auto", "stages": 3}, {"plan": "auto", "pool": 8, "dp": 3},
               {"plan": five, "calibrate": True, "save_plan": "p.json"}):
        RunSpec(reduced=True, **kw).validate()
        JaxSpec(reduced=True, **kw).validate()
        assert RunSpec(reduced=True, **kw).default_micro() is None
    _both_raise(lambda K: K(reduced=True, plan="auto", micro=3).validate())


def _jax_open_error(spec, monkeypatch):
    """The reference session's error on opening ``spec`` (its open()
    raises in plan resolution, before building a mesh)."""
    from repro.runtime import EdgeSession as JaxSession

    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))  # open() writes it
    with pytest.raises(JaxSpecError) as err:
        JaxSession(spec).open()
    return str(err.value)


def test_plan_resolution_raises_the_reference_errors(tmp_path, monkeypatch):
    three = _saved_plan(tmp_path, "three.json", "internlm2-1.8b", 3, pool=2)
    five = _saved_plan(tmp_path, "five.json", "plan5p", 2, pool=3)
    for kw in ({"plan": three, "batch": 4}, {"plan": five, "batch": 4}):
        with pytest.raises(RunSpecError) as mine:
            resolve_layout(RunSpec(reduced=True, seq=16, **kw))
        assert str(mine.value) == _jax_open_error(JaxSpec(reduced=True, seq=16, **kw),
                                                  monkeypatch)
    assert "divisible by the plan's 3 micro-batches" in str(
        pytest.raises(RunSpecError, resolve_layout, RunSpec(reduced=True, plan=three)).value)


# ---------------------------------------------------------------------------
# The reported lines and the chosen layout, against the JAX session's
# ---------------------------------------------------------------------------

# opens the reference's session for each case on 4 forced host devices
# (open() resolves the plan and builds the mesh; no step runs) and
# prints each case's log lines and layout as JSON
_JAX_SESSIONS = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from repro.runtime import EdgeSession, RunSpec
    cases, out = json.loads(sys.argv[1]), {}
    for name, kw in cases.items():
        lines = []
        s = EdgeSession(RunSpec(**kw), log=lines.append).open()
        part = s.partition
        out[name] = {"lines": lines, "dp": s.exec_dp, "stages": s.exec_stages,
                     "n_micro": s.n_micro, "mode": s.mode(False),
                     "boundaries": list(part.boundaries) if part else None}
        s.close()
    print("JSON" + json.dumps(out))
    """)

_REPORTED = ("plan:", "note:", "edge-pool plan:")


def _reported(lines):
    return [line for line in lines if line.startswith(_REPORTED)]


def test_reported_lines_and_layouts_match_the_jax_session(tmp_path):
    saved = str(tmp_path / "auto.json")
    common = dict(reduced=True, epochs=1, steps_per_epoch=1, batch=4, seq=16)
    cases = {"auto_micro": dict(plan="auto", pool=4, micro=2, save_plan=saved),
             "auto": dict(plan="auto", pool=4),
             "auto_pool2": dict(plan="auto", pool=2),
             "pinned": dict(dp=2, stages=2),
             "pinned_report": dict(dp=1, stages=2),
             "single": dict()}
    resolved = {k: resolve_layout(RunSpec(**common, **kw)) for k, kw in cases.items()}
    resolved["auto_micro"].plan.save(saved)  # the port's plan, replayed by the reference below
    cases["replay_calibrate"] = dict(plan=saved, pool=4, calibrate=True)
    resolved["replay_calibrate"] = resolve_layout(RunSpec(**common, **cases["replay_calibrate"]))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_SESSIONS,
                          json.dumps({k: dict(common, **kw) for k, kw in cases.items()})],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.split("JSON", 1)[1])
    for name, lay in resolved.items():
        want = ref[name]
        assert list(lay.lines) == _reported(want["lines"]), name
        assert (lay.dp, lay.stages, lay.n_micro) == (want["dp"], want["stages"],
                                                     want["n_micro"]), name
        assert (list(lay.partition.boundaries) if lay.partition else None) == want["boundaries"]
    assert (resolved["auto"].dp, resolved["auto"].stages, resolved["auto"].n_micro) == (2, 2, 2)
    assert ref["auto"]["mode"] == "plan-driven dp2xpp2"
    assert any(line.startswith("note: --calibrate") for line in resolved["replay_calibrate"].lines)


# ---------------------------------------------------------------------------
# A planner-made ragged plan on 3 gloo ranks
# ---------------------------------------------------------------------------


def _plan5p():
    """The 5-period config of the reference's ragged test, registered in
    the port (the rank processes call this too)."""
    base = get_arch("internlm2-1.8b").reduced()
    return register(dataclasses.replace(base, name="plan5p", n_layers=5 * base.period))


def _ragged_plan(cfg):
    """The reference test's planner-made ragged plan: heterogeneous
    speeds and memory too tight for one device (half the weights and
    adapter state each) force an uneven 3-stage split of 5 periods."""
    pc = P.period_costs(cfg, "pac", seq_len=S)
    need = sum(c.param_bytes + 2 * c.trainable_bytes for c in pc)
    env = [dataclasses.replace(d, memory_bytes=need * 0.5)
           for d in (P.JETSON_NANO_L, P.JETSON_TX2_H, P.JETSON_NANO_H)]
    return P.HybridParallelismPlanner(pc, env, B, 2).plan(max_stages=3)


def _session_spec(**kw):
    return RunSpec(arch="plan5p", epochs=2, steps_per_epoch=2, batch=B, seq=S, quant=8,
                   cache_compress="int8", kernels="cuda", seed=0, **kw)


class _Steps(RunHooks):
    def __init__(self):
        self.events = []

    def on_step(self, session, event):
        self.events.append((event.loss, event.mode))


def _ragged_rank(inp, partition, spec, layout):
    """The step against the reference, then a whole session replaying the plan."""
    cfg = _plan5p()
    mesh = EdgeMesh(1, 3, device="cpu")
    loss, grads, acts = steps.pipeline_pac_loss_and_grads(
        bridge.to_torch(inp["bp"]), bridge.to_torch(inp["ap"]),
        {k: torch.from_numpy(np.array(v)) for k, v in inp["batch"].items()}, cfg=cfg,
        mesh=mesh, n_micro=partition.n_micro, r=R, partition=partition)
    mesh.close()
    out = {"loss": float(loss), "grads": bridge.to_numpy(grads), "acts": bridge.to_numpy(acts)}
    hook = _Steps()
    with EdgeSession(spec, device="cpu", layout=layout) as s:
        EpochRunner(s, hooks=[hook]).run()
        out["periods"], out["mask"] = s.backbone["periods"], s.backbone.get("mask")
    out["steps"] = hook.events
    return out


def _jax_ragged_reference():
    """The reference's single-device loss, gradients and taps on the
    5-period config (the reference's ragged test's inputs)."""
    import jax

    from repro.core import steps as jax_steps
    from repro.core.parallel_adapters import init_adapter
    from repro.models import backbone as bb

    base = jax_arch("internlm2-1.8b").reduced()
    cfg = dataclasses.replace(base, name="plan5p", n_layers=5 * base.period)
    bp = bb.init_backbone(jax.random.PRNGKey(0), cfg)
    ap = init_adapter(jax.random.PRNGKey(1), cfg, r=R)
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, cfg.vocab),
             "labels": jax.random.randint(jax.random.PRNGKey(3), (B, S), 0, cfg.vocab)}
    loss, grads = jax.value_and_grad(
        lambda a: jax_steps.pac_loss_fn(a, bp, cfg, batch, r=R))(ap)
    bf, taps, b0, _ = bb.backbone_forward(bp, cfg, batch, collect_taps=True, return_inputs=True)
    inp = jax.tree.map(np.asarray, {"bp": bp, "ap": ap, "batch": batch})
    return inp, jax.tree.map(np.asarray, {"loss": loss, "grads": grads, "acts": (b0, taps, bf)})


@pytest.fixture
def plan5p(monkeypatch):
    cfg = _plan5p()
    monkeypatch.setitem(configs_base._REGISTRY, "plan5p", cfg)  # removed again after the test
    return cfg


def _max_diff(a, b) -> float:
    la, lb = tree_leaves(bridge.to_torch(a)), tree_leaves(bridge.to_torch(b))
    assert len(la) == len(lb)
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(la, lb))


def test_ragged_plan_on_three_ranks_matches_the_reference(plan5p, tmp_path):
    plan = _ragged_plan(plan5p)
    part = plan.stage_partition()
    jcfg = dataclasses.replace(jax_arch("internlm2-1.8b").reduced(), name="plan5p",
                               n_layers=5 * plan5p.period)
    jpc = J.period_costs(jcfg, "pac", seq_len=S)
    need = sum(c.param_bytes + 2 * c.trainable_bytes for c in jpc)
    jenv = [dataclasses.replace(d, memory_bytes=need * 0.5)
            for d in (J.JETSON_NANO_L, J.JETSON_TX2_H, J.JETSON_NANO_H)]
    ref_part = J.HybridParallelismPlanner(jpc, jenv, B, 2).plan(max_stages=3).stage_partition()
    assert dataclasses.asdict(part) == dataclasses.asdict(ref_part)
    assert part.n_stages == 3 and not part.is_uniform, part

    spec = _session_spec(plan=plan.save(str(tmp_path / "ragged.json")), pool=3)
    layout = resolve_layout(spec)
    assert (layout.dp, layout.stages, layout.n_micro) == (1, 3, 2)
    inp, ref = _jax_ragged_reference()
    ranks = spawn(_ragged_rank, 1, 3, "cpu", args=(inp, part, spec, layout.to_json()),
                  timeout=GLOO_TIMEOUT, deadline=DEADLINE)

    got = ranks[0]
    assert abs(got["loss"] - float(ref["loss"])) < 1e-4
    assert _max_diff(got["grads"], ref["grads"]) < 1e-4
    b0, taps, bf = got["acts"]
    assert taps.shape == ref["acts"][1].shape == (5, B, S, 256)
    assert np.abs(taps - ref["acts"][1]).max() < 1e-4
    assert np.abs(bf - ref["acts"][2]).max() < 1e-4
    assert np.abs(b0 - ref["acts"][0]).max() < 1e-6
    assert all(r["loss"] == got["loss"] for r in ranks)

    # the session's replay: each rank holds its stage's periods, padded and
    # masked to the longest stage, and the run follows the single process's
    bounds = part.boundaries
    assert [r["periods"] for r in ranks] == [(bounds[i], bounds[i + 1]) for i in range(3)]
    assert [r["mask"] for r in ranks] == list(part.masks())
    hook = _Steps()
    with EdgeSession(_session_spec(), device="cpu") as s:
        EpochRunner(s, hooks=[hook]).run()
    modes = [m for _, m in ranks[0]["steps"]]
    assert modes == ["plan-driven dp1xpp3"] * 2 + ["cached pure-dp"] * 2
    assert all(r["steps"] == ranks[0]["steps"] for r in ranks)
    for (loss, _), (want, _) in zip(ranks[0]["steps"], hook.events):
        assert abs(loss - want) < 1e-4


# ---------------------------------------------------------------------------
# The trainer CLI
# ---------------------------------------------------------------------------


def _cli(cwd, *flags):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--epochs", "2", "--steps-per-epoch", "2", "--batch", "4", "--seq", "16", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(cwd))


def _done(proc) -> str:
    out, err = proc.communicate(timeout=DEADLINE)
    assert proc.returncode == 0, err[-3000:]
    return out


def _epochs(out):
    return [line.split(" time=")[0] for line in out.splitlines() if line.startswith("epoch ")]


def test_cli_plan_auto_runs_the_planned_mesh_and_replays(tmp_path):
    """``--plan auto`` executes dp=2 x pp=2 with ``--dp 2 --stages 2``'s
    losses (a uniform plan takes the even split's code), and the plan it
    saves replays to the same losses."""
    auto = _cli(tmp_path, "--plan", "auto", "--pool", "4", "--micro", "2",
                "--save-plan", "plan.json")
    pinned = _cli(tmp_path, "--dp", "2", "--stages", "2")
    out_auto, out_pinned = _done(auto), _done(pinned)
    assert "mesh: plan-driven dp=2×pp=2 on 4 devices, 2 micro-batches" in out_auto
    assert "(plan-driven dp2xpp2)" in out_auto and "(cached pure-dp)" in out_auto
    assert "plan: 2 stages" in out_auto and "plan saved: plan.json" in out_auto
    assert (tmp_path / "plan.json").exists()
    assert len(_epochs(out_auto)) == 2
    assert ([e.split(" (")[0] for e in _epochs(out_auto)]
            == [e.split(" (")[0] for e in _epochs(out_pinned)])
    replay = _done(_cli(tmp_path, "--plan", "plan.json", "--pool", "4"))
    assert "mesh: plan-driven dp=2×pp=2" in replay
    assert _epochs(replay) == _epochs(out_auto)
    assert re.search(r"plan: 2 stages, minibatch latency", replay)
