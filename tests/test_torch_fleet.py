"""The port's fleet (``repro_torch.fleet``, ``repro_torch.launch.fleet``)
against the reference's ``repro.fleet``, on the CPU.

* Twins of ``tests/test_fleet.py``'s tier-1 tests at its reduced spec
  (on the port's default ``cuda`` OpSet, whose wrappers compute their
  plain versions on CPU tensors, with the card's int8 cache, so the
  elastic step slices ``QTensor`` entries): the clock, fault plans, the
  pool, ``assign_chunks``, ``slice_cached``, placement invariance, the
  kill, the straggler and the preemption through disk, each equal to
  the fault-free run bit for bit, rejection, the scheduler's invariants,
  the snapshot round trip, ``RunSpec.replace`` and the refusal of
  distributed specs.
* Across the packages: ``FaultPlan.random`` and the plan JSON;
  ``assign_chunks`` and ``slice_cached``; the scheduler's tick records
  under random fault plans with the reference's no-JAX ``StubJob``;
  ``plan_shares``; ``plan(available=)``.
* A fleet run with the JAX session's backbone and adapter bridged in
  after ``open()`` against the JAX fleet run (``kernels="ref"``).
* The CLI in process, and the refusals: no card and no ``device="cpu"``
  raises; importing the fleet leaves JAX unloaded.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from _propcheck import given, settings, strategies as st
from test_fleet import StubJob

import repro.fleet as jfleet
import repro_torch.fleet as tfleet
from repro.core.planner import HybridParallelismPlanner as JaxPlanner
from repro.core.planner import model_layer_costs as jax_layer_costs
from repro.configs import get_arch as jax_get_arch
from repro.runtime import RunSpec as JaxSpec
from repro_torch import bridge
from repro_torch.checkpoint import tree_fingerprint
from repro_torch.configs import get_arch
from repro_torch.core.planner import (
    JETSON_NANO_H,
    JETSON_NANO_L,
    JETSON_TX2_H,
    HybridParallelismPlanner,
    model_layer_costs,
)
from repro_torch.core.quantization import QTensor, tree_leaves
from repro_torch.fleet import (
    DeviceMember,
    DevicePool,
    ElasticDpRunner,
    FaultPlan,
    FleetEvent,
    FleetScheduler,
    ScriptedEvents,
    SessionJob,
    SimClock,
    assign_chunks,
    slice_cached,
)
from repro_torch.launch import fleet as fleet_cli
from repro_torch.optim import adamw_init
from repro_torch.runtime import RunSpec, RunSpecError

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]

# the reference's SPEC (tests/test_fleet.py:52) with the card's int8 cache
SPEC = RunSpec(arch="internlm2-1.8b", reduced=True, epochs=3, steps_per_epoch=2, batch=4,
               seq=16, r=4, lr=1e-2, cache_compress="int8")


def _pool(n=3, timeout=1.5, **kw):
    return DevicePool([DeviceMember(f"dev{i}") for i in range(n)], clock=SimClock(),
                      heartbeat_timeout=timeout, device="cpu", **kw)


def _job(name="alice", spec=SPEC, **kw):
    return SessionJob(name, spec, device="cpu", **kw)


def _run(events=None, jobs=None, pool=None, **kw):
    sched = FleetScheduler(pool if pool is not None else _pool(), events=events, **kw)
    jobs = jobs if jobs is not None else [_job()]
    for j in jobs:
        sched.submit(j)
    report = sched.run()
    return sched, report, jobs


@pytest.fixture(scope="module")
def baseline():
    """The fault-free run every fault scenario must match bit for bit."""
    _, report, (job,) = _run()
    return SimpleNamespace(losses=report.losses("alice"),
                           fingerprint=tree_fingerprint(job.session.adapter), job=job)


# ---------------------------------------------------------------------------
# clock / events / pool units
# ---------------------------------------------------------------------------


def test_sim_clock():
    c = SimClock(start=2.0)
    assert c.now() == 2.0
    assert c.advance(1.5) == 3.5
    with pytest.raises(ValueError):
        c.advance(-1.0)


def test_fault_plan_validation_and_roundtrip(tmp_path):
    with pytest.raises(ValueError):
        FleetEvent(0, "explode", device="d0")
    with pytest.raises(ValueError):
        FleetEvent(0, "submit")
    with pytest.raises(ValueError):
        FleetEvent(0, "kill")
    with pytest.raises(ValueError):
        FleetEvent(0, "slow", device="d0", factor=0.0)
    plan = FaultPlan([FleetEvent(5, "kill", device="d1"), FleetEvent(2, "submit", job="j0"),
                      FleetEvent(5, "join", device="d9")])
    assert [e.kind for e in plan.events] == ["submit", "join", "kill"]
    assert plan.last_tick == 5
    assert [e.kind for e in plan.at(5)] == ["join", "kill"]
    path = tmp_path / "faults.json"
    plan.save(str(path))
    assert FaultPlan.load(str(path)).events == plan.events


def test_fault_plan_random_is_seed_deterministic():
    a = FaultPlan.random(7, ["d0", "d1"], jobs=["j0"])
    assert a.events == FaultPlan.random(7, ["d0", "d1"], jobs=["j0"]).events
    assert a.events != FaultPlan.random(8, ["d0", "d1"], jobs=["j0"]).events


def test_scripted_events_deliver_each_tick_once():
    ev = ScriptedEvents(FaultPlan([FleetEvent(1, "kill", device="d0")]))
    assert not ev.exhausted
    assert ev.poll(0) == []
    assert len(ev.poll(1)) == 1
    assert ev.poll(1) == []
    assert ev.exhausted


def test_pool_kill_detected_after_timeout():
    clock = SimClock()
    pool = DevicePool([DeviceMember("a"), DeviceMember("b")], clock=clock,
                      heartbeat_timeout=1.5, device="cpu")
    pool.kill("a")
    for tick in range(4):
        pool.heartbeat_all()
        lost = pool.check_timeouts()
        if lost:
            assert lost == ["a"] and tick == 2
            break
        clock.advance(1.0)
    else:
        pytest.fail("kill never detected")
    assert pool.alive() == ["b"]


def test_pool_slots_recycle_and_speed_scaling():
    pool = DevicePool([DeviceMember("a"), DeviceMember("b")], bind_devices=True, capacity=2,
                      device="cpu")
    assert [pool.member(n).slot for n in ("a", "b")] == [0, 1]
    with pytest.raises(ValueError):
        pool.add(DeviceMember("c"))
    gen = pool.generation
    pool.remove("a")
    pool.add(DeviceMember("c"))
    assert pool.member("c").slot == 0
    assert pool.generation == gen + 2
    pool.mark_slow("c", 0.5)
    assert pool.member("c").effective_profile().flops == pytest.approx(
        0.5 * pool.member("b").effective_profile().flops)
    assert pool.profiles(["b"])[0] == pool.member("b").profile


def test_torch_device_rule(monkeypatch):
    """A bound member runs on ``cuda:{slot}`` when that card exists and
    the base device is a card; every other member on the base device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    pool = DevicePool([DeviceMember(n) for n in "abc"], bind_devices=True, device="cuda:0")
    assert [pool.torch_device(n) for n in "abc"] == [torch.device("cuda", 0),
                                                      torch.device("cuda", 1),
                                                      torch.device("cuda", 0)]
    logical = DevicePool([DeviceMember(n) for n in "ab"], device="cuda:0")
    assert {logical.torch_device(n) for n in "ab"} == {torch.device("cuda", 0)}
    cpu = DevicePool([DeviceMember(n) for n in "ab"], bind_devices=True, device="cpu")
    assert {cpu.torch_device(n) for n in "ab"} == {torch.device("cpu")}


# ---------------------------------------------------------------------------
# elastic primitives, and each against the reference's
# ---------------------------------------------------------------------------


@settings(max_examples=20, deadline=None)
@given(n_chunks=st.integers(0, 32), n_members=st.integers(1, 6), seed=st.integers(0, 99))
def test_assign_chunks_covers_and_equals_the_reference(n_chunks, n_members, seed):
    weights = np.random.RandomState(seed).uniform(0.1, 4.0, n_members).tolist()
    counts = assign_chunks(n_chunks, n_members, weights)
    assert counts == jfleet.assign_chunks(n_chunks, n_members, weights)
    assert sum(counts) == n_chunks and all(c >= 0 for c in counts)
    if n_chunks >= n_members:
        for i in range(n_members):
            for j in range(n_members):
                if weights[i] > 2.0 * weights[j]:
                    assert counts[i] >= counts[j]
    assert assign_chunks(n_chunks, n_members) == jfleet.assign_chunks(n_chunks, n_members)


def test_slice_cached_axes_and_storage_form():
    """Taps slice on axis 1, the rest on axis 0; an int8 QTensor entry
    slices its payload and scales alike and keeps its layout — the
    reference's slice of the ``{"q", "scale"}`` form, value for value."""
    rng = np.random.default_rng(0)
    b0 = rng.standard_normal((4, 3, 2)).astype(np.float32)
    q = rng.integers(-127, 128, (2, 4, 3, 256), dtype=np.int8)
    scale = rng.random((2, 4, 3, 2)).astype(np.float32)
    labels = np.arange(12, dtype=np.int32).reshape(4, 3)
    want = jfleet.slice_cached({"b0": b0, "taps": {"q": q, "scale": scale}, "b_final": b0,
                                "labels": labels}, 1, 3)
    cached = {"b0": torch.from_numpy(b0),
              "taps": QTensor(torch.from_numpy(q), torch.from_numpy(scale), 8, 128, 250),
              "b_final": torch.from_numpy(b0), "labels": torch.from_numpy(labels)}
    piece = slice_cached(cached, 1, 3)
    taps = piece["taps"]
    assert isinstance(taps, QTensor) and (taps.bits, taps.block, taps.orig_last) == (8, 128, 250)
    assert taps.q.shape == (2, 2, 3, 256) and taps.scale.shape == (2, 2, 3, 2)
    np.testing.assert_array_equal(taps.q.numpy(), np.asarray(want["taps"]["q"]))
    np.testing.assert_array_equal(taps.scale.numpy(), np.asarray(want["taps"]["scale"]))
    for k in ("b0", "b_final", "labels"):
        np.testing.assert_array_equal(piece[k].numpy(), np.asarray(want[k]))
    assert piece["b0"].shape == (2, 3, 2)
    # numpy arrays slice alike
    np.testing.assert_array_equal(slice_cached({"taps": q}, 1, 3)["taps"], q[:, 1:3])


def _cached_batch(job, epoch=1):
    s = job.session
    ids = s.pipe.epoch_order(epoch)[0]
    hit = s.cache.get_batch(ids, with_final=True, dtype=None, compressed=True)
    assert hit is not None
    b0, taps, bf = hit
    assert isinstance(taps, QTensor)            # the int8 storage form, as on the card
    return {"b0": b0, "taps": taps, "b_final": bf,
            "labels": torch.from_numpy(s.corpus.batch(ids)["labels"])}


def test_elastic_step_is_placement_invariant(baseline):
    """The same cached batch stepped under 1-, 2- and 3-member
    placements gives bit-identical loss, adapter and optimizer."""
    s, runner = baseline.job.session, baseline.job._elastic
    cached = _cached_batch(baseline.job)
    outs = []
    for placement in ([("a", None, 4)], [("a", None, 3), ("b", None, 1)],
                      [("a", None, 1), ("b", None, 1), ("c", "cpu", 2)]):
        runner.reshard([(n, d) for n, d, _ in placement])
        loss, adapter, opt = runner.step(s.adapter, s.opt, cached, placement)
        outs.append((loss, tree_fingerprint(adapter), tree_fingerprint(opt)))
    assert outs[0] == outs[1] == outs[2]
    with pytest.raises(ValueError):
        runner.step(s.adapter, s.opt, cached, [("a", None, 3)])


def test_elastic_step_is_the_cached_step_reassociated(baseline):
    """Chunked, the step is the single-device cached step up to the f32
    sums' order: loss and updated adapter within a few f32 steps."""
    from repro_torch.core.steps import pac_cached_train_step

    s, runner = baseline.job.session, baseline.job._elastic
    cached = _cached_batch(baseline.job)
    loss, adapter, _ = runner.step(s.adapter, s.opt, cached, [("a", None, 4)])
    want_loss, want_adapter, _ = pac_cached_train_step(
        s.backbone, s.adapter, s.opt, cached, cfg=s.cfg, r=SPEC.r, lr=SPEC.lr,
        kernel_impl=SPEC.kernels)
    assert abs(loss - float(want_loss)) <= 1e-5
    assert max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(adapter), tree_leaves(want_adapter))) <= 1e-5


# ---------------------------------------------------------------------------
# planner: the incremental subset re-plan, and the shares the scheduler prices
# ---------------------------------------------------------------------------


def test_planner_available_subset_matches_fresh_planner_and_the_reference():
    costs = model_layer_costs(get_arch("internlm2-1.8b"), "pac", seq_len=64)
    jcosts = jax_layer_costs(jax_get_arch("internlm2-1.8b"), "pac", seq_len=64)
    devices = [JETSON_NANO_H, JETSON_NANO_L, JETSON_TX2_H, JETSON_NANO_L]
    planner = HybridParallelismPlanner(costs, devices, 4, 4)
    full = planner.plan()
    h_entries = len(planner._h_cache)
    sub = planner.plan(available=[0, 2, 3])
    fresh = HybridParallelismPlanner(costs, [devices[0], devices[2], devices[3]], 4, 4).plan()
    assert sub.minibatch_latency == pytest.approx(fresh.minibatch_latency)
    assert sub.n_stages == fresh.n_stages
    assert [s.samples_per_device for s in sub.stages] == \
        [s.samples_per_device for s in fresh.stages]
    assert len(planner._h_cache) >= h_entries
    assert planner.plan().minibatch_latency == pytest.approx(full.minibatch_latency)
    from repro.core import planner as jplanner

    jdev = {d.name: getattr(jplanner, n) for n, d in (
        ("JETSON_NANO_H", JETSON_NANO_H), ("JETSON_NANO_L", JETSON_NANO_L),
        ("JETSON_TX2_H", JETSON_TX2_H))}
    jp = JaxPlanner(jcosts, [jdev[d.name] for d in devices], 4, 4)
    jp.plan()
    jsub = jp.plan(available=[0, 2, 3])
    assert sub.minibatch_latency == jsub.minibatch_latency
    assert [s.samples_per_device for s in sub.stages] == \
        [tuple(s.samples_per_device) for s in jsub.stages]
    for bad in ([0, 0], [99], []):
        with pytest.raises(ValueError):
            planner.plan(available=bad)


@pytest.mark.parametrize("quant", [None, 8])
def test_plan_shares_equal_the_reference(quant):
    """The Eq. (4) chunk dispatch the scheduler prices, over fast, slow
    and straggling members: the reference's shares, or its None."""
    spec = SPEC.replace(quant=quant)
    job = _job(spec=spec)
    jjob = jfleet.SessionJob("alice", JaxSpec(**{k: v for k, v in spec.to_dict().items()
                                                 if k != "kernels"}))
    pool = _pool(4)
    jpool = jfleet.DevicePool([jfleet.DeviceMember(f"dev{i}") for i in range(4)],
                              clock=jfleet.SimClock())
    for name, factor in (("dev1", 0.25), ("dev3", 0.5)):
        pool.mark_slow(name, factor)
        jpool.mark_slow(name, factor)
    for names in (["dev0"], ["dev0", "dev2"], ["dev0", "dev1"], ["dev0", "dev1", "dev2", "dev3"]):
        got = job.plan_shares(pool.profiles(names))
        assert got == jjob.plan_shares(jpool.profiles(names))
        assert got is None or sum(got) == job.n_chunks


# ---------------------------------------------------------------------------
# the acceptance scenarios (in-process, logical members)
# ---------------------------------------------------------------------------


def test_kill_mid_cached_epoch_matches_fault_free_exactly(baseline):
    events = ScriptedEvents(FaultPlan([FleetEvent(3, "kill", device="dev1")]))
    _, report, (job,) = _run(events=events)
    assert report.losses("alice") == baseline.losses
    assert tree_fingerprint(job.session.adapter) == baseline.fingerprint
    assert job.state == "done"
    assert job.forward_steps == SPEC.steps_per_epoch
    assert job.reshards >= 1
    lost_at = next(r.tick for r in report.ticks if "dev1" in r.lost)
    for rec in report.ticks:
        if rec.tick >= lost_at:
            assert all("dev1" not in d for d in rec.placements.values())


def test_straggler_deweighted_by_replan_losses_unchanged(baseline):
    events = ScriptedEvents(FaultPlan([FleetEvent(3, "slow", device="dev0", factor=0.25)]))
    _, report, (job,) = _run(events=events)
    assert report.losses("alice") == baseline.losses
    assert tree_fingerprint(job.session.adapter) == baseline.fingerprint

    def dev0_share(rec):
        return dict(zip(rec.placements["alice"], rec.shares["alice"])).get("dev0", 0)

    before = [dev0_share(r) for r in report.ticks if r.tick < 3 and "alice" in r.shares]
    after = [dev0_share(r) for r in report.ticks if r.tick > 3 and "alice" in r.shares]
    assert after and max(after) < min(before)
    assert all("dev0" in r.placements["alice"] for r in report.ticks if "alice" in r.placements)


def test_preempt_resume_is_bit_identical(baseline, tmp_path):
    sched = FleetScheduler(_pool(1), quantum=2, snapshot_dir=str(tmp_path))
    alice, bob = _job("alice"), _job("bob", SPEC.replace(seed=1))
    sched.submit(alice)
    sched.submit(bob)
    report = sched.run()
    assert "alice" in [n for rec in report.ticks for n in rec.preempted]
    assert "alice.ckpt" in os.listdir(str(tmp_path))
    assert alice.state == "done" and bob.state == "done"
    assert report.losses("alice") == baseline.losses
    assert tree_fingerprint(alice.session.adapter) == baseline.fingerprint
    assert report.losses("bob") != baseline.losses


def test_rejection_when_pool_can_never_fit():
    pool = DevicePool([DeviceMember("a")], clock=SimClock(), capacity=1, device="cpu")
    sched = FleetScheduler(pool)
    job = _job()
    job.min_devices = 2
    assert not sched.submit(job)
    assert job.state == "rejected"
    assert sched.report.rejected == ["alice"]
    assert sched.quiescent


# ---------------------------------------------------------------------------
# scheduler invariants, and its records against the reference's
# ---------------------------------------------------------------------------


def _stub_run(pkg, seed, quantum, bind=False):
    devices = [f"d{i}" for i in range(6)]
    plan = pkg.FaultPlan.random(seed, devices, n_events=10, max_tick=12, jobs=["j0", "j1", "j2"])
    kw = {"device": "cpu"} if pkg is tfleet else {}
    pool = pkg.DevicePool([pkg.DeviceMember(d) for d in devices[:3]], clock=pkg.SimClock(),
                          heartbeat_timeout=1.5, bind_devices=bind, **kw)
    sched = pkg.FleetScheduler(pool, events=pkg.ScriptedEvents(plan), quantum=quantum)
    jobs = [StubJob(f"j{i}") for i in range(3)]
    for j in jobs:
        sched.register(j)
    sched.run(max_ticks=60)
    return sched, pool, plan, jobs


def _records(report):
    return [(r.tick, [dataclasses.asdict(e) for e in r.events], r.lost, r.preempted,
             r.placements, r.shares, r.steps, r.queued) for r in report.ticks]


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), quantum=st.sampled_from([None, 2, 3]))
def test_scheduler_invariants_under_random_fault_plans(seed, quantum):
    sched, pool, plan, jobs = _stub_run(tfleet, seed, quantum)
    submitted = [j for j in jobs
                 if any(e.kind == "submit" and e.job == j.name for e in plan.events)]
    for rec in sched.report.ticks:
        placed = [d for devs in rec.placements.values() for d in devs]
        assert len(placed) == len(set(placed)), rec.placements
        assert not (set(rec.steps) & set(rec.queued))
    if any(not j.done for j in submitted):
        if len(pool) == 0:
            pool.add(DeviceMember("rescue"))
        sched.run(max_ticks=60)
    for j in submitted:
        assert j.done or j.state == "rejected", (j.name, j.state, j.steps_left)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), quantum=st.sampled_from([None, 2, 3]),
       bind=st.booleans())
def test_scheduler_ticks_equal_the_reference(seed, quantum, bind):
    """The same random fault plan and quantum, the reference's no-JAX
    stub jobs: every tick's events, losses, placements, shares, lost,
    preempted and queued equal the JAX scheduler's."""
    port, _, _, _ = _stub_run(tfleet, seed, quantum, bind)
    ref, _, _, _ = _stub_run(jfleet, seed, quantum, bind)
    assert _records(port.report) == _records(ref.report)
    assert port.report.rejected == ref.report.rejected


def test_multi_job_fairness_no_starvation():
    pool = DevicePool([DeviceMember("a"), DeviceMember("b")], clock=SimClock(), device="cpu")
    sched = FleetScheduler(pool, quantum=2)
    jobs = [StubJob(f"j{i}", steps=6) for i in range(3)]
    for j in jobs:
        sched.submit(j)
    report = sched.run(max_ticks=60)
    assert all(j.done for j in jobs)
    first = [report.first_step_tick(j.name) for j in jobs]
    assert None not in first and max(first) < 6
    assert any(rec.preempted for rec in report.ticks)


def test_pool_slot_conservation_under_random_plans():
    for seed in range(25):
        plan = FaultPlan.random(seed, [f"d{i}" for i in range(6)], n_events=12, max_tick=10)
        pool = DevicePool([DeviceMember("d0"), DeviceMember("d1")], bind_devices=True,
                          clock=SimClock(), heartbeat_timeout=1.5, device="cpu")
        for tick in range(12):
            for e in plan.at(tick):
                if e.kind == "join" and e.device not in pool:
                    pool.add(DeviceMember(e.device))
                elif e.kind == "leave" and e.device in pool:
                    pool.remove(e.device)
                elif e.kind == "kill" and e.device in pool:
                    pool.kill(e.device)
                elif e.kind == "slow" and e.device in pool:
                    pool.mark_slow(e.device, e.factor)
            pool.heartbeat_all()
            pool.check_timeouts()
            pool.clock.advance(1.0)
            slots = [pool.member(n).slot for n in pool.alive()]
            assert len(slots) == len(set(slots)), slots
            assert pool._next_slot <= 6 + 2
            assert not (set(pool._free_slots) & set(slots))


# ---------------------------------------------------------------------------
# fault plans across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123, 9999])
def test_fault_plans_cross_the_packages(seed, tmp_path):
    """The same seed draws the same script in both packages, and each
    package's plan file loads in the other."""
    kw = dict(n_events=12, max_tick=10, jobs=["j0", "j1"])
    ours = FaultPlan.random(seed, ["d0", "d1", "d2"], **kw)
    theirs = jfleet.FaultPlan.random(seed, ["d0", "d1", "d2"], **kw)
    assert [dataclasses.asdict(e) for e in ours.events] == \
        [dataclasses.asdict(e) for e in theirs.events]
    assert ours.to_json() == theirs.to_json()
    ours.save(str(tmp_path / "port.json"))
    theirs.save(str(tmp_path / "jax.json"))
    assert jfleet.FaultPlan.load(str(tmp_path / "port.json")).events == theirs.events
    assert FaultPlan.load(str(tmp_path / "jax.json")).events == ours.events


# ---------------------------------------------------------------------------
# session seams
# ---------------------------------------------------------------------------


def test_session_snapshot_restore_roundtrip(baseline, tmp_path):
    s = baseline.job.session
    snap = s.snapshot(extra={"epoch": 2, "index": 1})
    path = s.save_snapshot(str(tmp_path / "snap.ckpt"), extra={"epoch": 2, "index": 1})
    fp = tree_fingerprint(s.adapter)
    assert s.restore_snapshot(path) == {"epoch": 2, "index": 1}
    assert tree_fingerprint(s.adapter) == fp
    assert s.restore(snap) == {"epoch": 2, "index": 1}
    with pytest.raises(RunSpecError):
        s.restore({"adapter": s.adapter, "opt": s.opt, "config": "other-arch"})


def test_run_spec_replace_validates():
    assert SPEC.replace(seed=5).seed == 5
    assert SPEC.replace(seed=5) != SPEC
    with pytest.raises(RunSpecError):
        SPEC.replace(batch=0)


def test_session_job_rejects_distributed_specs():
    with pytest.raises(RunSpecError):
        _job("x", SPEC.replace(dp=2, stages=2, batch=4, seq=16))
    with pytest.raises(RunSpecError):
        _job("x", SPEC.replace(plan="auto"))
    with pytest.raises(RunSpecError):
        _job("x", SPEC, chunk=3)


# ---------------------------------------------------------------------------
# the fleet with the reference's weights, against the reference's fleet
# ---------------------------------------------------------------------------

BRIDGE_KW = dict(reduced=True, epochs=3, steps_per_epoch=2, batch=4, seq=16, r=4, lr=1e-2,
                 quant=8)
BRIDGE_PLAN = [("kill", 3, "dev1")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_fleet_runs():
    """The JAX fleet run (``kernels="ref"``, an INT8 backbone, three
    members, dev1 killed at tick 3) per cache policy: its per-step
    losses, tick records and the weights it drew."""
    out = {}
    for compress in ("f32", "int8"):
        job = jfleet.SessionJob("alice", JaxSpec(**BRIDGE_KW, cache_compress=compress,
                                                 kernels="ref")).open()
        weights = (_np(job.session.backbone), _np(job.session.adapter))
        pool = jfleet.DevicePool([jfleet.DeviceMember(f"dev{i}") for i in range(3)],
                                 clock=jfleet.SimClock(), heartbeat_timeout=1.5)
        plan = jfleet.FaultPlan([jfleet.FleetEvent(t, k, device=d) for k, t, d in BRIDGE_PLAN])
        sched = jfleet.FleetScheduler(pool, events=jfleet.ScriptedEvents(plan))
        sched.submit(job)
        report = sched.run()
        out[compress] = SimpleNamespace(losses=report.losses("alice"), weights=weights,
                                        records=_records(report), job=job)
    return out


@pytest.mark.parametrize("compress,kernels", [("f32", "ref"), ("f32", "cuda"),
                                              ("int8", "ref"), ("int8", "cuda")])
def test_bridged_fleet_run_matches_the_jax_fleet(jax_fleet_runs, compress, kernels):
    """The port's fleet, with the JAX session's backbone and adapter
    bridged in after ``open()``, under the same fault plan: the same
    tick records (placements, shares, lost) and modes, and every step's
    loss within the tolerances of ``tests/test_torch_train.py``'s
    bridged run — 5e-4 for f32 entries or the ``ref`` OpSet, 5e-2 for
    int8 entries under ``cuda``, where epoch 0 trains on taps quantized
    at the tap site and the reference's ``ref`` path on f32 taps. The
    int8 path is held against JAX's ``ref`` oracle, not its Pallas
    kernels (ROADMAP C1)."""
    want = jax_fleet_runs[compress]
    job = _job(spec=RunSpec(**BRIDGE_KW, cache_compress=compress, kernels=kernels)).open()
    s = job.session
    s.backbone = bridge.to_torch(want.weights[0])
    s.adapter = bridge.to_torch(want.weights[1])
    s.opt = adamw_init(s.adapter)
    job._elastic.backbone = s.backbone
    pool = _pool(3)
    plan = FaultPlan([FleetEvent(t, k, device=d) for k, t, d in BRIDGE_PLAN])
    sched = FleetScheduler(pool, events=ScriptedEvents(plan))
    sched.submit(job)
    report = sched.run()
    got = report.losses("alice")
    strip = [rec[:6] + rec[7:] for rec in _records(report)]      # all but the losses
    assert strip == [rec[:6] + rec[7:] for rec in want.records]
    assert [e.mode for e in job.events] == [e.mode for e in want.job.events]
    assert (job.forward_steps, job.cached_steps, job.reshards) == (
        want.job.forward_steps, want.job.cached_steps, want.job.reshards)
    tol = 5e-2 if (compress == "int8" and kernels == "cuda") else 5e-4
    diffs = [abs(a - b) for a, b in zip(got, want.losses)]
    assert len(got) == len(want.losses) == 6 and max(diffs) < tol, (got, want.losses)
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# the CLI and the refusals
# ---------------------------------------------------------------------------


def test_cli_on_the_cpu(tmp_path, capsys):
    plan = tmp_path / "faults.json"
    fleet_cli.main(["--simulate", "--device", "cpu", "--reduced", "--pool", "3", "--jobs", "2",
                    "--kill-tick", "3", "--save-fault-plan", str(plan)])
    out = capsys.readouterr().out
    assert "job0: done" in out and "job1: done" in out
    assert "fleet: 8 ticks, 2 devices remain, 0 rejected" in out
    loaded = jfleet.FaultPlan.load(str(plan))
    assert [dataclasses.asdict(e) for e in loaded.events] == [
        {"tick": 0, "kind": "submit", "device": None, "job": "job0", "factor": 1.0},
        {"tick": 2, "kind": "submit", "device": None, "job": "job1", "factor": 1.0},
        {"tick": 3, "kind": "kill", "device": "dev2", "job": None, "factor": 1.0}]


def test_no_card_refuses_instead_of_running_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SessionJob("alice", SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePool([DeviceMember("a")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticDpRunner({}, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_cli.main(["--simulate", "--reduced", "--pool", "2", "--jobs", "1"])


def test_importing_the_fleet_leaves_jax_unloaded():
    code = ("import sys, repro_torch.fleet, repro_torch.launch.fleet; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

