"""``EdgeSession.reshard``: elastic DP for a distributed session's cached
epochs, on gloo ranks on the CPU.

The twin of the reference's
``tests/test_fleet.py::test_distributed_session_reshard_dp2_to_dp1``
(reduced internlm2-1.8b at dp 2 x pp 2, 3 epochs of 2 steps of 4 x 16,
r 4) and its single-device refusal, and what the port's ranks add:

* dp 2 -> 1 before epoch 2 within ``rtol=1e-5`` of the run that does not
  shrink, epochs 0-1 bit-equal to it;
* dp 2 -> 1 -> 2: every member bit-equal in adapter and optimizer after
  every step, every step within 1e-5 of the unchanged run;
* parked ranks move no bytes; a sub-mesh of chosen ranks; a miss after
  parked hits, which hands the owner's state to the parked ranks first;
* a rank that starts to count rows (batch 6, micro 3: only the stage-0
  ranks count at dp 2 x pp 2, every rank at dp 1);
* without the cache a reshard changes nothing (every step runs on the
  spawned mesh);
* a mesh closed after two reshards holds no group and no pinned buffer,
  and a second session in the same ranks runs as the first;
* the errors, raised alike on every rank.

One spawn runs every session in turn, with a gloo timeout of 60 s and a
120 s deadline on the join.
"""

import hashlib

import numpy as np
import pytest
import torch

from repro_torch.core.quantization import tree_leaves
from repro_torch.launch.mesh import spawn
from repro_torch.launch.sharding import cached_batch_axes, rows_count
from repro_torch.runtime import EdgeSession, EpochRunner, RunHooks, RunSpec, RunSpecError

GLOO_TIMEOUT, DEADLINE = 60.0, 120.0
SPEC_KW = dict(arch="internlm2-1.8b", reduced=True, epochs=3, steps_per_epoch=2, batch=4, seq=16,
               r=4, dp=2, stages=2)
B6 = dict(batch=6, micro=3, cache_compress="int8")
# name: (spec overrides, {(epoch, step): dp, or (dp, devices), after that step;
# or "clear": the owner drops its cache, so the next epoch misses}), run in this
# order in the same ranks
RUNS = {
    "plain": ({}, {}),
    "twin": ({}, {(1, 1): 1}),
    "regrow": ({}, {(0, 1): 1, (1, 1): 2}),
    "again": ({}, {}),
    "chosen": ({}, {(0, 1): (1, [0, 3])}),
    "refill": ({}, {(0, 1): 1, (1, 1): "clear"}),
    "b6": (B6, {}),
    "b6_dp1": (B6, {(0, 1): 1}),
    "nocache": ({"use_cache": False}, {}),
    "nocache_dp1": ({"use_cache": False}, {(0, 1): 1}),
}
BYTES = ("p2p_bytes", "allreduce_bytes", "broadcast_bytes")


def _digest(*trees) -> str:
    h = hashlib.sha256()
    for t in tree_leaves(trees):
        h.update(t.detach().cpu().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class _Record(RunHooks):
    """Each step's loss, mode, state digest and mesh counters, the
    reshards of ``schedule`` after their steps, each epoch's report."""

    def __init__(self, schedule):
        self.schedule, self.steps, self.reports = schedule, [], []

    def on_step(self, session, event):
        mesh = session.mesh
        axes = cached_batch_axes(session.spec.batch, mesh)
        rec = {"loss": event.loss, "mode": event.mode, "hit": event.cache_hit,
               "digest": _digest(session.adapter, session.opt), "stats": dict(mesh.stats),
               "counts": mesh.active and rows_count(mesh, axes)}
        new = self.schedule.get((event.epoch, event.index))
        if new == "clear":
            if mesh.owner:
                session.cache.clear()
        elif new is not None:
            dp, devices = new if isinstance(new, tuple) else (new, None)
            session.reshard(dp, devices)
            rec.update(dp_after=mesh.dp, active_after=mesh.active,
                       members_after=list(mesh.members))
        rec["stats_after"] = dict(mesh.stats)
        self.steps.append(rec)

    def on_epoch_end(self, session, report):
        self.reports.append({"used_cache": report.used_cache, "mode": report.mode})


def _errors():
    """Each refusal's type and text: before ``open()``, then dp < 1,
    more ranks than the world, rank 0 not first, a repeated rank, a
    rank out of range; then a step shows the mesh still runs."""
    s = EdgeSession(RunSpec(**SPEC_KW), device="cpu")
    out = []
    try:
        s.reshard(1)
    except RuntimeError as e:
        out.append(("RuntimeError", str(e)))
    s.open()
    for dp, devices in ((0, None), (3, None), (1, [1, 0]), (1, [0, 0]), (1, [0, 4])):
        try:
            s.reshard(dp, devices)
        except RunSpecError as e:
            out.append(("RunSpecError", str(e)))
    event = s.step(next(iter(s.pipe.epoch(0))))
    s.close()
    return out, event.loss, s.mesh.dp


def _rank():
    out = {}
    for name, (kw, schedule) in RUNS.items():
        rec = _Record(schedule)
        s = EdgeSession(RunSpec(**{**SPEC_KW, **kw}), device="cpu").open()
        EpochRunner(s, hooks=[rec]).run()
        s.close()
        out[name] = {"steps": rec.steps, "reports": rec.reports,
                     "groups_left": len(s.mesh._groups), "pinned_left": len(s.mesh._pinned)}
    out["errors"] = _errors()
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(_rank, 2, 2, "cpu", timeout=GLOO_TIMEOUT, deadline=DEADLINE)


def _losses(rank, run):
    return [st["loss"] for st in rank[run]["steps"]]


def _digests(rank, run):
    return [st["digest"] for st in rank[run]["steps"]]


def test_reshard_dp2_to_dp1_matches_the_unshrunk_run(ranks):
    """The reference's gate: after ``reshard(1)`` the mesh is dp 1, epochs
    1-2 trained from the cache, the losses are finite and close to the
    run that does not shrink; epochs 0-1 are that run's bit for bit."""
    owner = ranks[0]
    twin, plain = owner["twin"], owner["plain"]
    assert twin["steps"][3]["dp_after"] == 1
    assert twin["reports"][1]["used_cache"] and twin["reports"][2]["used_cache"]
    a, b = _losses(owner, "twin"), _losses(owner, "plain")
    assert all(np.isfinite(a))
    assert np.allclose(a, b, rtol=1e-5), f"{a} vs {b}"
    for r in ranks:
        assert _losses(r, "twin")[:4] == b[:4]
        assert _digests(r, "twin")[:4] == _digests(owner, "plain")[:4]
    assert [st["mode"] for st in plain["steps"]] == ["hybrid dp2xpp2"] * 2 + ["cached pure-dp"] * 4
    assert [st["mode"] for st in twin["steps"]] == [st["mode"] for st in plain["steps"]]
    assert [st["mode"] for st in ranks[3]["twin"]["steps"][4:]] == ["parked"] * 2
    assert ranks[3]["twin"]["reports"][2]["mode"] == "parked"


def test_shrink_then_regrow_keeps_every_member_bit_equal(ranks):
    """dp 2 -> 1 after epoch 0, back to 2 after epoch 1: epoch 1's two
    members and epoch 2's four ranks hold the same adapter and optimizer
    after every step, and every step is within 1e-5 of the unchanged run."""
    owner = ranks[0]
    assert [owner["regrow"]["steps"][i]["dp_after"] for i in (1, 3)] == [1, 2]
    assert _losses(owner, "regrow")[:2] == _losses(owner, "plain")[:2]
    diffs = np.abs(np.array(_losses(owner, "regrow")) - np.array(_losses(owner, "plain")))
    assert diffs.max() <= 1e-5, diffs
    for j in range(6):
        members = ranks if j < 2 or j >= 4 else ranks[:2]
        assert len({_digests(r, "regrow")[j] for r in members}) == 1, j
        assert len({_losses(r, "regrow")[j] for r in members}) == 1, j
    for r in ranks[2:]:
        assert [st["mode"] for st in r["regrow"]["steps"]] == (
            ["hybrid dp2xpp2"] * 2 + ["parked"] * 2 + ["cached pure-dp"] * 2)
        assert all(np.isnan(_losses(r, "regrow")[2:4]))
    # the regrow handed the owner's state to the ranks that had been parked
    got = ranks[2]["regrow"]["steps"][3]
    assert got["stats_after"]["broadcast_bytes"] > got["stats"]["broadcast_bytes"]


def test_parked_ranks_move_no_bytes(ranks):
    for r in ranks[2:]:
        steps = r["regrow"]["steps"]
        for j in (2, 3):  # epoch 1, parked
            for k in BYTES:
                assert steps[j]["stats"][k] == steps[j - 1]["stats_after"][k], (r, j, k)
    for r in ranks[:2]:  # the members all-reduce in the same steps
        steps = r["regrow"]["steps"]
        assert steps[2]["stats"]["allreduce_bytes"] > steps[1]["stats_after"]["allreduce_bytes"]


def test_a_chosen_sub_mesh_runs_the_cached_steps(ranks):
    """``reshard(1, devices=[0, 3])``: rank 3 takes position 1, ranks 1
    and 2 park, and the losses stay within 1e-5 of the unchanged run."""
    assert ranks[3]["chosen"]["steps"][1]["members_after"] == [0, 3]
    assert [r["chosen"]["steps"][1]["active_after"] for r in ranks] == [True, False, False, True]
    assert _losses(ranks[3], "chosen") == _losses(ranks[0], "chosen")
    assert _digests(ranks[3], "chosen") == _digests(ranks[0], "chosen")
    assert all(np.isnan(_losses(ranks[1], "chosen")[2:]))
    diffs = np.abs(np.array(_losses(ranks[0], "chosen")) - np.array(_losses(ranks[0], "plain")))
    assert diffs.max() <= 1e-5, diffs


def test_a_miss_after_parked_hits_hands_the_owners_state_over(ranks):
    """dp 1 for epoch 1, then the owner's cache emptied: epoch 2 misses,
    so every rank runs the epoch-1 step on the spawned mesh, the parked
    ranks first taking the owner's adapter and optimizer; all four then
    hold the same state after every step."""
    for j in (4, 5):
        assert len({_digests(r, "refill")[j] for r in ranks}) == 1, j
        assert len({_losses(r, "refill")[j] for r in ranks}) == 1, j
    for r in ranks:
        assert [st["mode"] for st in r["refill"]["steps"][4:]] == ["hybrid dp2xpp2"] * 2
    got = ranks[3]["refill"]["steps"]
    assert got[4]["stats"]["broadcast_bytes"] > got[3]["stats_after"]["broadcast_bytes"]
    assert got[5]["stats"]["broadcast_bytes"] == got[4]["stats_after"]["broadcast_bytes"]


def test_a_rank_that_starts_to_count_rows(ranks):
    """Batch 6 in 3 micro-batches: at dp 2 x pp 2 only the stage-0 ranks
    count (6 % 4 != 0); at dp 1 x pp 2 both ranks do (6 % 2 == 0), so
    rank 1 runs the loss on the head it kept from ``open()``."""
    assert [st["counts"] for st in ranks[1]["b6"]["steps"][2:]] == [False] * 4
    assert [st["counts"] for st in ranks[1]["b6_dp1"]["steps"][2:]] == [True] * 4
    a, b = _losses(ranks[0], "b6_dp1"), _losses(ranks[0], "b6")
    assert a[:2] == b[:2]
    assert np.allclose(a, b, rtol=1e-5), f"{a} vs {b}"
    assert _losses(ranks[1], "b6_dp1") == a


def test_without_the_cache_a_reshard_changes_nothing(ranks):
    for r in ranks:
        assert _losses(r, "nocache_dp1") == _losses(r, "nocache")
        assert _digests(r, "nocache_dp1") == _digests(r, "nocache")
        assert [st["mode"] for st in r["nocache_dp1"]["steps"]] == ["hybrid dp2xpp2"] * 6
    assert ranks[3]["nocache_dp1"]["steps"][1]["active_after"] is False


def test_a_closed_mesh_leaves_nothing_for_the_next_session(ranks):
    """The session that resharded twice destroyed its groups and pinned
    buffers at ``close()``; the next session in the same ranks runs the
    first one's steps bit for bit."""
    for r in ranks:
        for run in RUNS:
            assert (r[run]["groups_left"], r[run]["pinned_left"]) == (0, 0), run
        assert _losses(r, "again") == _losses(r, "plain")
        assert _digests(r, "again") == _digests(r, "plain")


def test_reshard_errors_are_raised_on_every_rank(ranks):
    errors, loss, dp = ranks[0]["errors"]
    assert [kind for kind, _ in errors] == ["RuntimeError"] + ["RunSpecError"] * 5
    for (_, text), match in zip(errors, ("needs an open()ed session", "dp must be >= 1",
                                         "needs 6 ranks", "must come first",
                                         "must be distinct", "must be distinct")):
        assert match in text, (text, match)
    assert np.isfinite(loss) and dp == 2
    assert all(r["errors"][0] == errors for r in ranks)


def test_single_process_sessions_refuse_reshard():
    """The twin of the reference's single-device refusal
    (``tests/test_fleet.py``'s snapshot test): such jobs reshard through
    the fleet's ``ElasticDpRunner``."""
    s = EdgeSession(RunSpec(**{**SPEC_KW, "dp": 1, "stages": 1}), device="cpu").open()
    try:
        with pytest.raises(RunSpecError, match="ElasticDpRunner"):
            s.reshard(2)
    finally:
        s.close()
