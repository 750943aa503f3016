"""The port's hybrid DP x PP trainer against the JAX reference's.

The reference runs in a subprocess on four forced host devices (its
``(dp, stage)`` mesh); the port runs as gloo ranks on the CPU, spawned by
``repro_torch.launch.mesh.spawn``, on the same parameters and batch
(reduced internlm2-1.8b, B 8, S 16, n_micro 2, r 4, the ``ref`` kernels):

* the epoch-1 step's loss, gradients and activations, and its update,
  at the reference's bounds (``tests/test_train_distributed.py``);
* the cached step over the pool against the reference's single-device
  cached step, also on the pool shrunk to dp 1 (``EdgeMesh.reshard``),
  and with rows a dp row's ranks share;
* a ragged 3-stage partition of a 5-period config (the reference's
  ``StagePartition``);
* reduced qwen2-vl-7b (mrope: (3, B, S) positions in the stages, in the
  loss and in the cached step) on the (2, 2) mesh;
* the ``cuda`` OpSet (plain versions on the CPU) with int8 taps against
  the port's own single-process step, then a cached step from the
  owner's scatter of those taps; each step's point-to-point and
  all-reduce bytes (``EdgeMesh.stats``) against the dry run's priced
  dp 2 x stages 2 layout (``repro_torch.launch.dryrun``);
* every rank's adapter and optimizer bit-equal after every step; the
  layout errors; the CLI; a failing or hung rank failing the run.

Every spawn runs with a gloo timeout of 60 s and a 120 s deadline on the
join, after which the ranks are killed.
"""

import dataclasses
import hashlib
import os
import re
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.planner import StagePartition
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import steps
from repro_torch.core.quantization import QTensor, quantize_tree, tree_leaves
from repro_torch.launch.mesh import EdgeMesh, spawn
from repro_torch.launch.sharding import cached_batch_axes, rank_rows
from repro_torch.models.backbone import backbone_forward
from repro_torch.optim import adamw_init
from repro_torch.runtime import RunSpec, RunSpecError
from repro_torch.runtime.session import scatter_hit

REPO = Path(__file__).resolve().parents[1]
GLOO_TIMEOUT, DEADLINE = 60.0, 120.0
B, S, N_MICRO, R = 8, 16, 2, 4
RAGGED = StagePartition(boundaries=(0, 1, 3, 5), samples_per_device=((4,), (4,), (4,)),
                        n_micro=2)

# the reference, in two subprocesses run side by side: its pipeline on a
# (2, 2) mesh (the update is the step's clip and AdamW on those
# gradients) and its single-device cached step; the ragged partition on a
# (1, 3) mesh. Each writes its results as numpy trees.
_REFERENCE = textwrap.dedent(
    """
    import os, sys, pickle, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from repro.configs import get_arch
    from repro.core import steps
    from repro.core.parallel_adapters import init_adapter
    from repro.core.planner import StagePartition
    from repro.launch.mesh import make_edge_mesh
    from repro.models import backbone as bb
    from repro.optim import adamw_init, adamw_update, clip_by_global_norm

    kind, B, S, R = sys.argv[2], {B}, {S}, {R}
    cfg = get_arch("qwen2-vl-7b" if kind == "mrope" else "internlm2-1.8b").reduced()
    if kind == "ragged":
        cfg = dataclasses.replace(cfg, name="plan5p", n_layers=5 * cfg.period)
    bp = bb.init_backbone(jax.random.PRNGKey(0), cfg)
    ap = init_adapter(jax.random.PRNGKey(1), cfg, r=R)
    batch = {{"tokens": jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, cfg.vocab),
              "labels": jax.random.randint(jax.random.PRNGKey(3), (B, S), 0, cfg.vocab)}}
    if kind == "ragged":
        part = StagePartition(**{RAGGED_FIELDS})
        mesh = make_edge_mesh(1, 3, devices=jax.devices()[:3])
        loss, grads, acts = steps.pipeline_pac_loss_and_grads(
            bp, ap, batch, cfg=cfg, mesh=mesh, n_micro=part.n_micro, r=R, partition=part)
        out = dict(loss=loss, grads=grads, acts=acts)
    else:
        opt = adamw_init(ap)
        loss, grads, acts = steps.pipeline_pac_loss_and_grads(
            bp, ap, batch, cfg=cfg, mesh=make_edge_mesh(2, 2), n_micro={N_MICRO}, r=R)
        ap1, _ = adamw_update(ap, clip_by_global_norm(grads, 1.0)[0], opt, lr=1e-3)
        bf, taps, b0, _ = bb.backbone_forward(bp, cfg, batch, collect_taps=True,
                                              return_inputs=True)
        cached = {{"b0": b0, "taps": taps, "b_final": bf, "labels": batch["labels"]}}
        lossN, apN, _ = steps.pac_cached_train_step(bp, ap, opt, cached, cfg=cfg, r=R)
        out = dict(loss=loss, grads=grads, acts=acts, ap1=ap1, lossN=lossN, apN=apN)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, out), f)
    """
).format(B=B, S=S, R=R, N_MICRO=N_MICRO, RAGGED_FIELDS=repr(dataclasses.asdict(RAGGED)))


def _inputs(ragged: bool, arch: str = "internlm2-1.8b") -> dict:
    """The reference scripts' parameters and batch, drawn here too (the
    same keys), as numpy trees."""
    import jax

    from repro.configs import get_arch as jax_arch
    from repro.core.parallel_adapters import init_adapter
    from repro.models import backbone as bb

    cfg = jax_arch(arch).reduced()
    if ragged:
        cfg = dataclasses.replace(cfg, name="plan5p", n_layers=5 * cfg.period)
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, cfg.vocab),
             "labels": jax.random.randint(jax.random.PRNGKey(3), (B, S), 0, cfg.vocab)}
    return jax.tree.map(np.asarray, {"bp": bb.init_backbone(jax.random.PRNGKey(0), cfg),
                                     "ap": init_adapter(jax.random.PRNGKey(1), cfg, r=R),
                                     "batch": batch})


# ---------------------------------------------------------------------------
# What each rank runs (module-level, so the spawned processes can import it)
# ---------------------------------------------------------------------------


def _digest(*trees) -> str:
    h = hashlib.sha256()
    for t in tree_leaves(trees):
        h.update(t.detach().cpu().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _batch(inp):
    return {k: torch.from_numpy(np.array(v)) for k, v in inp["batch"].items()}


def _uniform_rank(inp):
    """Every check on the (2, 2) mesh, in one spawn."""
    cfg = get_arch("internlm2-1.8b").reduced()
    mesh = EdgeMesh(2, 2, device="cpu")
    bp, ap = bridge.to_torch(inp["bp"]), bridge.to_torch(inp["ap"])
    opt, batch = adamw_init(ap), _batch(inp)
    kw = dict(cfg=cfg, mesh=mesh, n_micro=N_MICRO, r=R)
    out = {}
    loss, grads, acts = steps.pipeline_pac_loss_and_grads(bp, ap, batch, **kw)
    out["loss"], out["grads"] = float(loss), bridge.to_numpy(grads)
    out["acts"] = bridge.to_numpy(acts)
    _, ap1, _, _ = steps.pipeline_pac_train_step(bp, ap, opt, batch, **kw)
    out["ap1"] = bridge.to_numpy(ap1)

    # the cached step over the pool, from the single-process activations
    with torch.no_grad():
        bf, taps, b0, _ = backbone_forward(bp, cfg, batch, collect_taps=True, return_inputs=True)

    def cached_step(a, o, n):  # the first n rows, split over the pool
        axes = cached_batch_axes(n, mesh)
        r = rank_rows(n, mesh, axes)
        mine = {"b0": b0[r], "taps": taps[:, r], "b_final": bf[r], "labels": batch["labels"][r]}
        return steps.dp_cached_train_step(bp, a, o, mine, cfg=cfg, mesh=mesh, batch_axes=axes,
                                          r=R, kernel_impl="ref")

    lossN, apN, _ = cached_step(ap, opt, B)
    out["lossN"], out["apN"] = float(lossN), bridge.to_numpy(apN)
    # the same step on the mesh shrunk to dp 1 (ranks 0 and 1); the parked
    # ranks sit it out and join no collective of the sub-mesh
    mesh.reshard(1)
    out["shrunk"] = None
    if mesh.active:
        loss1, ap1N, _ = cached_step(ap, opt, B)
        out["shrunk"] = (float(loss1), bridge.to_numpy(ap1N))
    else:
        try:
            mesh.all_reduce_tree(torch.zeros(1))
        except RuntimeError as e:
            out["shrunk"] = str(e)
    mesh.reshard(2)
    # 2 rows over dp only: both ranks of a dp row hold the row, one counts it
    loss2, ap2, _ = cached_step(ap, opt, 2)
    out["axes2"] = cached_batch_axes(2, mesh)
    out["loss2"], out["ap2"] = float(loss2), bridge.to_numpy(ap2)

    # every rank's state after each of 3 epoch-1 and 2 cached steps
    a, o, out["digests"] = ap, opt, []
    for _ in range(3):
        _, a, o, _ = steps.pipeline_pac_train_step(bp, a, o, batch, **kw)
        out["digests"].append(_digest(a, o))
    for _ in range(2):
        _, a, o = cached_step(a, o, B)
        out["digests"].append(_digest(a, o))

    # the cuda OpSet (its plain versions here) with int8 taps on an INT8 backbone
    bq = quantize_tree(bp, bits=8)
    stats0 = dict(mesh.stats)
    loss8, a8, o8, acts8 = steps.pipeline_pac_train_step(
        bq, ap, opt, batch, kernel_impl="cuda", tap_policy="int8", **kw)
    stats1 = dict(mesh.stats)
    out["loss8"], out["acts8"] = float(loss8), bridge.to_numpy(acts8)
    out["digest8"] = _digest(a8, o8)
    # then a cached step as the session runs it: the owner scatters the
    # int8 activations it gathered, every rank steps on its rows
    axes = cached_batch_axes(B, mesh)
    mine = scatter_hit(mesh, acts8, B, axes, "cpu")
    cached = dict(zip(("b0", "taps", "b_final"), mine), labels=batch["labels"][rank_rows(
        B, mesh, axes)])
    steps.dp_cached_train_step(bq, a8, o8, cached, cfg=cfg, mesh=mesh, batch_axes=axes, r=R,
                               kernel_impl="cuda")
    stats2 = dict(mesh.stats)
    out["bytes8"] = {step: {k: after[k] - before[k] for k in ("p2p_bytes", "allreduce_bytes")}
                     for step, before, after in (("pac", stats0, stats1),
                                                 ("pac_cached", stats1, stats2))}

    # layout errors, raised alike on every rank before any transfer
    out["errors"] = []
    six = {k: torch.cat([v, v[:4]])[:6] for k, v in batch.items()}
    try:
        steps.pipeline_pac_loss_and_grads(bp, ap, six, **kw)
    except ValueError as e:
        out["errors"].append(str(e))
    mesh.close()
    mesh4 = EdgeMesh(1, 4, device="cpu")
    try:  # 2 periods cannot split into 4 stages
        steps.pipeline_pac_loss_and_grads(bp, ap, {k: v[:4] for k, v in batch.items()},
                                          cfg=cfg, mesh=mesh4, n_micro=N_MICRO, r=R)
    except ValueError as e:
        out["errors"].append(str(e))
    mesh4.close()
    return out


def _ragged_rank(inp, partition):
    base = get_arch("internlm2-1.8b").reduced()
    cfg = dataclasses.replace(base, name="plan5p", n_layers=5 * base.period)
    mesh = EdgeMesh(1, 3, device="cpu")
    loss, grads, acts = steps.pipeline_pac_loss_and_grads(
        bridge.to_torch(inp["bp"]), bridge.to_torch(inp["ap"]), _batch(inp), cfg=cfg, mesh=mesh,
        n_micro=partition.n_micro, r=R, partition=partition)
    mesh.close()
    return {"loss": float(loss), "grads": bridge.to_numpy(grads), "acts": bridge.to_numpy(acts)}


def _mrope_rank(inp):
    """qwen2-vl reduced on the (2, 2) mesh: the epoch-1 loss, gradients,
    activations and update, and the cached step over the pool."""
    cfg = get_arch("qwen2-vl-7b").reduced()
    mesh = EdgeMesh(2, 2, device="cpu")
    bp, ap = bridge.to_torch(inp["bp"]), bridge.to_torch(inp["ap"])
    opt, batch = adamw_init(ap), _batch(inp)
    kw = dict(cfg=cfg, mesh=mesh, n_micro=N_MICRO, r=R)
    loss, grads, acts = steps.pipeline_pac_loss_and_grads(bp, ap, batch, **kw)
    out = {"loss": float(loss), "grads": bridge.to_numpy(grads), "acts": bridge.to_numpy(acts)}
    out["ap1"] = bridge.to_numpy(steps.pipeline_pac_train_step(bp, ap, opt, batch, **kw)[1])
    with torch.no_grad():
        bf, taps, b0, _ = backbone_forward(bp, cfg, batch, collect_taps=True, return_inputs=True)
    axes = cached_batch_axes(B, mesh)
    r = rank_rows(B, mesh, axes)
    mine = {"b0": b0[r], "taps": taps[:, r], "b_final": bf[r], "labels": batch["labels"][r]}
    lossN, apN, _ = steps.dp_cached_train_step(bp, ap, opt, mine, cfg=cfg, mesh=mesh,
                                               batch_axes=axes, r=R, kernel_impl="ref")
    out["lossN"], out["apN"] = float(lossN), bridge.to_numpy(apN)
    mesh.close()
    return out


def _failing_rank(bad_rank):
    mesh = EdgeMesh(2, 2, device="cpu")
    if mesh.rank == bad_rank:
        raise RuntimeError("a deliberately broken rank")
    mesh.recv_tree(bad_rank)  # never sent: waits until the rank's death ends the run


def _hung_rank():
    time.sleep(600)


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """(reference, inputs, port uniform ranks, port ragged ranks, port
    mrope ranks): the three JAX subprocesses run while the port's ranks
    do."""
    import pickle

    tmp = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    procs = {kind: subprocess.Popen([sys.executable, "-c", _REFERENCE, str(tmp / kind), kind],
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for kind in ("uniform", "ragged", "mrope")}
    try:
        inp = {"uniform": _inputs(False), "ragged": _inputs(True),
               "mrope": _inputs(False, "qwen2-vl-7b")}
        uniform = spawn(_uniform_rank, 2, 2, "cpu", args=(inp["uniform"],),
                        timeout=GLOO_TIMEOUT, deadline=DEADLINE)
        ragged = spawn(_ragged_rank, 1, 3, "cpu", args=(inp["ragged"], RAGGED),
                       timeout=GLOO_TIMEOUT, deadline=DEADLINE)
        mrope = spawn(_mrope_rank, 2, 2, "cpu", args=(inp["mrope"],),
                      timeout=GLOO_TIMEOUT, deadline=DEADLINE)
        ref = {}
        for kind, proc in procs.items():
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            with open(tmp / kind, "rb") as f:
                ref[kind] = pickle.load(f)
    finally:
        for proc in procs.values():
            proc.kill()
            proc.communicate()
    return ref, inp, uniform, ragged, mrope


@pytest.fixture(scope="module")
def runs(all_runs):
    """(reference, inputs, port uniform ranks, port ragged ranks)."""
    return all_runs[:4]


def _max_diff(a, b) -> float:
    la, lb = tree_leaves(bridge.to_torch(a)), tree_leaves(bridge.to_torch(b))
    assert len(la) == len(lb)
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def test_epoch1_loss_and_grads_match_the_reference(runs):
    ref, _, ranks, _ = runs
    for got in ranks:  # every rank returns the global loss and gradients
        assert abs(got["loss"] - float(ref["uniform"]["loss"])) < 1e-4
        assert _max_diff(got["grads"], ref["uniform"]["grads"]) < 1e-4


def test_epoch1_activations_reach_the_owner_in_sample_order(runs):
    ref, _, ranks, _ = runs
    b0, taps, bf = ranks[0]["acts"]
    rb0, rtaps, rbf = ref["uniform"]["acts"]
    assert taps.shape == rtaps.shape == (2, B, S, 256)
    assert np.abs(taps - rtaps).max() < 1e-4
    assert np.abs(bf - rbf).max() < 1e-4
    assert np.abs(b0 - rb0).max() < 1e-6
    assert all(r["acts"] is None for r in ranks[1:])


def test_epoch1_update_matches_the_reference(runs):
    ref, _, ranks, _ = runs
    for got in ranks:
        assert _max_diff(got["ap1"], ref["uniform"]["ap1"]) < 1e-3


def test_cached_step_over_the_pool_matches_single_device(runs):
    ref, _, ranks, _ = runs
    for got in ranks:
        assert abs(got["lossN"] - float(ref["uniform"]["lossN"])) < 1e-4
        assert _max_diff(got["apN"], ref["uniform"]["apN"]) < 1e-3


def test_cached_step_on_a_shrunk_mesh_matches_single_device(runs):
    """After ``EdgeMesh.reshard(1)``, the two ranks of the sub-mesh run the
    pool's cached step from the same state: loss and update against the
    reference's single-device step, at the bounds above; the parked ranks
    return no result and refuse the sub-mesh's all-reduce."""
    ref, _, ranks, _ = runs
    for got in ranks[:2]:
        loss, ap = got["shrunk"]
        assert abs(loss - float(ref["uniform"]["lossN"])) < 1e-4
        assert _max_diff(ap, ref["uniform"]["apN"]) < 1e-3
    for got in ranks[2:]:
        assert "is parked" in got["shrunk"]


def test_rows_a_dp_row_shares_count_once(runs):
    """2 rows over a 2x2 pool: the stage axis cannot shard, both ranks of
    a dp row hold its row, and the loss and update equal one process's."""
    _, inp, ranks, _ = runs
    cfg = get_arch("internlm2-1.8b").reduced()
    bp, ap = bridge.to_torch(inp["uniform"]["bp"]), bridge.to_torch(inp["uniform"]["ap"])
    batch = _batch(inp["uniform"])
    bf, taps, b0, _ = backbone_forward(bp, cfg, batch, collect_taps=True, return_inputs=True)
    cached = {"b0": b0[:2], "taps": taps[:, :2], "b_final": bf[:2], "labels": batch["labels"][:2]}
    loss, ap2, _ = steps.pac_cached_train_step(bp, ap, adamw_init(ap), cached, cfg=cfg, r=R)
    for got in ranks:
        assert got["axes2"] == ("dp",)
        assert abs(got["loss2"] - float(loss)) < 1e-5
        assert _max_diff(got["ap2"], bridge.to_numpy(ap2)) < 1e-3


def test_ragged_partition_matches_the_reference(runs):
    ref, _, _, ranks = runs
    want = ref["ragged"]
    assert abs(ranks[0]["loss"] - float(want["loss"])) < 1e-4
    assert _max_diff(ranks[0]["grads"], want["grads"]) < 1e-4
    b0, taps, bf = ranks[0]["acts"]
    assert taps.shape == want["acts"][1].shape == (5, B, S, 256)
    assert np.abs(taps - want["acts"][1]).max() < 1e-4
    assert np.abs(bf - want["acts"][2]).max() < 1e-4
    assert np.abs(b0 - want["acts"][0]).max() < 1e-6
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)


def test_mrope_pipeline_and_cached_pool_match_the_reference(all_runs):
    """qwen2-vl reduced (mrope) at dp 2 x pp 2: every rank's epoch-1 loss
    and gradients, the owner's activations, the update, and the cached
    step over the pool against the reference's, at the bounds above."""
    ref, _, _, _, ranks = all_runs
    want = ref["mrope"]
    for got in ranks:
        assert abs(got["loss"] - float(want["loss"])) < 1e-4
        assert _max_diff(got["grads"], want["grads"]) < 1e-4
        assert _max_diff(got["ap1"], want["ap1"]) < 1e-3
        assert abs(got["lossN"] - float(want["lossN"])) < 1e-4
        assert _max_diff(got["apN"], want["apN"]) < 1e-3
    b0, taps, bf = ranks[0]["acts"]
    assert taps.shape == want["acts"][1].shape == (2, B, S, 256)
    assert np.abs(taps - want["acts"][1]).max() < 1e-4
    assert np.abs(bf - want["acts"][2]).max() < 1e-4
    assert np.abs(b0 - want["acts"][0]).max() < 1e-6
    assert all(r["acts"] is None for r in ranks[1:])


# ---------------------------------------------------------------------------
# The port against itself
# ---------------------------------------------------------------------------


def test_every_rank_holds_the_same_adapter_after_every_step(runs):
    _, _, ranks, _ = runs
    assert len(ranks[0]["digests"]) == 5
    assert all(r["digests"] == ranks[0]["digests"] for r in ranks)
    assert all(r["digest8"] == ranks[0]["digest8"] for r in ranks)
    assert len(set(ranks[0]["digests"])) == 5  # and each step moved it


def test_int8_taps_match_the_single_process_step(runs):
    """Under the cuda OpSet with int8 taps: b0 codes bit-equal, tap and
    b_final codes within one quantization step, the loss at f32 reorder."""
    _, inp, ranks, _ = runs
    cfg = get_arch("internlm2-1.8b").reduced()
    bq = quantize_tree(bridge.to_torch(inp["uniform"]["bp"]), bits=8)
    ap = bridge.to_torch(inp["uniform"]["ap"])
    loss, _, _, acts = steps.pac_train_step(bq, ap, adamw_init(ap), _batch(inp["uniform"]),
                                            cfg=cfg, r=R, kernel_impl="cuda", tap_policy="int8")
    got = bridge.to_torch(ranks[0]["acts8"])
    assert all(isinstance(t, QTensor) for t in got + acts)
    assert torch.equal(got[0].q, acts[0].q) and torch.equal(got[0].scale, acts[0].scale)
    for a, b in zip(got[1:], acts[1:]):
        assert a.q.shape == b.q.shape
        assert int((a.q.int() - b.q.int()).abs().max()) <= 1
        assert float((a.scale - b.scale).abs().max()) <= 1e-5 * float(b.scale.abs().max())
    assert abs(ranks[0]["loss8"] - float(loss)) < 1e-4


@pytest.mark.parametrize("technique", ["pac", "pac_cached"])
def test_priced_layout_bytes_equal_the_mesh_stats(runs, technique):
    """The dry run's dp 2 x stages 2 layout (``repro_torch.launch.dryrun``,
    threads on meta) prices each rank's point-to-point and all-reduce
    bytes of the epoch-1 step and of the cached step as the gloo ranks'
    ``EdgeMesh.stats`` count them."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.specs import build_case

    _, _, ranks, _ = runs
    case = build_case(get_arch("internlm2-1.8b").reduced(), InputShape("t", S, B, "train"),
                      (2, 2), technique=technique, quant_bits=8, r=R, tap_policy="int8")
    priced = [p.cost.collectives for p in case.price()]
    for rank, (want, got) in enumerate(zip(ranks, priced)):
        assert want["bytes8"][technique]["p2p_bytes"] == got["p2p"], rank
        assert want["bytes8"][technique]["allreduce_bytes"] == got["all-reduce"], rank
    assert sum(r["bytes8"][technique]["p2p_bytes"] for r in ranks) > 0


def test_layout_errors_are_raised_on_every_rank(runs):
    _, _, ranks, _ = runs
    for got in ranks:
        assert len(got["errors"]) == 2, got["errors"]
        assert all("divisible" in e for e in got["errors"])


@pytest.mark.parametrize("field,value,match", [
    ("batch", 5, "batch 5 must be divisible by the 2 micro-batches"),
    ("micro", 4, "micro-batch size 1 must be divisible by dp=2"),
    ("stages", 4, "stages 4 must divide n_periods=2"),
    ("micro", 3, "divisible by micro=3"),
])
def test_runspec_layout_checks(field, value, match):
    spec = {"reduced": True, "dp": 2, "stages": 2, "batch": 4, field: value}
    if field == "stages":
        spec["dp"] = 1
    with pytest.raises(RunSpecError, match=match):
        RunSpec(**spec).validate()


@pytest.mark.parametrize("kw", [{}, {"dp": 2, "stages": 2}, {"dp": 4}, {"stages": 2, "micro": 4},
                                {"micro": 2}])
def test_runspec_mesh_fields_match_the_reference(kw):
    from repro.runtime import RunSpec as JaxSpec

    mine, ref = RunSpec(reduced=True, **kw).validate(), JaxSpec(reduced=True, **kw).validate()
    assert (mine.total_devices, mine.default_micro()) == (ref.total_devices, ref.default_micro())


# ---------------------------------------------------------------------------
# Failing ranks and the CLI
# ---------------------------------------------------------------------------


def test_a_failing_rank_fails_the_run_at_once():
    t0 = time.monotonic()
    # the broken rank's peers may fail first: their recv from it breaks
    with pytest.raises(RuntimeError, match=r"rank \d exited with code 1"):
        spawn(_failing_rank, 2, 2, "cpu", args=(1,), timeout=GLOO_TIMEOUT, deadline=DEADLINE)
    assert time.monotonic() - t0 < GLOO_TIMEOUT


def test_a_hung_rank_is_killed_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="deadline"):
        spawn(_hung_rank, 1, 2, "cpu", timeout=GLOO_TIMEOUT, deadline=5.0)
    assert time.monotonic() - t0 < 40


def _cli(*flags):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--epochs", "3", "--steps-per-epoch", "2", "--batch", "4", "--seq", "16", *flags],
        capture_output=True, text=True, env=env, timeout=DEADLINE)


def test_cli_runs_the_pool_and_matches_one_process():
    pool, one = _cli("--dp", "2", "--stages", "2"), _cli()
    assert pool.returncode == 0, pool.stderr[-3000:]
    assert one.returncode == 0, one.stderr[-3000:]
    assert "mesh: hybrid dp=2×pp=2 on 4 devices" in pool.stdout
    assert "epoch 0" in pool.stdout and "(hybrid dp2xpp2)" in pool.stdout
    assert "epoch 2" in pool.stdout and pool.stdout.count("(cached pure-dp)") == 2

    def losses(out):
        return [float(x) for x in re.findall(r"epoch \d: loss=([0-9.]+)", out)]

    assert len(losses(pool.stdout)) == 3
    # both printed to 4 decimals
    assert max(abs(a - b) for a, b in zip(losses(pool.stdout), losses(one.stdout))) <= 1e-4 + 1e-9
