"""EdgeSession — one engine owning the model, the cache and the train
steps of a run (counterpart of ``repro.runtime.session``).

An :class:`EdgeSession` takes a validated
:class:`~repro_torch.runtime.spec.RunSpec` and owns the run:

* **device** — ``device=None`` means the card; with no card only an
  explicit ``device="cpu"`` runs (no silent fallback);
* **plan** — :func:`resolve_layout` turns the spec into the executed
  layout: with ``plan=None`` the CLI-pinned ``dp x stages`` (the planner
  runs as an offline report, the ``edge-pool plan:`` line); with
  ``plan="auto"`` Alg. 1 (:mod:`repro_torch.core.planner`, over
  :mod:`repro_torch.launch.costs`) picks the stage count, the period
  boundaries and, without ``micro``, the micro count; a path replays a
  saved plan. The plan's :class:`~repro_torch.core.planner.StagePartition`
  is then the run's contract: the mesh is ``plan_mesh_shape``'s, each
  stage runs its own periods (ragged ones too). A launcher resolves once
  and hands every rank the one layout (``layout=``), so no rank plans
  again;
* **mesh** — with more than one rank the session is one rank of the
  hybrid DP x PP trainer: every rank of an initialised process group
  (:func:`repro_torch.launch.mesh.spawn`) opens its own session, and
  ``open()`` builds the :class:`~repro_torch.launch.mesh.EdgeMesh`.
  Each rank draws the same seeded backbone and keeps its stage's part
  (:func:`~repro_torch.core.steps.stage_backbone`). Epoch 1 runs
  :func:`~repro_torch.core.steps.pipeline_pac_train_step`, cached epochs
  :func:`~repro_torch.core.steps.dp_cached_train_step` over the pool
  (modes ``hybrid dp{dp}xpp{S}``, or ``plan-driven dp{dp}xpp{S}``
  under a plan, and ``cached pure-dp``). The owner,
  rank 0, holds the activation cache, as the reference's single
  controller does: filled from epoch 1's activations in the
  single-process sample order, read on the host (its prefetcher stays
  there) and scattered to the ranks at each cached step, each copying
  its rows to its device. Only rank 0 writes the outputs;
* **reshard** — :meth:`reshard` moves a distributed run's cached steps
  onto a sub-mesh of the spawned ranks at another dp (elastic DP),
  shrinking or growing it again between steps. A rank outside it is
  parked: it keeps its process and its stage, joins the owner's
  hit/miss flag each step, and on a hit runs nothing (``mode``
  ``"parked"``, a NaN loss). A miss runs the epoch-1 step on the
  spawned mesh, after the owner broadcasts its adapter and optimizer
  to the ranks whose state lags; a rank that rejoins gets them at the
  reshard;
* **model** — the frozen backbone, drawn from a seeded generator leaf by
  leaf on the device and quantized as drawn (``quant``), so the f32 tree
  is never resident; the adapter (pruning or random init) and AdamW;
* **cache** — an :class:`~repro_torch.core.activation_cache.ActivationCache`
  with the spec's policy and budget; with ``cache_dir`` a persistent one
  (:func:`~repro_torch.core.activation_cache.open_persistent`) that a
  later run with the same backbone, corpus and policy reopens warm
  (``warm``: every epoch trains from the cache, no backbone forward);
* **steps** — :meth:`step` runs one batch: on a cache miss the epoch-1
  step (frozen forward + adapter update) and the cache fill, on a hit
  the cached step. Under ``kernels="cuda"`` the taps leave the forward
  already in the cache's storage form and reach the cached step in it;
* **epoch scope** — :meth:`epoch_scope` brackets one epoch: when the
  whole epoch is in the cache it arms a
  :class:`~repro_torch.core.activation_cache.CachePrefetcher`, whose
  worker reads, stacks and copies batch *k+1* to the card (pinned host
  buffers, a side stream) while step *k* runs, and :meth:`step` takes
  its hit from it; outside a scope a hit is read on the caller's thread;
* **outputs** — :meth:`finish` writes the adapter checkpoint (``ckpt``,
  the reference's msgpack format) and the cache manifest;
  :meth:`snapshot`/:meth:`restore` carry the adapter and optimizer state
  across a preemption; :meth:`serving_engine` serves the trained
  adapter from the session's backbone.

    spec = RunSpec(arch="internlm2-1.8b", reduced=True, epochs=3)
    reports = EdgeSession(spec, device="cpu").run()   # one EpochReport per epoch

Observability attaches as hooks (:class:`~repro_torch.runtime.runner.RunHooks`);
pass ``log=print`` for the CLI's informational lines (the reference's
``plan:`` and ``edge-pool plan:`` lines among them).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.runtime.spec import RunSpec, RunSpecError


@dataclass
class StepEvent:
    """One training step, as seen by hooks and the runner."""

    epoch: int
    index: int
    loss: float
    cache_hit: bool
    mode: str          # "full" | "cached" | "hybrid dp2xpp2" | "plan-driven dp1xpp3" | ...
    wall_s: float


@dataclass(frozen=True)
class Layout:
    """What a run executes, resolved once from its spec
    (:func:`resolve_layout`): the device ``pool``, the ``(dp, stages)``
    mesh, the micro-batch count, the ``plan`` (the executed one in plan
    mode, else the offline report), ``partition`` (the plan's
    StagePartition in plan mode, else None) and the ``lines`` the
    resolution reports. :meth:`to_json` carries it to the ranks."""

    pool: int
    dp: int
    stages: int
    n_micro: int
    plan: object                 # repro_torch.core.planner.Plan
    partition: object = None     # its StagePartition in plan mode
    lines: Tuple[str, ...] = ()

    @property
    def ranks(self) -> int:
        return self.dp * self.stages

    def to_json(self) -> str:
        return json.dumps({"pool": self.pool, "dp": self.dp, "stages": self.stages,
                           "n_micro": self.n_micro, "plan": self.plan.to_json(indent=None),
                           "executed": self.partition is not None, "lines": list(self.lines)})

    @classmethod
    def from_json(cls, text: str) -> "Layout":
        from repro_torch.core.planner import Plan

        d = json.loads(text)
        plan = Plan.from_json(d["plan"])
        return cls(d["pool"], d["dp"], d["stages"], d["n_micro"], plan,
                   plan.stage_partition() if d["executed"] else None, tuple(d["lines"]))


def _build_plan(spec: RunSpec, cfg, pool: int, planner_mb: int, n_micro: int, max_stages):
    """One construction site for both the executed plan and the offline
    report: period-granular costs (analytic or calibrated) through Alg. 1
    over ``pool`` Jetson Nano (high-power) profiles, the reference's."""
    from repro_torch.core.planner import JETSON_NANO_H, HybridParallelismPlanner
    from repro_torch.launch.costs import resolve_cost_model

    cost_model = resolve_cost_model(spec.calibrate, micro_batch=max(1, spec.batch // n_micro),
                                    quant_bits=spec.quant)
    return HybridParallelismPlanner(
        cost_model.period_costs(cfg, "pac", seq_len=spec.seq),
        [JETSON_NANO_H] * pool, planner_mb, n_micro,
    ).plan(max_stages=max_stages)


def resolve_layout(spec: RunSpec) -> Layout:
    """The executed layout of ``spec`` (validated), as the reference's
    session resolves it (``repro/runtime/session.py:113-261``). Pure
    Python over the planner: no device, no process group.

    * pool: ``spec.pool`` or ``max(dp·stages, 4)``, raised to a saved
      plan's stage count;
    * ``plan="auto"``: Alg. 1 over the pool (at most ``min(pool,
      n_periods)`` stages); with no ``micro`` the batch's divisors are
      swept for the least ``minibatch_latency``;
    * a saved plan is replayed (``calibrate`` then only adds a note);
    * plan mode checks the plan's period count against the arch and
      executes its stage count at the widest dp that
      :func:`~repro_torch.launch.mesh.plan_mesh_shape` allows;
    * outside plan mode the mesh is ``dp x stages`` and the planner's
      plan for it is an offline report (its σ-optimum noted).

    Raises :class:`RunSpecError` on an impossible layout."""
    from repro_torch.core.planner import Plan
    from repro_torch.launch.mesh import plan_mesh_shape

    spec.validate()
    cfg = spec.arch_config()
    pool = spec.pool or max(spec.total_devices, 4)
    saved = None
    if spec.plan_mode and spec.plan != "auto":
        saved = Plan.load(spec.plan)  # validate() checked the pool against its stages
        pool = max(pool, saved.n_stages)
    lines = []
    if not spec.plan_mode:
        n_micro = spec.default_micro()
        distributed = spec.total_devices > 1
        plan = _build_plan(spec, cfg, pool, spec.batch, n_micro,
                           spec.stages if distributed else None)
        lines.append("edge-pool plan: " + plan.describe().splitlines()[0])
        if distributed and plan.n_stages != spec.stages:
            lines.append(f"note: planner's σ-optimal stage count is {plan.n_stages}; "
                         f"executing --stages {spec.stages} (pass --plan auto to execute "
                         f"the σ-optimum)")
        return Layout(pool, spec.dp, spec.stages, n_micro, plan, None, tuple(lines))

    n_micro = spec.micro or (saved.micro_batches if saved else None)
    if n_micro is not None and spec.batch % n_micro:
        raise RunSpecError(f"batch {spec.batch} must be divisible by the plan's "
                           f"{n_micro} micro-batches (override with micro=)")
    if saved is None:
        smax = min(pool, cfg.n_periods)
        if n_micro is None:
            # the plan selects the micro count too: σ-optimal latency
            # over the batch's divisors
            cands = [m for m in range(1, spec.batch + 1) if spec.batch % m == 0]
            n_micro, plan = min(((m, _build_plan(spec, cfg, pool, spec.batch // m, m, smax))
                                 for m in cands), key=lambda t: t[1].minibatch_latency)
        else:
            plan = _build_plan(spec, cfg, pool, spec.batch // n_micro, n_micro, smax)
    else:
        if spec.calibrate:
            lines.append("note: --calibrate has no effect when replaying a saved plan; "
                         "re-run with --plan auto to replan")
        plan = saved
    mb = spec.batch // n_micro
    partition = plan.stage_partition()
    if partition.n_periods != cfg.n_periods:
        raise RunSpecError(f"plan partitions {partition.n_periods} periods but "
                           f"{cfg.name} has {cfg.n_periods} — replan for this arch")
    dp, stages = plan_mesh_shape(partition, pool, mb)
    lines.append("plan: " + plan.describe())
    for s, split in enumerate(partition.samples_per_device):
        if sum(split) != mb:
            lines.append(f"note: stage {s} was planned for {sum(split)} samples per "
                         f"micro-batch, executing {mb}")
    return Layout(pool, dp, stages, n_micro, plan, partition, tuple(lines))


def scatter_hit(mesh, hit, batch: int, axes, device):
    """The owner's cached batch ``hit`` (host; ``batch`` rows) split over
    the active mesh by ``launch.sharding.rank_rows``: the owner sends
    each counted position's rank its rows and keeps its own; each returns
    its rows on ``device`` (None on a rank whose rows do not count)."""
    from repro_torch.launch.sharding import rank_rows, rows_count

    if not mesh.owner:
        return mesh.recv_tree(0) if rows_count(mesh, axes) else None

    def rows_of(rank):
        r = rank_rows(batch, mesh, axes, rank)
        b0, taps, bf = hit
        return b0[r], taps[:, r], bf[r]

    for pos in range(1, mesh.world):
        if rows_count(mesh, axes, pos):
            mesh.send_tree(rows_of(pos), mesh.members[pos])
    return tuple(part.to(device) for part in rows_of(0))


class EdgeSession:
    """The run engine. ``open()``/``close()`` (or ``with``) bracket the
    heavy state; :meth:`step` is the one dispatch the epoch loop calls;
    :meth:`finish` writes the run's durable outputs."""

    def __init__(self, spec: RunSpec, *, device=None, log=None, layout=None):
        """``layout``: the run's :class:`Layout` (or its JSON), resolved
        once by a launcher for every rank; None resolves it at ``open()``."""
        spec.validate()
        self.spec = spec
        self.device = resolve_device(device)
        self.layout: Optional[Layout] = (Layout.from_json(layout) if isinstance(layout, str)
                                         else layout)
        self._log = log if log is not None else (lambda *a: None)
        self._opened = False
        self._finished = False
        # populated by open():
        self.cfg = None
        self.backbone = None      # the (possibly quantized) frozen tree
        self.adapter = None
        self.opt = None
        self.corpus = None
        self.pipe = None
        self.cache = None
        self.warm = False
        self.meta = None      # the persistent cache's identity record
        self._prefetch = None  # the live epoch_scope's CachePrefetcher
        self.mesh = None      # the EdgeMesh of a distributed run
        self.n_micro = None
        self.plan = None      # the executed plan (plan mode) or the offline report
        self.partition = None  # the executed plan's StagePartition (plan mode)
        self._synced = set()  # world ranks whose adapter and optimizer are the owner's

    def __enter__(self) -> "EdgeSession":
        return self.open()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def open(self) -> "EdgeSession":
        if self._opened:
            return self
        from repro_torch.core.activation_cache import (
            ActivationCache,
            manifest_for,
            open_persistent,
        )
        from repro_torch.core.init_methods import pruning_init
        from repro_torch.core.parallel_adapters import init_adapter
        from repro_torch.core.quantization import tree_leaves, tree_storage_bytes
        from repro_torch.data import DataPipeline, SyntheticPersonalCorpus
        from repro_torch.models.backbone import init_backbone
        from repro_torch.optim import adamw_init

        spec, log, dev = self.spec, self._log, self.device
        cfg = self.cfg = spec.arch_config()
        log(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M device={dev}")
        if self.layout is None:
            self.layout = resolve_layout(spec)
        lay = self.layout
        for line in lay.lines:
            log(line)
        self.plan, self.partition, self.n_micro = lay.plan, lay.partition, lay.n_micro
        if lay.ranks > 1:
            from repro_torch.launch.mesh import EdgeMesh

            self.mesh = EdgeMesh(lay.dp, lay.stages, device=dev)
            if spec.plan_mode:
                ragged = ("" if self.partition.is_uniform
                          else f", ragged periods {self.partition.periods_per_stage}")
                log(f"mesh: plan-driven dp={lay.dp}×pp={lay.stages} on {lay.ranks} devices, "
                    f"{self.n_micro} micro-batches{ragged} ({self.mesh.describe()})")
            else:
                log(f"mesh: hybrid dp={lay.dp}×pp={lay.stages} on {lay.ranks} devices, "
                    f"{self.n_micro} micro-batches ({self.mesh.describe()})")
        if spec.save_plan and (self.mesh is None or self.mesh.owner):
            log(f"plan saved: {self.plan.save(spec.save_plan)}")
        gen = torch.Generator(device=dev).manual_seed(spec.seed)
        backbone = init_backbone(gen, cfg, device=dev, quant_bits=spec.quant)
        if spec.quant:
            log(f"backbone quantized INT{spec.quant}: "
                f"{tree_storage_bytes(backbone)/2**20:.1f} MB")
        agen = torch.Generator(device=dev).manual_seed(spec.seed + 1)
        if spec.init == "pruning":
            self.adapter = pruning_init(agen, backbone, cfg, r=spec.r, device=dev)
        else:
            self.adapter = init_adapter(agen, cfg, r=spec.r, device=dev)
        n_train = sum(t.numel() for t in tree_leaves(self.adapter))
        log(f"trainable (adapter) params: {n_train/1e6:.2f}M "
            f"({n_train/cfg.param_count():.2%} of backbone)")
        self.opt = adamw_init(self.adapter)

        self.corpus = SyntheticPersonalCorpus(cfg.vocab, spec.seq + 1,
                                              spec.steps_per_epoch * spec.batch, seed=spec.seed)
        self.pipe = DataPipeline(self.corpus, global_batch=spec.batch, shuffle=True,
                                 seed=spec.seed)
        budget = spec.cache_budget_mb << 20
        owner = self.mesh is None or self.mesh.owner  # the owner alone holds the cache
        if owner and self.persistent:
            self.meta = manifest_for(cfg, reduced=spec.reduced, seq_len=spec.seq,
                                     quant_bits=spec.quant, backbone=backbone,
                                     corpus_tokens=self.corpus.tokens)
            self.cache, self.warm = open_persistent(spec.cache_dir, self.meta,
                                                    budget_bytes=budget,
                                                    compress=spec.cache_compress)
            if self.warm:
                log(f"activation cache: warm manifest at {spec.cache_dir} "
                    f"({len(self.cache)} seqs, {spec.cache_compress}) — "
                    f"cached epochs skip the backbone forward entirely")
        elif owner:
            self.cache = ActivationCache(budget_bytes=budget, compress=spec.cache_compress)
        if self.mesh is None:
            self.backbone = backbone
        else:
            from repro_torch.core.steps import stage_backbone

            # every rank keeps the final norm and head, since a reshard may
            # make any rank count rows (INT8 internlm2-1.8b: 0.19 GB of head
            # codes; its f32 loss head is made at the rank's first loss)
            self.backbone = stage_backbone(backbone, cfg, self.mesh, partition=self.partition,
                                           loss=True, copy=True)
            self._synced = set(self.mesh.members)
        del backbone
        self._opened = True
        return self

    @property
    def persistent(self) -> bool:
        """True when the cache outlives the run (``cache_dir`` set)."""
        return bool(self.spec.cache_dir and self.spec.use_cache)

    def close(self) -> None:
        """Release per-run state: join a live prefetcher, drop a
        non-persistent cache's entries and spill files, and destroy the
        mesh's groups. Writes no outputs; that is :meth:`finish`, which
        only a completed run calls."""
        if self._prefetch is not None:  # defensive: epoch_scope owns it
            self._prefetch.close()
            self._prefetch = None
        if self.cache is not None and not self.persistent:
            self.cache.clear()
        if self.mesh is not None:
            self.mesh.close()
        self._opened = False

    def step(self, batch: dict, *, epoch: int = 0, index: int = 0) -> StepEvent:
        """One training step: cache lookup, then the epoch-1 step and the
        cache fill on a miss, or the cached step on a hit. ``batch`` is
        one :meth:`DataPipeline.epoch` item (numpy; ``seq_ids`` is
        consumed here). Updates the session's adapter and optimizer."""
        from repro_torch.core import steps

        if not self._opened:
            raise RuntimeError("EdgeSession.step() before open(): use "
                               "`with EdgeSession(spec) as s:` or s.open()")
        spec, dev = self.spec, self.device
        t0 = time.perf_counter()
        ids = batch["seq_ids"]
        labels = torch.from_numpy(batch["labels"]).to(dev)
        if self.mesh is not None:
            return self._dist_step(batch, labels, epoch, index, t0)
        hit = self._next_hit(ids)
        if hit is None:
            tokens = torch.from_numpy(batch["tokens"]).to(dev)
            loss, self.adapter, self.opt, (b0, taps, bf) = steps.pac_train_step(
                self.backbone, self.adapter, self.opt, {"tokens": tokens, "labels": labels},
                cfg=self.cfg, r=spec.r, lr=spec.lr, kernel_impl=spec.kernels,
                # under cuda the taps leave the forward in the cache's
                # storage form, and put_batch adopts them as they are
                tap_policy=spec.cache_compress)
            if spec.use_cache:
                self.cache.put_batch(ids, b0, taps, bf, orig_last=self.cfg.d_model)
        else:
            # tensors or int8 QTensors; a prefetched hit is already on dev
            b0, taps, bf = (h.to(dev) for h in hit)
            cached = {"b0": b0, "taps": taps, "b_final": bf, "labels": labels}
            loss, self.adapter, self.opt = steps.pac_cached_train_step(
                self.backbone, self.adapter, self.opt, cached, cfg=self.cfg, r=spec.r,
                lr=spec.lr, kernel_impl=spec.kernels)
        loss = float(loss)
        return StepEvent(epoch=epoch, index=index, loss=loss, cache_hit=hit is not None,
                         mode=self.mode(hit is not None), wall_s=time.perf_counter() - t0)

    def _dist_step(self, batch, labels, epoch, index, t0) -> StepEvent:
        """One step of a distributed run, on every rank: the owner
        decides hit or miss and tells the ranks, then the epoch-1 step
        (and the owner's cache fill) on the spawned mesh, or the cached
        step on the rows the owner scatters over the active mesh; a
        parked rank sits a hit out."""
        from repro_torch.core import steps
        from repro_torch.launch.sharding import cached_batch_axes, rank_rows

        spec, mesh = self.spec, self.mesh
        ids = batch["seq_ids"]
        hit = self._next_hit(ids) if mesh.owner else None
        cache_hit = spec.use_cache and mesh.broadcast_flag(hit is not None)
        if cache_hit:
            self._synced &= set(mesh.members)  # a hit moves the members' state alone
            if not mesh.active:
                return StepEvent(epoch=epoch, index=index, loss=float("nan"), cache_hit=True,
                                 mode=self.mode(True), wall_s=time.perf_counter() - t0)
            axes = cached_batch_axes(spec.batch, mesh)
            rows = rank_rows(spec.batch, mesh, axes)
            local = scatter_hit(mesh, hit, spec.batch, axes, self.device)
            cached = None
            if local is not None:
                cached = dict(zip(("b0", "taps", "b_final"), local), labels=labels[rows])
            loss, self.adapter, self.opt = steps.dp_cached_train_step(
                self.backbone, self.adapter, self.opt, cached, cfg=self.cfg, mesh=mesh,
                batch_axes=axes, r=spec.r, lr=spec.lr, kernel_impl=spec.kernels)
        else:
            world = mesh.spawned.members
            if self._synced != set(world):  # the parked ranks take the owner's state first
                self.adapter, self.opt = mesh.spawned.broadcast_tree((self.adapter, self.opt))
                self._synced = set(world)
            tokens = torch.from_numpy(batch["tokens"]).to(self.device)
            loss, self.adapter, self.opt, acts = steps.pipeline_pac_train_step(
                self.backbone, self.adapter, self.opt, {"tokens": tokens, "labels": labels},
                cfg=self.cfg, mesh=mesh, n_micro=self.n_micro, r=spec.r, lr=spec.lr,
                partition=self.partition, kernel_impl=spec.kernels,
                tap_policy=spec.cache_compress)
            if spec.use_cache and mesh.owner:
                self.cache.put_batch(ids, *acts, orig_last=self.cfg.d_model)
        return StepEvent(epoch=epoch, index=index, loss=float(loss), cache_hit=cache_hit,
                         mode=self.mode(cache_hit), wall_s=time.perf_counter() - t0)

    @contextlib.contextmanager
    def epoch_scope(self, epoch: int):
        """Bracket one epoch's prefetcher lifecycle. When the whole epoch
        is cache-resident this arms a
        :class:`~repro_torch.core.activation_cache.CachePrefetcher` over
        the epoch's batch order (a background thread reads batch k+1 and
        starts its copy to the device while step k runs) *as a context
        manager*, so an exception mid-epoch joins the worker thread and
        drains its queue instead of leaking a daemon holding device
        batches. Yields True iff the epoch trains straight from the cache."""
        pf = None
        if self.spec.use_cache and self.cache is not None:
            from repro_torch.core.activation_cache import CachePrefetcher

            order = self.pipe.epoch_order(epoch)
            if order and self.cache.covers(np.concatenate(order), with_final=True):
                # a distributed owner scatters from the host: each rank
                # copies its own rows to its device
                pf = CachePrefetcher(self.cache, order,
                                     to_device=self.device if self.mesh is None else False,
                                     dtype=None, compressed=self.spec.kernels == "cuda")
        if pf is None:
            yield False
            return
        with pf:
            self._prefetch = pf
            try:
                yield True
            finally:
                self._prefetch = None

    def _next_hit(self, ids):
        """The step's cached batch: the live prefetcher's next, else read
        here (None on a miss, or without the cache)."""
        if self._prefetch is not None:
            return next(self._prefetch)
        if not self.spec.use_cache:
            return None
        return self.cache.get_batch(ids, with_final=True, dtype=None,
                                    compressed=self.spec.kernels == "cuda")

    def mode(self, cache_hit: bool) -> str:
        """The run-mode label the trainer reports (the reference's), or
        ``"parked"`` for a hit on a rank outside the active mesh. A miss
        names the spawned mesh, on which the epoch-1 step runs."""
        if self.mesh is None:
            return "cached" if cache_hit else "full"
        if cache_hit:
            return "cached pure-dp" if self.mesh.active else "parked"
        kind = "plan-driven" if self.spec.plan_mode else "hybrid"
        return f"{kind} dp{self.mesh.spawned.dp}xpp{self.mesh.stages}"

    # -- elastic DP -----------------------------------------------------------

    def reshard(self, dp: int, devices=None) -> None:
        """Elastic DP for a distributed session's cached epochs: make
        ``devices`` (world ranks in position order, rank 0 first;
        default the first ``dp·stages``) the active mesh at ``dp``, so
        the next cached steps run there. Every rank of the run calls it
        between the same two steps. The epoch-1 step keeps the spawned
        mesh, as the reference's does. Ranks outside the new mesh park;
        when it takes in a rank whose state lags the owner's, the owner
        broadcasts its adapter and optimizer over the new mesh first, so
        every member ends bit-equal to it. Single-process sessions
        reshard through :class:`repro_torch.fleet.ElasticDpRunner`.

        Raises ``RuntimeError`` before ``open()``, and
        :class:`RunSpecError` on a single-process session or an
        impossible layout, alike on every rank before any transfer."""
        if not self._opened:
            raise RuntimeError("reshard() needs an open()ed session")
        if self.mesh is None:
            raise RunSpecError("reshard() applies to multi-device sessions; single-device "
                               "jobs reshard via repro_torch.fleet.ElasticDpRunner")
        mesh = self.mesh
        try:
            mesh.reshard(int(dp), devices)
        except ValueError as e:
            raise RunSpecError(str(e)) from e
        joined = set(mesh.members)
        if mesh.active and not joined <= self._synced:
            self.adapter, self.opt = mesh.broadcast_tree((self.adapter, self.opt))
        self._synced |= joined

    # -- preemption snapshots -------------------------------------------------

    def snapshot(self, extra: dict = None) -> dict:
        """The run's preemptible state: adapter and optimizer (the
        backbone is frozen and the cache reproducible, so neither
        belongs here). ``extra`` carries a caller's cursor along. The
        tree round-trips through :func:`~repro_torch.checkpoint.save_checkpoint`
        bit for bit."""
        if not self._opened:
            raise RuntimeError("snapshot() needs an open()ed session")
        snap = {"adapter": self.adapter, "opt": self.opt, "config": self.cfg.name}
        if extra:
            snap["extra"] = dict(extra)
        return snap

    def restore(self, snap: dict) -> dict:
        """Adopt a :meth:`snapshot` (its tensors moved to the session's
        device). Returns the snapshot's ``extra``."""
        from repro_torch.core.quantization import tree_map

        if not self._opened:
            raise RuntimeError("restore() needs an open()ed session")
        if snap.get("config") != self.cfg.name:
            raise RunSpecError(f"snapshot is for arch {snap.get('config')!r}, "
                               f"session runs {self.cfg.name!r}")
        self.adapter = tree_map(lambda t: t.to(self.device), snap["adapter"])
        self.opt = tree_map(lambda t: t.to(self.device), snap["opt"])
        return snap.get("extra", {})

    def save_snapshot(self, path: str, extra: dict = None) -> str:
        """:meth:`snapshot` to disk (atomic), so a preempted run
        survives its process."""
        from repro_torch.checkpoint import save_checkpoint

        save_checkpoint(path, self.snapshot(extra))
        return path

    def restore_snapshot(self, path: str) -> dict:
        from repro_torch.checkpoint import load_checkpoint

        return self.restore(load_checkpoint(path, device=self.device))

    # -- outputs --------------------------------------------------------------

    def finish(self) -> None:
        """Write the run's durable outputs: the adapter checkpoint
        (``spec.ckpt``: ``{"adapter", "config"}``) and, for a persistent
        cache, the manifest that lets the next run resume warm."""
        if self._finished:
            return
        spec, log = self.spec, self._log
        if self.mesh is not None and not self.mesh.owner:
            self._finished = True  # the owner writes the run's outputs
            return
        if spec.ckpt:
            from repro_torch.checkpoint import save_checkpoint

            n = save_checkpoint(spec.ckpt, {"adapter": self.adapter, "config": self.cfg.name})
            log(f"checkpoint: {spec.ckpt} ({n/2**20:.1f} MB)")
        if self.meta is not None:
            path = self.cache.save_manifest(self.meta)
            log(f"cache manifest: {path} ({len(self.cache)} seqs, {spec.cache_compress})")
        self._finished = True

    def serving_engine(self, adapters=None, **kw):
        """A :class:`~repro_torch.serve.ServeEngine` over this session's
        (quantized) frozen backbone on its device, serving by default
        the adapter it trained (as ``"local"``); ``adapters={name: tree}``
        serves another bank. Engine knobs pass through; ``r`` and
        ``kernel_impl`` default to the run's."""
        from repro_torch.serve import ServeEngine

        if self.backbone is None:
            raise RunSpecError("serving_engine() needs an open()ed session")
        if self.mesh is not None:
            raise RunSpecError("serving_engine() needs a single-device session: a "
                               "distributed rank holds one stage of the backbone")
        if adapters is None:
            adapters = {"local": self.adapter}
        kw.setdefault("r", self.spec.r)
        kw.setdefault("kernel_impl", self.spec.kernels)
        kw.setdefault("device", self.device)
        return ServeEngine(self.backbone, self.cfg, adapters, **kw)

    def run(self, hooks=()) -> list:
        """open → every epoch through an
        :class:`~repro_torch.runtime.runner.EpochRunner` → finish → close.
        Returns the list of :class:`~repro_torch.runtime.runner.EpochReport`."""
        from repro_torch.runtime.runner import EpochRunner

        with self:
            reports = EpochRunner(self, hooks=hooks).run()
            self.finish()
        return reports
