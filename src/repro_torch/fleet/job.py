"""SessionJob — one fine-tuning job, driven step-by-step by the scheduler
(counterpart of ``repro.fleet.job``).

Wraps a single-device :class:`~repro_torch.runtime.EdgeSession` (the
fleet distributes *chunks*, not the mesh — see
:class:`~repro_torch.fleet.elastic.ElasticDpRunner`) and owns the job's
cursor: which epoch/step it is on, which member set it last ran on, and
the live :class:`~repro_torch.core.activation_cache.CachePrefetcher`.
The scheduler pokes exactly three verbs:

* :meth:`run_step` — advance one training step under a placement.
  Epoch-1 (capture) steps run through ``session.step`` on the job's
  home device; cache-resident steps run elastically across the
  placement's members. A placement change closes + re-arms the
  prefetcher over the *remaining* epoch order and reshards the runner.
* :meth:`pause` — checkpointed preemption: snapshot adapter+optimizer
  (+ cursor) via the session's snapshot seam — to disk when the
  scheduler has a ``snapshot_dir``, so the state survives the process.
* :meth:`resume` — adopt a snapshot and rebuild the cursor; the epoch
  order is recomputed (it is a pure function of spec.seed and the epoch
  index), so resuming replays the exact remaining batches.

``plan_shares`` prices a placement's chunk split with the paper's
Eq. (4) dispatch (``plan_pure_dp`` over ``pac_cached`` period costs on
the members' speed-scaled profiles) — stragglers are deweighted by the
same math that sized the original pool.

``device`` is the job's home device (``None`` is the card; with no card
only an explicit ``"cpu"`` runs): the session, its capture steps and
the canonical-order sums of its cached steps live there.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.runtime.session import EdgeSession, StepEvent
from repro_torch.runtime.spec import RunSpec, RunSpecError


class SessionJob:
    """One queued/running fine-tuning job on the fleet."""

    min_devices = 1

    def __init__(self, name: str, spec: RunSpec, *, chunk: int = 1,
                 hooks=(), log=None, device=None):
        if spec.total_devices != 1 or spec.plan_mode:
            raise RunSpecError(
                "fleet jobs run single-device sessions (dp=1, stages=1, no "
                "plan) — the fleet distributes cached-epoch chunks, not the "
                "mesh")
        if spec.batch % chunk:
            raise RunSpecError(
                f"batch {spec.batch} must be divisible by chunk={chunk}")
        self.name = name
        self.spec = spec
        self.chunk = chunk
        self.hooks = list(hooks)
        self.session = EdgeSession(spec, device=device, log=log)
        self.state = "queued"     # queued|running|preempted|done|rejected
        self.events: List[StepEvent] = []
        self.forward_steps = 0    # epoch-1 backbone forwards (capture)
        self.cached_steps = 0     # elastic cache-resident steps
        self.reshards = 0         # placement changes while running
        self._elastic = None
        self._epoch = 0
        self._index = 0
        self._order = None        # this epoch's remaining batch-id arrays
        self._pf = None
        self._members_sig: Optional[Tuple[str, ...]] = None
        self._costs = None

    # -- sizing (the scheduler's admission/pricing view) ----------------------

    @property
    def n_chunks(self) -> int:
        return self.spec.batch // self.chunk

    @property
    def max_devices(self) -> int:
        """A member below chunk granularity would idle — never spread one
        batch across more devices than it has chunks."""
        return self.n_chunks

    @property
    def done(self) -> bool:
        return self._epoch >= self.spec.epochs

    @property
    def losses(self) -> List[float]:
        return [e.loss for e in self.events]

    def plan_shares(self, profiles) -> Optional[List[int]]:
        """Eq. (4) chunk dispatch over the placement's (speed-scaled)
        profiles. ``None`` when the planner can't place (scheduler falls
        back to speed-weighted :func:`~repro_torch.fleet.elastic.assign_chunks`)."""
        from repro_torch.core.planner import plan_pure_dp

        if self._costs is None:
            from repro_torch.launch.costs import resolve_cost_model

            self._costs = resolve_cost_model(
                False, micro_batch=self.chunk, quant_bits=self.spec.quant,
            ).period_costs(self.spec.arch_config(), "pac_cached",
                           seq_len=self.spec.seq)
        plan = plan_pure_dp(self._costs, list(profiles), self.n_chunks, 1)
        if plan is None:
            return None
        return [int(s) for s in plan.stages[0].samples_per_device]

    # -- lifecycle ------------------------------------------------------------

    def open(self) -> "SessionJob":
        if self.session.cfg is None:
            from repro_torch.fleet.elastic import ElasticDpRunner

            s = self.session.open()
            self._elastic = ElasticDpRunner(
                s.backbone, s.cfg, r=self.spec.r, lr=self.spec.lr,
                kernel_impl=self.spec.kernels, chunk=self.chunk, device=s.device)
        return self

    def close(self) -> None:
        self._close_prefetcher()
        if self.session.cfg is not None:
            self.session.close()

    def finish(self) -> None:
        self._close_prefetcher()
        self.session.finish()

    def _close_prefetcher(self) -> None:
        if self._pf is not None:
            self._pf.close()
            self._pf = None

    def _arm_prefetcher(self) -> None:
        """Prefetch the *remaining* epoch order onto the host — called at
        epoch start and re-called after every reshard/resume mid-epoch."""
        from repro_torch.core.activation_cache import CachePrefetcher

        s = self.session
        rest = self._order[self._index:]
        if (self.spec.use_cache and rest
                and s.cache.covers(np.concatenate(rest), with_final=True)):
            self._pf = CachePrefetcher(
                s.cache, rest, to_device=False, dtype=None,
                compressed=self.spec.kernels == "cuda")

    # -- the one verb the scheduler calls per tick ----------------------------

    def run_step(self, placement: Sequence[Tuple[str, object, int]]) -> StepEvent:
        """Advance one step on ``placement`` (``[(member, device, share),
        ...]``, shares summing to :attr:`n_chunks`). Mutates session
        adapter/opt; returns the :class:`StepEvent`."""
        self.open()
        s = self.session
        t0 = time.perf_counter()
        if self._order is None:
            self._order = s.pipe.epoch_order(self._epoch)
            self._close_prefetcher()
            self._arm_prefetcher()

        names = tuple(n for n, _, _ in placement)
        if names != self._members_sig:
            self._elastic.reshard([(n, d) for n, d, _ in placement])
            if self._members_sig is not None:
                # a live placement changed under us: the prefetcher's
                # remaining order is still valid, but close + re-arm so the
                # worker thread never straddles a reshard (a closed
                # prefetcher refuses to be iterated)
                self.reshards += 1
                if self._pf is not None:
                    self._close_prefetcher()
                    self._arm_prefetcher()
            self._members_sig = names
            for h in self.hooks:
                h.on_reshard(s, list(names))

        ids = self._order[self._index]
        if self._pf is not None:
            hit = next(self._pf)
        elif self.spec.use_cache:
            hit = s.cache.get_batch(ids, with_final=True, dtype=None,
                                    compressed=self.spec.kernels == "cuda")
        else:
            hit = None

        if hit is None:
            # capture path: the frozen forward runs on the job's home
            # device exactly as a solo run would — byte-identical cache
            event = s.step(s.corpus.batch(ids), epoch=self._epoch,
                           index=self._index)
            event.mode = f"fleet {event.mode}"
            self.forward_steps += 1
        else:
            b0, taps, bf = hit
            labels = torch.from_numpy(s.corpus.batch(ids)["labels"]).to(s.device)
            cached = {"b0": b0, "taps": taps, "b_final": bf, "labels": labels}
            loss, s.adapter, s.opt = self._elastic.step(
                s.adapter, s.opt, cached, placement)
            event = StepEvent(
                epoch=self._epoch, index=self._index, loss=loss,
                cache_hit=True, mode=f"elastic dp{len(placement)}",
                wall_s=time.perf_counter() - t0)
            self.cached_steps += 1
        self.events.append(event)
        for h in self.hooks:
            h.on_step(s, event)

        self._index += 1
        if self._index >= len(self._order):
            self._epoch += 1
            self._index = 0
            self._order = None
            self._close_prefetcher()
        if self.done:
            self.state = "done"
            self.finish()
        return event

    # -- checkpointed preemption ----------------------------------------------

    def pause(self, snapshot_dir: Optional[str] = None):
        """Yield the devices: close the prefetcher, snapshot adapter +
        optimizer + cursor. Returns the snapshot (a path when
        ``snapshot_dir`` is given — checkpointed through
        :mod:`repro_torch.checkpoint`, surviving the process)."""
        self._close_prefetcher()
        self._members_sig = None        # force reshard on next placement
        self.state = "preempted"
        for h in self.hooks:
            h.on_preempt(self.session, False)
        extra = {"epoch": self._epoch, "index": self._index}
        if snapshot_dir is not None:
            os.makedirs(snapshot_dir, exist_ok=True)
            return self.session.save_snapshot(
                os.path.join(snapshot_dir, f"{self.name}.ckpt"), extra)
        return self.session.snapshot(extra)

    def resume(self, snap) -> None:
        """Adopt a :meth:`pause` snapshot (dict or path). The epoch order
        is a pure function of (seed, epoch), so the remaining batches
        replay exactly; restored trees round-trip bit-exactly."""
        self.open()
        if isinstance(snap, str):
            extra = self.session.restore_snapshot(snap)
        else:
            extra = self.session.restore(snap)
        self._epoch = int(extra["epoch"])
        self._index = int(extra["index"])
        self._order = None
        self.state = "queued"
        for h in self.hooks:
            h.on_preempt(self.session, True)
