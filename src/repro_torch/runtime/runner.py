"""EpochRunner — the epoch loop as a generator of typed records
(counterpart of ``repro.runtime.runner``).

Each epoch yields its :class:`~repro_torch.runtime.session.StepEvent`\\ s
and closes with an :class:`EpochReport`; observers attach as
:class:`RunHooks`. :class:`ConsoleHook` prints the reference trainer's
per-epoch line in the reference's format::

    epoch 0: loss=4.1234 time=1.2s (full) cache[8 seqs, 3 MB, f32]
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterator, List, Union

from repro_torch.runtime.session import EdgeSession, StepEvent


@dataclass
class EpochReport:
    """One epoch's outcome."""

    epoch: int
    losses: List[float] = field(default_factory=list)
    time_s: float = 0.0
    used_cache: bool = False
    mode: str = "full"
    steps: int = 0

    @property
    def mean_loss(self) -> float:
        return float(sum(self.losses) / max(1, len(self.losses)))


class RunHooks:
    """Observer interface for a run: override what you need (all no-ops)."""

    def on_epoch_start(self, session: EdgeSession, epoch: int) -> None:
        pass

    def on_step(self, session: EdgeSession, event: StepEvent) -> None:
        pass

    def on_epoch_end(self, session: EdgeSession, report: EpochReport) -> None:
        pass

    # -- fleet lifecycle (repro_torch.fleet) — no-ops for plain runs -----------

    def on_reshard(self, session: EdgeSession, members: List[str]) -> None:
        """Pool membership changed under a running job: the job now
        executes on ``members`` (fleet member names, in placement order)."""

    def on_preempt(self, session: EdgeSession, resumed: bool) -> None:
        """The scheduler snapshotted this job off its devices
        (``resumed=False``) or brought it back (``resumed=True``)."""


class ConsoleHook(RunHooks):
    """The trainer CLI's per-epoch summary line."""

    def __init__(self, print_fn=print):
        self._print = print_fn

    def on_epoch_end(self, session: EdgeSession, report: EpochReport) -> None:
        cache = session.cache
        self._print(
            f"epoch {report.epoch}: loss={report.mean_loss:.4f} "
            f"time={report.time_s:.1f}s ({report.mode}) "
            f"cache[{len(cache)} seqs, {cache.nbytes/2**20:.0f} MB, "
            f"{session.spec.cache_compress}]")


class EpochRunner:
    """Drives ``spec.epochs`` epochs of an opened :class:`EdgeSession`."""

    def __init__(self, session: EdgeSession, hooks=()):
        self.session = session
        self.hooks = list(hooks)

    def run_epoch(self, epoch: int) -> Iterator[Union[StepEvent, EpochReport]]:
        """Every StepEvent of ``epoch``, then its EpochReport (last)."""
        s = self.session
        for h in self.hooks:
            h.on_epoch_start(s, epoch)
        report = EpochReport(epoch=epoch)
        t0 = time.perf_counter()
        # epoch_scope arms the prefetcher (when the epoch is fully
        # cache-resident) as a context manager: an exception mid-epoch
        # joins the worker thread instead of leaking it
        with s.epoch_scope(epoch):
            for i, batch in enumerate(s.pipe.epoch(epoch)):
                event = s.step(batch, epoch=epoch, index=i)
                report.losses.append(event.loss)
                report.used_cache = report.used_cache or event.cache_hit
                report.steps += 1
                for h in self.hooks:
                    h.on_step(s, event)
                yield event
        report.time_s = time.perf_counter() - t0
        report.mode = s.mode(report.used_cache)
        for h in self.hooks:
            h.on_epoch_end(s, report)
        yield report

    def events(self) -> Iterator[Union[StepEvent, EpochReport]]:
        """All epochs: StepEvents interleaved with one EpochReport each."""
        for epoch in range(self.session.spec.epochs):
            yield from self.run_epoch(epoch)

    def epochs(self) -> Iterator[EpochReport]:
        """One EpochReport per epoch (hooks still fire per step)."""
        for rec in self.events():
            if isinstance(rec, EpochReport):
                yield rec

    def run(self) -> List[EpochReport]:
        return list(self.epochs())
