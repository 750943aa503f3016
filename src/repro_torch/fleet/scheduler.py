"""FleetScheduler — the job queue over a shared, flaky device pool
(counterpart of ``repro.fleet.scheduler``: the same admission,
reconcile, preemption and placement, in the same order).

One tick = one step boundary (the atom of scheduling: a step cannot be
interrupted). Each tick the scheduler

1. polls its :class:`~repro_torch.fleet.events.PoolEvents` source and applies
   join/leave/slow/kill/submit to the pool and queue,
2. heartbeats the healthy members and evicts heartbeat-timeout losses
   (a killed device is detected ``ceil(timeout/dt)`` ticks later —
   deterministic under :class:`~repro_torch.fleet.clock.SimClock`),
3. reconciles placements with the surviving membership (a job whose
   placement shrank keeps running on the survivors — the elastic runner
   makes that numerically invisible; a job that lost *every* device goes
   back to the queue head, state intact),
4. preempts any job that exhausted its ``quantum`` while others wait
   (checkpointed: :meth:`~repro_torch.fleet.job.SessionJob.pause` snapshots
   adapter+optimizer+cursor, to disk when ``snapshot_dir`` is set) —
   FIFO admission + quantum expiry bound every job's wait, so a full
   pool never starves the queue,
5. places queued jobs onto the fastest free members — chunk shares
   priced by the paper's Eq. (4) dispatch over speed-scaled profiles
   (``job.plan_shares``), so stragglers are deweighted by the same
   planner that sized the pool — and grows running jobs onto idle
   devices when nobody waits,
6. runs one step of every placed job, in placement order.

Everything observable lands in a :class:`TickRecord`; :meth:`run` loops
until queue+pool are quiescent and the event script is exhausted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.fleet.elastic import assign_chunks
from repro_torch.fleet.events import FleetEvent, PoolEvents
from repro_torch.fleet.pool import DeviceMember, DevicePool


@dataclass(frozen=True)
class Placement:
    """One job's current device subset and its Eq. (4) chunk shares."""

    job: str
    devices: Tuple[str, ...]
    shares: Tuple[int, ...]
    since_tick: int        # when these devices were granted (quantum base)


@dataclass
class TickRecord:
    """Everything that happened in one scheduler tick."""

    tick: int
    events: List[FleetEvent] = field(default_factory=list)
    lost: List[str] = field(default_factory=list)
    preempted: List[str] = field(default_factory=list)
    placements: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    shares: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    steps: Dict[str, float] = field(default_factory=dict)   # job -> loss
    queued: List[str] = field(default_factory=list)


@dataclass
class FleetReport:
    """The whole simulation, tick by tick."""

    ticks: List[TickRecord] = field(default_factory=list)
    rejected: List[str] = field(default_factory=list)

    @property
    def n_ticks(self) -> int:
        return len(self.ticks)

    def job_steps(self, name: str) -> int:
        return sum(1 for t in self.ticks if name in t.steps)

    def first_step_tick(self, name: str) -> Optional[int]:
        for t in self.ticks:
            if name in t.steps:
                return t.tick
        return None

    def losses(self, name: str) -> List[float]:
        return [t.steps[name] for t in self.ticks if name in t.steps]


class FleetScheduler:
    """Admission, placement, elastic re-planning, and preemption."""

    def __init__(self, pool: DevicePool, *, events: Optional[PoolEvents] = None,
                 quantum: Optional[int] = None, tick_dt: float = 1.0,
                 snapshot_dir: Optional[str] = None, max_ticks: int = 10_000,
                 log=None):
        if quantum is not None and quantum < 1:
            raise ValueError(f"quantum must be >= 1 tick, got {quantum}")
        self.pool = pool
        self.events = events
        self.quantum = quantum
        self.tick_dt = float(tick_dt)
        self.snapshot_dir = snapshot_dir
        self.max_ticks = max_ticks
        self._log = log if log is not None else (lambda *a: None)
        self.jobs: Dict[str, object] = {}
        self._queue: List[str] = []
        self._running: Dict[str, Placement] = {}
        self._snaps: Dict[str, object] = {}    # preempted jobs' snapshots
        self._tick = 0
        self._priced_gen = -1
        self.report = FleetReport()

    # -- admission ------------------------------------------------------------

    def register(self, job) -> None:
        """Make a job known (so a FaultPlan ``submit`` event can queue it
        by name) without queueing it yet."""
        self.jobs[job.name] = job

    def submit(self, job=None, name: Optional[str] = None) -> bool:
        """Admit a job (by object or registered name). Returns False —
        and marks the job ``rejected`` — when the pool can *never* place
        it (min_devices exceeds pool capacity)."""
        if job is not None:
            self.jobs[job.name] = job
            name = job.name
        job = self.jobs[name]
        cap = self.pool.capacity
        if cap is not None and job.min_devices > cap:
            job.state = "rejected"
            self.report.rejected.append(name)
            self._log(f"[fleet] {name}: rejected "
                      f"(needs {job.min_devices} devices, pool capacity {cap})")
            return False
        if name not in self._queue and name not in self._running:
            self._queue.append(name)
            job.state = "queued"
        return True

    # -- event application ----------------------------------------------------

    def _apply(self, e: FleetEvent) -> None:
        pool = self.pool
        if e.kind == "join":
            if e.device not in pool:
                try:
                    pool.add(DeviceMember(e.device))
                except ValueError:          # at capacity
                    self._log(f"[fleet] join {e.device} dropped: pool full")
        elif e.kind == "leave":
            if e.device in pool:
                pool.remove(e.device)
        elif e.kind == "kill":
            if e.device in pool:
                pool.kill(e.device)
        elif e.kind == "slow":
            if e.device in pool:
                pool.mark_slow(e.device, e.factor)
        elif e.kind == "submit":
            self.submit(name=e.job)

    # -- placement ------------------------------------------------------------

    def _fastest(self, names: List[str], want: int) -> Tuple[str, ...]:
        ranked = sorted(
            names,
            key=lambda n: -self.pool.member(n).effective_profile().flops)
        return tuple(ranked[:want])

    def _shares(self, job, devices: Tuple[str, ...]) -> Tuple[int, ...]:
        shares = job.plan_shares(self.pool.profiles(devices))
        if shares is None:
            shares = assign_chunks(
                job.n_chunks, len(devices),
                [self.pool.member(d).speed for d in devices])
        return tuple(int(s) for s in shares)

    def _place(self, name: str, devices: Tuple[str, ...]) -> None:
        job = self.jobs[name]
        self._running[name] = Placement(
            name, devices, self._shares(job, devices), self._tick)
        job.state = "running"
        self._log(f"[fleet] t{self._tick} place {name} on "
                  f"{','.join(devices)} shares="
                  f"{list(self._running[name].shares)}")

    def _free(self) -> List[str]:
        used = {d for pl in self._running.values() for d in pl.devices}
        return [m for m in self.pool.alive() if m not in used]

    def _reconcile(self) -> None:
        """Membership or speed changed: shrink placements to survivors
        (re-pricing shares) and requeue jobs that lost everything."""
        if self.pool.generation == self._priced_gen:
            return
        members = set(self.pool.alive())
        for name, pl in list(self._running.items()):
            kept = tuple(d for d in pl.devices if d in members)
            job = self.jobs[name]
            if not kept:
                del self._running[name]
                self._queue.insert(0, name)   # head: it lost its turn to a fault
                job.state = "queued"
                self._log(f"[fleet] t{self._tick} {name}: all devices lost, requeued")
            else:
                # survivors keep running; always re-price — a speed change
                # (straggler) moves shares even when membership didn't
                self._running[name] = Placement(
                    name, kept, self._shares(job, kept), pl.since_tick)
        self._priced_gen = self.pool.generation

    def _maybe_preempt(self, rec: TickRecord) -> None:
        if self.quantum is None or not self._queue:
            return
        for name, pl in list(self._running.items()):
            if self._tick - pl.since_tick >= self.quantum:
                job = self.jobs[name]
                self._snaps[name] = job.pause(self.snapshot_dir)
                del self._running[name]
                self._queue.append(name)
                rec.preempted.append(name)
                self._log(f"[fleet] t{self._tick} preempt {name} "
                          f"(quantum {self.quantum})")

    def _schedule(self) -> None:
        if self._queue and self._running:
            # elastic shrink: running jobs give back devices above their
            # fair share so arrivals run concurrently instead of waiting
            # out the head (placements keep their fastest members)
            total = len(self.pool.alive())
            fair = max(1, total // (len(self._running) + len(self._queue)))
            for name, pl in list(self._running.items()):
                keep_n = max(fair, self.jobs[name].min_devices)
                if len(pl.devices) > keep_n:
                    kept = pl.devices[:keep_n]
                    self._running[name] = Placement(
                        name, kept, self._shares(self.jobs[name], kept),
                        pl.since_tick)
        free = self._free()
        while self._queue and free:
            name = self._queue[0]
            job = self.jobs[name]
            # fair split of the free pool across the whole queue — nobody
            # waits behind a head that grabbed everything
            want = min(job.max_devices,
                       max(job.min_devices, len(free) // len(self._queue)))
            want = min(want, len(free))
            if want < job.min_devices:
                break        # FIFO: the head waits, nobody bypasses it
            self._queue.pop(0)
            if name in self._snaps:
                job.resume(self._snaps.pop(name))
            devices = self._fastest(free, want)
            self._place(name, devices)
            free = [m for m in free if m not in set(devices)]
        # idle capacity + empty queue: grow running jobs (elastic DP up)
        if free and not self._queue:
            for name, pl in list(self._running.items()):
                job = self.jobs[name]
                room = job.max_devices - len(pl.devices)
                if room <= 0 or not free:
                    continue
                extra = self._fastest(free, min(room, len(free)))
                devices = pl.devices + extra
                self._running[name] = Placement(
                    name, devices, self._shares(job, devices), pl.since_tick)
                free = [m for m in free if m not in set(extra)]

    # -- the loop -------------------------------------------------------------

    @property
    def tick_index(self) -> int:
        return self._tick

    @property
    def quiescent(self) -> bool:
        """Nothing queued or running, and no future scripted events."""
        exhausted = (self.events is None
                     or getattr(self.events, "exhausted", True))
        return not self._queue and not self._running and exhausted

    def tick(self) -> TickRecord:
        """One step boundary: events → health → reconcile → preempt →
        schedule → one step per placed job."""
        rec = TickRecord(tick=self._tick)
        if self.events is not None:
            rec.events = self.events.poll(self._tick)
            for e in rec.events:
                self._apply(e)
        self.pool.heartbeat_all()
        rec.lost = self.pool.check_timeouts()
        self._reconcile()
        self._maybe_preempt(rec)
        self._schedule()
        for name in list(self._running):
            job, pl = self.jobs[name], self._running[name]
            placement = [
                (d, self.pool.torch_device(d) if self.pool.bind_devices else None, s)
                for d, s in zip(pl.devices, pl.shares)]
            rec.placements[name] = pl.devices
            rec.shares[name] = pl.shares
            event = job.run_step(placement)
            rec.steps[name] = event.loss
            if job.done:
                del self._running[name]
                self._log(f"[fleet] t{self._tick} {name}: done "
                          f"(final loss {event.loss:.4f})")
        rec.queued = list(self._queue)
        self.report.ticks.append(rec)
        advance = getattr(self.pool.clock, "advance", None)
        if advance is not None:
            advance(self.tick_dt)       # SimClock: virtual time, per tick
        self._tick += 1
        return rec

    def run(self, max_ticks: Optional[int] = None) -> FleetReport:
        """Tick until quiescent (or the tick budget runs out — queued
        jobs then simply stay queued; the property tests re-run after
        restoring capacity)."""
        limit = self.max_ticks if max_ticks is None else max_ticks
        for _ in range(limit):
            self.tick()
            if self.quiescent:
                break
        return self.report
