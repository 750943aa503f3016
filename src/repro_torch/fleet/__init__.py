"""Fleet scheduling: many fine-tuning jobs on one shared edge pool
(counterpart of ``repro.fleet``, over the port's
:class:`~repro_torch.runtime.EdgeSession`).

N users' jobs arrive continuously on a shared, *flaky* fleet —
heterogeneous devices that join, leave, slow down, and die without
warning. This package is the online layer on top of the planner and
the runtime:

* :mod:`~repro_torch.fleet.clock` — a deterministic simulation clock, so
  every failure path replays identically (no wall-clock flakiness).
* :mod:`~repro_torch.fleet.events` — :class:`FaultPlan`: scripted
  join/leave/slow/kill/submit events at step boundaries (seedable random
  plans for property tests; the reference's JSON), behind the
  :class:`PoolEvents` source protocol.
* :mod:`~repro_torch.fleet.pool` — :class:`DevicePool`: fleet membership,
  heartbeats (a killed device stops heartbeating and is detected after a
  deterministic timeout), straggler speed factors, and the mapping from
  member names to torch devices.
* :mod:`~repro_torch.fleet.elastic` — :class:`ElasticDpRunner`: the
  elastic pure-DP cached train step. Cached epochs have no backbone
  forward, so device loss is a *resharding* problem: work moves between
  members with **bit-identical** numerics under any layout
  (canonical-order chunk accumulation).
* :mod:`~repro_torch.fleet.job` — :class:`SessionJob`: one fine-tuning
  job (an :class:`~repro_torch.runtime.EdgeSession` driven step by step)
  with checkpointed preemption via the session's snapshot/restore seam.
* :mod:`~repro_torch.fleet.scheduler` — :class:`FleetScheduler`: the job
  queue. Admission, planner-priced placement onto device subsets,
  re-planning on every membership change, quantum-based preemption so a
  full pool never starves the queue.

CLI: ``python -m repro_torch.launch.fleet --simulate``.
"""

from repro_torch.fleet.clock import SimClock
from repro_torch.fleet.events import FaultPlan, FleetEvent, PoolEvents, ScriptedEvents
from repro_torch.fleet.pool import DeviceMember, DevicePool
from repro_torch.fleet.elastic import ElasticDpRunner, assign_chunks, slice_cached
from repro_torch.fleet.job import SessionJob
from repro_torch.fleet.scheduler import FleetReport, FleetScheduler, Placement, TickRecord

__all__ = [
    "SimClock",
    "FaultPlan",
    "FleetEvent",
    "PoolEvents",
    "ScriptedEvents",
    "DeviceMember",
    "DevicePool",
    "ElasticDpRunner",
    "assign_chunks",
    "slice_cached",
    "SessionJob",
    "FleetScheduler",
    "FleetReport",
    "Placement",
    "TickRecord",
]
