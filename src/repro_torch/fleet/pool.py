"""DevicePool — fleet membership, health, and the member→device map
(counterpart of ``repro.fleet.pool``).

The pool is the scheduler's single source of truth about *who is
available right now*. Each member pairs a planner
:class:`~repro_torch.core.planner.DeviceProfile` with liveness state:

* **heartbeats** — a healthy member heartbeats every tick; a *killed*
  device silently stops, and :meth:`check_timeouts` reports it lost only
  once ``heartbeat_timeout`` of (simulated) time has passed — the
  detection latency a real fleet pays, made deterministic by
  :class:`~repro_torch.fleet.clock.SimClock`.
* **speed factors** — a straggler keeps its membership but its
  ``effective_profile`` scales FLOP/s down, so the planner's Eq. (4)
  dispatch automatically deweights it at the next re-plan.
* **device slots** — members map to torch devices by a stable slot
  index assigned at join time (:meth:`DevicePool.torch_device`: slot
  *k* is ``cuda:k`` when that card exists). ``capacity`` bounds
  concurrent members; slots are recycled so a fleet can see more joins
  than it has slots over its lifetime. With ``bind_devices=False``
  members stay logical on the pool's base device. Members whose slots
  exceed the cards present share the base device too, so on one card
  several members run on it: placement and resharding are exercised,
  transfers between cards are not.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.planner import JETSON_NANO_H, DeviceProfile
from repro_torch.fleet.clock import Clock, SimClock


@dataclass
class DeviceMember:
    """One fleet device: planner profile + liveness."""

    name: str
    profile: DeviceProfile = JETSON_NANO_H
    speed: float = 1.0
    slot: int = -1             # cuda:{slot} when bound and present; -1 = unbound
    last_heartbeat: float = 0.0

    def effective_profile(self) -> DeviceProfile:
        """The profile the planner prices: FLOP/s scaled by the current
        straggler factor (memory/bandwidth unchanged)."""
        if self.speed == 1.0:
            return self.profile
        return dataclasses.replace(
            self.profile,
            name=f"{self.profile.name}*{self.speed:g}",
            flops=self.profile.flops * self.speed,
        )


class DevicePool:
    """Mutable fleet membership with heartbeat-based failure detection.
    ``device``: the pool's base device (``None`` is the card; with no
    card only an explicit ``"cpu"`` runs)."""

    def __init__(
        self,
        members: Sequence[DeviceMember] = (),
        *,
        clock: Optional[Clock] = None,
        heartbeat_timeout: float = 2.0,
        capacity: Optional[int] = None,
        bind_devices: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.clock = clock if clock is not None else SimClock()
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.bind_devices = bind_devices
        self._members: Dict[str, DeviceMember] = {}
        self._dead: set = set()       # killed, waiting for timeout detection
        self._free_slots: List[int] = []
        self._next_slot = 0
        self.capacity = capacity
        self.generation = 0           # bumped on every membership change
        for m in members:
            self.add(m)

    # -- membership ---------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._members

    def __len__(self) -> int:
        return len(self._members)

    def member(self, name: str) -> DeviceMember:
        return self._members[name]

    def alive(self) -> List[str]:
        """Member names in stable (join) order. Includes killed-but-not-
        yet-detected devices — exactly what a real scheduler sees."""
        return list(self._members)

    def add(self, member: DeviceMember) -> DeviceMember:
        if member.name in self._members:
            raise ValueError(f"device {member.name!r} already in the pool")
        if self.capacity is not None and len(self._members) >= self.capacity:
            raise ValueError(
                f"pool at capacity {self.capacity}; {member.name!r} cannot join")
        if self.bind_devices and member.slot < 0:
            if self._free_slots:
                member.slot = self._free_slots.pop()
            else:
                member.slot = self._next_slot
                self._next_slot += 1
        member.last_heartbeat = self.clock.now()
        self._members[member.name] = member
        self._dead.discard(member.name)
        self.generation += 1
        return member

    def remove(self, name: str) -> DeviceMember:
        """Graceful leave (or post-detection eviction)."""
        m = self._members.pop(name)
        self._dead.discard(name)
        if m.slot >= 0:
            self._free_slots.append(m.slot)
        self.generation += 1
        return m

    # -- health -------------------------------------------------------------

    def heartbeat(self, name: str) -> None:
        self._members[name].last_heartbeat = self.clock.now()

    def heartbeat_all(self) -> None:
        """One simulation tick's worth of heartbeats — every member that
        has not been killed reports in."""
        now = self.clock.now()
        for name, m in self._members.items():
            if name not in self._dead:
                m.last_heartbeat = now

    def kill(self, name: str) -> None:
        """Abrupt loss: the device stops heartbeating but stays a member
        until :meth:`check_timeouts` detects it."""
        if name not in self._members:
            raise KeyError(name)
        self._dead.add(name)

    def mark_slow(self, name: str, factor: float) -> None:
        if factor <= 0:
            raise ValueError(f"speed factor must be > 0, got {factor}")
        self._members[name].speed = float(factor)
        self.generation += 1

    def check_timeouts(self) -> List[str]:
        """Evict every member whose last heartbeat is older than the
        timeout; returns the names detected lost (in join order)."""
        now = self.clock.now()
        lost = [
            name for name, m in self._members.items()
            if now - m.last_heartbeat > self.heartbeat_timeout
        ]
        for name in lost:
            self.remove(name)
        return lost

    # -- planner / runtime views --------------------------------------------

    def profiles(self, names: Optional[Sequence[str]] = None) -> List[DeviceProfile]:
        """Speed-scaled profiles for the planner's placement pricing."""
        names = self.alive() if names is None else list(names)
        return [self._members[n].effective_profile() for n in names]

    def torch_device(self, name: str) -> torch.device:
        """The torch device a member's work runs on: ``cuda:{slot}`` for a
        bound member when the base device is a card and that card exists;
        else (unbound members, ``bind_devices=False`` pools, slots beyond
        the cards present) the base device — the reference's
        ``devices[0]`` rule."""
        slot = self._members[name].slot
        if self.device.type == "cuda" and 0 <= slot < torch.cuda.device_count():
            return torch.device("cuda", slot)
        return self.device
