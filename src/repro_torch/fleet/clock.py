"""Deterministic time for the fleet layer (counterpart of
``repro.fleet.clock``, copied: the port imports nothing of ``repro``).

Failure handling is time-based (heartbeat timeouts), but CI must replay
every failure path identically — so the scheduler never reads the wall
clock directly. It reads a :class:`Clock`, and the simulation harness
hands it a :class:`SimClock` advanced a fixed ``dt`` per scheduler tick:
a device that stops heartbeating at tick *k* is detected at exactly tick
``k + ceil(timeout / dt)``, on every machine, every run.
"""

from __future__ import annotations

import time


class Clock:
    """Readable time source (seconds, monotonic)."""

    def now(self) -> float:
        raise NotImplementedError


class WallClock(Clock):
    """Real deployments: monotonic wall time."""

    def now(self) -> float:
        return time.perf_counter()


class SimClock(Clock):
    """Virtual time, advanced explicitly — the simulation default."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards (dt={dt})")
        self._t += float(dt)
        return self._t
