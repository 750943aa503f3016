"""Pool events: the pluggable failure/arrival source (counterpart of
``repro.fleet.events``; a plan file of either package loads in the other,
and ``FaultPlan.random`` draws in the reference's order, so one seed
gives one script in both).

The scheduler consumes membership changes through one seam —
:class:`PoolEvents.poll(tick)` — so the deterministic CI harness
(:class:`ScriptedEvents` over a :class:`FaultPlan`) and a real
deployment's monitor are interchangeable. A :class:`FaultPlan` is a
list of :class:`FleetEvent` records pinned to scheduler *tick* indices
(step boundaries — the only points the runtime can react anyway, since
a step is atomic), JSON round-trippable for replay, and
generatable from a seed for property tests.

Event kinds:

``join``    device (re)joins the pool
``leave``   graceful departure — removed immediately
``kill``    abrupt loss — the device stops heartbeating and is only
            *detected* when the pool's heartbeat timeout elapses
``slow``    straggler: the device's speed factor drops to ``factor``
            (1.0 restores full speed; feeds the planner's deweighting)
``submit``  a job named ``job`` arrives in the scheduler queue
"""

from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Protocol, Sequence

EVENT_KINDS = ("join", "leave", "kill", "slow", "submit")


@dataclass(frozen=True)
class FleetEvent:
    """One scripted pool/queue change at a step boundary."""

    tick: int
    kind: str
    device: Optional[str] = None
    job: Optional[str] = None
    factor: float = 1.0  # "slow" only: new speed multiplier

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"kind must be one of {EVENT_KINDS}, got {self.kind!r}")
        if self.kind == "submit":
            if self.job is None:
                raise ValueError("submit events need job=")
        elif self.device is None:
            raise ValueError(f"{self.kind} events need device=")
        if self.kind == "slow" and self.factor <= 0:
            raise ValueError(f"slow factor must be > 0, got {self.factor}")


class PoolEvents(Protocol):
    """Anything that feeds membership/arrival changes to the scheduler."""

    def poll(self, tick: int) -> List[FleetEvent]:
        ...


@dataclass
class FaultPlan:
    """An ordered, replayable event script."""

    events: List[FleetEvent]

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: (e.tick, EVENT_KINDS.index(e.kind), e.device or "", e.job or ""))

    @property
    def last_tick(self) -> int:
        return max((e.tick for e in self.events), default=-1)

    def at(self, tick: int) -> List[FleetEvent]:
        return [e for e in self.events if e.tick == tick]

    # -- JSON round-trip -----------------------------------------------------

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(
            {"version": 1, "events": [asdict(e) for e in self.events]},
            indent=indent, sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        if d.get("version") != 1:
            raise ValueError(f"unsupported fault-plan version {d.get('version')!r}")
        return cls([FleetEvent(**e) for e in d["events"]])

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- seeded generation (property tests) ----------------------------------

    @classmethod
    def random(
        cls,
        seed: int,
        devices: Sequence[str],
        *,
        n_events: int = 8,
        max_tick: int = 16,
        jobs: Sequence[str] = (),
    ) -> "FaultPlan":
        """Deterministic pseudo-random plan over ``devices`` (and optional
        job submissions): the same seed always yields the same script, so
        a failing property-test example stays failing while it is fixed."""
        rng = random.Random(seed)
        kinds = ["join", "leave", "kill", "slow"] + (["submit"] if jobs else [])
        events: List[FleetEvent] = []
        for _ in range(n_events):
            kind = rng.choice(kinds)
            tick = rng.randrange(max_tick)
            if kind == "submit":
                events.append(FleetEvent(tick, "submit", job=rng.choice(list(jobs))))
            elif kind == "slow":
                events.append(FleetEvent(
                    tick, "slow", device=rng.choice(list(devices)),
                    factor=rng.choice([0.25, 0.5, 1.0])))
            else:
                events.append(FleetEvent(tick, kind, device=rng.choice(list(devices))))
        return cls(events)


class ScriptedEvents:
    """A :class:`FaultPlan` as a :class:`PoolEvents` source. Each tick is
    delivered at most once (polling the same tick twice returns [])."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._delivered: Dict[int, bool] = {}

    def poll(self, tick: int) -> List[FleetEvent]:
        if self._delivered.get(tick):
            return []
        self._delivered[tick] = True
        return self.plan.at(tick)

    @property
    def exhausted(self) -> bool:
        return all(
            self._delivered.get(e.tick, False) for e in self.plan.events
        )
