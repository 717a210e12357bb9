"""Chaos-in-the-loop load testing: a seeded fault schedule that rides a
trace replay.

Counterpart of ``paddle_tpu/loadgen/chaos.py``. The trace makes traffic
deterministic; this module makes the *incident* deterministic too. A :class:`FaultSchedule` is a
sorted list of :class:`FaultEvent` pinned to VIRTUAL trace time —
engine kills (with timed revival) and injected step latency (via the
``paddle_tpu.faults`` registry's ``serving.step`` point) — that
:class:`~.driver.LoadDriver` applies as its clock sweeps past each
event's instant. Same seed → same trace → same faults at the same
arrivals, so ``LoadReport`` scores goodput-under-chaos reproducibly
and a brownout-armed run and its control face byte-identical weather.

Kills never black out the fleet: an event whose victim would be the
last healthy engine is skipped (and recorded as skipped) — total
outage is a different drill than overload, and a blacked-out fleet
scores nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import faults
from ..serving import router as _router_mod

__all__ = ["FaultEvent", "FaultSchedule"]


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault, pinned to virtual trace time ``t_s``.

    ``kind="kill"``: mark the ``engine_index``-th healthy engine of the
    governed model down at ``t_s`` (waiting work requeues, in-flight
    work migrates — the router's containment path) and return it to
    rotation ``down_s`` virtual seconds later (``down_s <= 0`` = stays
    dead). ``kind="latency"``: arm a ``faults.inject("serving.step",
    delay_s=..., times=...)`` so the next ``steps`` engine steps each
    pay ``delay_s`` of injected wall time — the step-time EWMA (and so
    the overload signal) sees a genuinely slower fleet."""

    t_s: float
    kind: str                      # "kill" | "latency"
    engine_index: int = 0          # kill: index into healthy handles
    down_s: float = 0.0            # kill: revive after this long
    delay_s: float = 0.0           # latency: injected delay per step
    steps: int = 1                 # latency: steps the delay persists

    def __post_init__(self):
        if self.kind not in ("kill", "latency"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.t_s < 0:
            raise ValueError("t_s must be >= 0")


class FaultSchedule:
    """Ordered fault events + the applier the load driver calls once
    per sweep. One schedule instance is single-use (it tracks what has
    fired); build a fresh one per run — :meth:`generate` with the same
    seed yields an identical schedule."""

    def __init__(self, events: List[FaultEvent]):
        self.events = sorted(events, key=lambda e: e.t_s)
        self._cursor = 0
        self._revivals: List[Tuple[float, str]] = []  # (t_due, engine_id)
        self.applied: List[Tuple[float, str, str]] = []   # history
        self.skipped: List[Tuple[float, str, str]] = []

    @classmethod
    def generate(cls, seed: int, t_start: float, t_end: float,
                 kills: int = 1, down_s: float = 2.0,
                 latency_bursts: int = 1, delay_s: float = 0.02,
                 burst_steps: int = 8) -> "FaultSchedule":
        """Seeded schedule: ``kills`` engine kills and
        ``latency_bursts`` slow-step windows, instants drawn uniformly
        in ``[t_start, t_end)`` from one ``default_rng(seed)`` — the
        same determinism contract as ``generate_trace``."""
        if t_end <= t_start:
            raise ValueError("t_end must be > t_start")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for _ in range(int(kills)):
            t = float(rng.uniform(t_start, t_end))
            idx = int(rng.integers(0, 8))
            events.append(FaultEvent(t_s=t, kind="kill", engine_index=idx,
                                     down_s=float(down_s)))
        for _ in range(int(latency_bursts)):
            t = float(rng.uniform(t_start, t_end))
            events.append(FaultEvent(t_s=t, kind="latency",
                                     delay_s=float(delay_s),
                                     steps=int(burst_steps)))
        return cls(events)

    # --------------------------------------------------------------- apply
    def apply(self, router, model: Optional[str], now_v: float,
              stack) -> None:
        """Fire every event (and revival) due at virtual time
        ``now_v``. ``stack`` is the driver's ``contextlib.ExitStack``:
        latency injections enter it so every armed spec is disarmed
        when the run ends, even on an exception."""
        while (self._revivals
               and self._revivals[0][0] <= now_v):
            _, eid = self._revivals.pop(0)
            try:
                router.undrain(eid)
                self.applied.append((now_v, "revive", eid))
            except Exception:
                self.skipped.append((now_v, "revive", eid))
        while (self._cursor < len(self.events)
               and self.events[self._cursor].t_s <= now_v):
            ev = self.events[self._cursor]
            self._cursor += 1
            if ev.kind == "kill":
                self._kill(router, model, ev, now_v)
            else:
                stack.enter_context(faults.inject(
                    "serving.step", delay_s=ev.delay_s, times=ev.steps))
                self.applied.append(
                    (now_v, "latency",
                     f"{ev.delay_s}s x {ev.steps} steps"))

    def _kill(self, router, model, ev: FaultEvent, now_v: float) -> None:
        healthy = [h for h in router.handles(model)
                   if h.state == _router_mod.HEALTHY]
        if len(healthy) <= 1:
            # never black out the fleet: a zero-healthy-engine drill
            # measures nothing but the blackout itself
            self.skipped.append((now_v, "kill", "last-healthy-engine"))
            return
        victim = healthy[ev.engine_index % len(healthy)]
        router.mark_down(victim.engine_id)
        self.applied.append((now_v, "kill", victim.engine_id))
        if ev.down_s > 0:
            self._revivals.append((now_v + ev.down_s, victim.engine_id))
            self._revivals.sort()
