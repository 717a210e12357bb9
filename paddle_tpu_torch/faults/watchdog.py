"""Step watchdog: detect stalled engine steps and hold a degraded state.

The health half of the faults package (the state
machine): the engine brackets each step with ``begin_step()`` /
``end_step(duration)``. An over-threshold step *trips* the watchdog
(``end_step`` returns True exactly on the healthy→tripped transition, so
``watchdog_trips_total`` counts episodes, not slow steps); it recovers
after ``recovery_steps`` consecutive healthy steps. ``stalled_now()``
answers from ANY thread — a ``/healthz`` scrape sees a step that is
still running past the threshold as degraded without waiting for it to
return, which is the only way to observe a genuinely hung step in-band.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["StepWatchdog"]


class StepWatchdog:
    """Trip on a step slower than ``stall_threshold_s``; recover after
    ``recovery_steps`` consecutive healthy steps. ``clock=`` injectable
    for deterministic tests."""

    def __init__(self, stall_threshold_s: float = 30.0,
                 recovery_steps: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if stall_threshold_s <= 0:
            raise ValueError("stall_threshold_s must be > 0")
        if recovery_steps < 1:
            raise ValueError("recovery_steps must be >= 1")
        self.stall_threshold_s = float(stall_threshold_s)
        self.recovery_steps = int(recovery_steps)
        self._clock = clock
        self._lock = threading.Lock()
        self._in_step_since: Optional[float] = None
        self._tripped = False
        self._healthy_streak = 0
        self._trips = 0

    # -- engine-thread protocol -------------------------------------------
    def begin_step(self) -> None:
        with self._lock:
            self._in_step_since = self._clock()

    def end_step(self, duration_s: Optional[float] = None) -> bool:
        """Record one finished step; returns True only on a NEW trip
        (healthy→tripped transition). ``duration_s=None`` measures from
        the matching ``begin_step``."""
        with self._lock:
            t0, self._in_step_since = self._in_step_since, None
            if duration_s is None:
                duration_s = 0.0 if t0 is None else self._clock() - t0
            if duration_s > self.stall_threshold_s:
                self._healthy_streak = 0
                newly = not self._tripped
                self._tripped = True
                if newly:
                    self._trips += 1
                return newly
            if self._tripped:
                self._healthy_streak += 1
                if self._healthy_streak >= self.recovery_steps:
                    self._tripped = False
                    self._healthy_streak = 0
            return False

    # -- any-thread queries -----------------------------------------------
    def stalled_now(self) -> bool:
        """True while a step is CURRENTLY running past the threshold —
        the live-hang detector a health scrape relies on."""
        with self._lock:
            return (self._in_step_since is not None
                    and self._clock() - self._in_step_since
                    > self.stall_threshold_s)

    @property
    def tripped(self) -> bool:
        return self._tripped

    @property
    def trips(self) -> int:
        """Trip episodes since construction (not slow-step count)."""
        return self._trips

    def status(self) -> str:
        """``"ok"`` | ``"degraded"`` (tripped, or a step is live-hung)."""
        return "degraded" if (self._tripped or self.stalled_now()) else "ok"
