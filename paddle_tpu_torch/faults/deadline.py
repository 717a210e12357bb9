"""Deadline: an absolute time budget on an injectable clock.

The serving stack's cancellation currency: a
request carries ``Deadline(deadline_s)`` from enqueue; the engine sweeps
expired deadlines every step and retires them with
``finish_reason="timeout"``. ``clock=`` is injectable so tests drive
expiry deterministically (a fake clock, or a negative budget for
"already expired") instead of sleeping.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

__all__ = ["Deadline", "DeadlineExceeded"]


class DeadlineExceeded(TimeoutError):
    """A time budget ran out (``Deadline.check`` / ``retry(deadline=)``)."""


class Deadline:
    """Absolute expiry instant computed at construction: ``seconds=None``
    never expires (``Deadline.never()``); ``seconds<=0`` is already
    expired. Monotonic by default — wall-clock jumps don't cancel work."""

    __slots__ = ("_t_end", "_clock")

    def __init__(self, seconds: Optional[float] = None, *,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._t_end = None if seconds is None else clock() + float(seconds)

    @classmethod
    def never(cls) -> "Deadline":
        return cls(None)

    @property
    def unbounded(self) -> bool:
        return self._t_end is None

    def remaining(self) -> float:
        """Seconds left (may be negative once expired; +inf if unbounded)."""
        if self._t_end is None:
            return math.inf
        return self._t_end - self._clock()

    def expired(self) -> bool:
        return self._t_end is not None and self._clock() >= self._t_end

    def check(self, what: str = "") -> None:
        """Raise :class:`DeadlineExceeded` if the budget ran out."""
        if self.expired():
            raise DeadlineExceeded(
                f"deadline exceeded{' in ' + what if what else ''} "
                f"(over by {-self.remaining():.3f}s)")

    def __repr__(self) -> str:
        if self._t_end is None:
            return "Deadline(never)"
        return f"Deadline(remaining={self.remaining():.3f}s)"
