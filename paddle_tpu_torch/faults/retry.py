"""Generic retry with exponential backoff + deterministic jitter.

The recovery half of the faults package: transient failures (a compile
hiccup, a flaky RPC, an injected drill) are retried on a seeded backoff
schedule — deterministic for a fixed seed, so chaos tests replay
bit-identically and never sleep wall-clock time they didn't budget
(``sleep=`` is injectable). A :class:`~.deadline.Deadline` bounds the
whole retry loop: no attempt starts past it, and no backoff sleeps
through it.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type

from .. import metrics
from .deadline import Deadline, DeadlineExceeded

__all__ = ["backoff_delays", "retry"]

_M_RETRIES = metrics.get_registry().counter(
    "paddle_tpu_faults_retries_total",
    "Retry attempts taken after a retryable failure (first tries not "
    "counted)")


def backoff_delays(attempts: int, *, base_delay_s: float = 0.05,
                   factor: float = 2.0, max_delay_s: float = 2.0,
                   jitter: float = 0.5, seed: int = 0) -> Iterator[float]:
    """Yield the ``attempts - 1`` sleep durations between attempts:
    ``base * factor**k`` capped at ``max_delay_s``, each scaled by a
    seeded uniform draw from ``[1-jitter, 1+jitter]`` (decorrelates
    thundering-herd retries; deterministic per seed)."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    if not 0.0 <= jitter < 1.0:
        raise ValueError("jitter must be in [0, 1)")
    rng = random.Random(seed)
    for k in range(attempts - 1):
        d = min(base_delay_s * factor ** k, max_delay_s)
        if jitter:
            d *= rng.uniform(1.0 - jitter, 1.0 + jitter)
        yield min(d, max_delay_s)


def retry(fn: Callable, *, attempts: int = 3,
          retry_on: Tuple[Type[BaseException], ...] = (Exception,),
          base_delay_s: float = 0.05, factor: float = 2.0,
          max_delay_s: float = 2.0, jitter: float = 0.5, seed: int = 0,
          deadline: Optional[Deadline] = None,
          sleep: Callable[[float], None] = time.sleep,
          on_retry: Optional[Callable[[int, BaseException], None]] = None):
    """Call ``fn()`` up to ``attempts`` times; backoff between failures.

    The final failure re-raises the original exception unchanged (no
    wrapper type to unwrap). A ``deadline`` turns exhaustion-by-time into
    :class:`DeadlineExceeded` with the last failure chained as cause.
    ``on_retry(attempt_index, exc)`` observes each scheduled retry.
    """
    delays = list(backoff_delays(attempts, base_delay_s=base_delay_s,
                                 factor=factor, max_delay_s=max_delay_s,
                                 jitter=jitter, seed=seed))
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded(
                f"retry deadline exceeded after {attempt} attempt(s)"
            ) from last
        try:
            return fn()
        except retry_on as e:
            last = e
            if attempt == attempts - 1:
                raise
            _M_RETRIES.inc()
            if on_retry is not None:
                on_retry(attempt, e)
            d = delays[attempt]
            if deadline is not None:
                d = min(d, max(deadline.remaining(), 0.0))
            if d > 0:
                sleep(d)
    raise AssertionError("unreachable")  # pragma: no cover
