"""Deterministic fault injection: named points + scoped, seeded schedules.

The chaos half of resilience: production code marks
failure-prone sites with ``faults.point("serving.decode_step")`` — a
no-op costing one empty-list check until a test or drill *arms* a fault
there:

    with faults.inject("serving.kv_alloc",
                       raise_=faults.ResourceExhausted, times=1):
        engine.run()          # ONE allocation fails; the engine must
                              # quarantine the victim and keep draining

Schedules compose from ``times`` (fire at most N times), ``every``
(every Nth eligible hit), ``after`` (skip the first N hits), and ``p``
(seeded probability gate) — all deterministic for a fixed seed, so a
chaos run replays bit-identically. Modes compose too: ``call=`` runs a
host callback (e.g. poison a KV page), ``delay_s=`` injects latency,
``raise_=`` throws (class or instance) — in that order, so one spec can
corrupt state AND stall AND fail.

Hermetic by construction: ``inject`` is a context manager over a
process-global spec list; on exit the spec is disarmed, so tier-1 tests
can't leak faults into each other. Every firing increments
``paddle_tpu_faults_injected_total{point}`` — chaos tests assert the
telemetry alongside the behavior.

Stdlib + paddle_tpu_torch.metrics only: importable from every layer without
jax or import cycles.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import metrics

__all__ = [
    "CallbackError", "FaultInjected", "FaultSpec", "ResourceExhausted",
    "active_faults", "declare_point", "inject", "known_points", "point",
    "reset",
]


class FaultInjected(RuntimeError):
    """Default exception raised by an armed ``raise_`` fault — a distinct
    type so handlers (and test asserts) can tell drills from real bugs."""


class ResourceExhausted(FaultInjected):
    """Canned resource-exhaustion simulation (page pool, HBM, fds)."""


class CallbackError(RuntimeError):
    """A user-supplied callback raised; the original is chained as
    ``__cause__``. Raised by ``CompletionAPI._chunk_cb`` so the engine's
    callback isolation can attribute the failure to user code."""


_lock = threading.RLock()
_active: List["FaultSpec"] = []
_catalog: Dict[str, str] = {}

_M_INJECTED = metrics.get_registry().counter(
    "paddle_tpu_faults_injected_total",
    "Faults fired by the injection framework", labels=("point",))


class FaultSpec:
    """One armed fault: where (``point``), what (``call``/``delay_s``/
    ``raise_``), when (``times``/``every``/``after``/``p`` + ``seed``)."""

    __slots__ = ("point", "raise_", "delay_s", "call", "times", "every",
                 "after", "p", "hits", "fired", "_rng")

    def __init__(self, point: str, *, raise_=None, delay_s: float = 0.0,
                 call: Optional[Callable[[], None]] = None,
                 times: Optional[int] = None, every: int = 1,
                 after: int = 0, p: Optional[float] = None, seed: int = 0):
        if raise_ is None and not delay_s and call is None:
            raise ValueError("armed fault must do something: pass raise_, "
                             "delay_s, and/or call")
        if every < 1:
            raise ValueError("every must be >= 1")
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError("p must be in [0, 1]")
        self.point = str(point)
        self.raise_ = raise_
        self.delay_s = float(delay_s)
        self.call = call
        self.times = None if times is None else int(times)
        self.every = int(every)
        self.after = int(after)
        self.p = p
        self.hits = 0     # point() evaluations seen
        self.fired = 0    # times actually fired
        self._rng = random.Random(seed) if p is not None else None

    def _advance_hit(self) -> bool:
        """Advance the schedule one hit and report eligibility (caller
        holds the module lock). ``fired`` is NOT marked here — it is
        claimed at execution time, so a batch-mate spec that raises
        first can never strand this spec's accounting."""
        self.hits += 1
        if self.hits <= self.after:
            return False
        if (self.hits - self.after - 1) % self.every != 0:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self._rng is not None and self._rng.random() >= self.p:
            return False
        return True

    def _claim_fire(self) -> bool:
        """Claim one firing against the ``times`` cap (caller holds the
        module lock); False if a concurrent point() used it up."""
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True

    def __repr__(self) -> str:
        mode = []
        if self.call is not None:
            mode.append("call")
        if self.delay_s:
            mode.append(f"delay={self.delay_s}")
        if self.raise_ is not None:
            mode.append("raise")
        return (f"FaultSpec({self.point!r}, {'+'.join(mode)}, "
                f"fired={self.fired}, hits={self.hits})")


def point(name: str) -> None:
    """Named fault site. Free when nothing is armed — one empty-list
    check, no lock — so production hot paths can afford it."""
    if not _active:
        return
    with _lock:
        eligible = [spec for spec in _active
                    if spec.point == name and spec._advance_hit()]
    # every eligible spec runs its call/delay and counts, even when an
    # earlier spec also wants to raise — the (first) raise is deferred
    # to the end so one armed exception can't strand a batch-mate
    # spec's accounting or side effects
    pending: Optional[BaseException] = None
    for spec in eligible:
        with _lock:
            if not spec._claim_fire():
                continue
        _M_INJECTED.labels(point=name).inc()
        if spec.call is not None:
            spec.call()
        if spec.delay_s:
            time.sleep(spec.delay_s)
        if spec.raise_ is not None and pending is None:
            exc = spec.raise_
            if isinstance(exc, type):
                exc = exc(f"fault injected at point {name!r}")
            pending = exc
    if pending is not None:
        raise pending


class inject:
    """Context manager arming one :class:`FaultSpec` for its scope.

    ``with faults.inject("serving.decode_step", delay_s=0.05): ...``
    The spec object is returned (``as spec``) so tests can assert
    ``spec.fired``. Nesting arms multiple specs; exit disarms exactly
    the one this scope armed.
    """

    def __init__(self, point: str, **kw):
        self.spec = FaultSpec(point, **kw)

    def __enter__(self) -> FaultSpec:
        with _lock:
            _active.append(self.spec)
        return self.spec

    def __exit__(self, *exc) -> None:
        with _lock:
            try:
                _active.remove(self.spec)
            except ValueError:
                pass


def active_faults() -> List[FaultSpec]:
    """Currently armed specs (copy)."""
    with _lock:
        return list(_active)


def reset() -> None:
    """Disarm everything — belt-and-braces test teardown."""
    with _lock:
        _active.clear()


def declare_point(name: str, description: str = "") -> str:
    """Register a fault point in the catalog (``known_points()`` reads
    it). Call at import time
    next to the subsystem that owns the ``point()`` site."""
    with _lock:
        _catalog[str(name)] = str(description)
    return name


def known_points() -> Dict[str, str]:
    """Declared fault points: name -> description."""
    with _lock:
        return dict(_catalog)
