"""LockSanitizer — runtime lock-order + reentrancy checking (opt-in).

The JAX package's linter proves lock discipline *statically* over
declared locks; this module is the dynamic half of the same contract:
wrap the locks you care about, run the workload (chaos drills do), then
``assert_clean()``. Three violation kinds:

- **order-inversion**: some thread acquired A then B while another
  acquisition path (any thread, this process) went B then A — the
  classic deadlock precondition, caught even when the interleaving
  never actually deadlocks in this run.
- **canonical-order**: an acquisition contradicts the declared fleet
  order (router -> engine -> scheduler -> pool;
  registry and faults locks are leaf-only).
- **non-reentrant-reacquire**: a thread re-acquires a plain
  ``threading.Lock`` it already holds. The sanitizer raises
  ``RuntimeError`` instead of letting the test hang forever (RLocks
  re-enter silently, as designed).

Hold/wait time is exported per lock so a scrape shows *which* lock a
stall lives under::

    san = faults.LockSanitizer(order=("router", "engine"))
    router._lock = san.wrap(router._lock, "router")
    ... drive traffic ...
    san.assert_clean()

Stdlib + paddle_tpu_torch.metrics only, like the rest of the package.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .. import metrics

__all__ = ["LockSanitizer", "LockViolation"]

_RLOCK_TYPE = type(threading.RLock())

_M_HOLD = metrics.get_registry().histogram(
    "paddle_tpu_lock_hold_seconds",
    "Time a sanitized lock was held, per acquisition", labels=("lock",),
    buckets=(1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0))
_M_WAIT = metrics.get_registry().histogram(
    "paddle_tpu_lock_wait_seconds",
    "Time a thread blocked waiting for a sanitized lock", labels=("lock",),
    buckets=(1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0))
_M_VIOLATIONS = metrics.get_registry().counter(
    "paddle_tpu_lock_order_violations_total",
    "Lock-discipline violations observed by LockSanitizer")


@dataclass(frozen=True)
class LockViolation:
    """One observed lock-discipline violation (deduplicated by
    ``(kind, locks)`` — the first witness wins)."""
    kind: str            # order-inversion | canonical-order | leaf-holds
    #                    # | non-reentrant-reacquire
    locks: Tuple[str, ...]
    thread: str
    detail: str

    def __str__(self) -> str:
        return (f"[{self.kind}] {' -> '.join(self.locks)} "
                f"(thread {self.thread}): {self.detail}")


@dataclass
class _HeldEntry:
    name: str
    t_acquired: float
    depth: int = 1       # RLock re-entry depth


class LockSanitizer:
    """Wrap locks, observe every acquisition, detect ordering hazards.

    ``order`` is the canonical acquisition sequence (outermost first);
    acquiring an earlier-ranked lock while holding a later-ranked one is
    a violation even if no reverse path was ever observed. ``leaves``
    are locks that must never be held across *any* other sanitized
    acquisition (the registry and faults locks in this repo).
    """

    def __init__(self, order: Sequence[str] = (),
                 leaves: Sequence[str] = ()):
        self._order: Dict[str, int] = {n: i for i, n in enumerate(order)}
        self._leaves = frozenset(leaves)
        self._meta = threading.Lock()
        # observed acquisition edges: (held, acquired) -> first witness
        self._edges: Dict[Tuple[str, str], str] = {}
        self._seen: set = set()        # violation dedup keys
        self.violations: List[LockViolation] = []
        self._tls = threading.local()

    # -- wiring -----------------------------------------------------------
    def wrap(self, lock, name: str) -> "_SanitizedLock":
        """Return a drop-in proxy for ``lock`` that reports to this
        sanitizer. Idempotent on already-wrapped locks."""
        if isinstance(lock, _SanitizedLock):
            return lock
        return _SanitizedLock(self, lock, name)

    def attach(self, obj, attr: str, name: Optional[str] = None):
        """``obj.attr = wrap(obj.attr)``; returns the original lock so a
        drill can restore it in ``finally`` (process-global locks stay
        usable after the drill)."""
        original = getattr(obj, attr)
        setattr(obj, attr, self.wrap(original, name or attr))
        return original

    # -- results ----------------------------------------------------------
    def report(self) -> str:
        with self._meta:
            vs = list(self.violations)
        if not vs:
            return "LockSanitizer: clean"
        lines = [f"LockSanitizer: {len(vs)} violation(s)"]
        lines += [f"  {v}" for v in vs]
        return "\n".join(lines)

    def assert_clean(self) -> None:
        with self._meta:
            vs = list(self.violations)
        if vs:
            raise AssertionError(self.report())

    # -- internals --------------------------------------------------------
    def _stack(self) -> List[_HeldEntry]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _record(self, kind: str, locks: Tuple[str, ...],
                detail: str) -> None:
        # direction-agnostic dedup: the a->b and b->a reports of one
        # inversion are the same hazard — the first witness carries
        # both sites in its detail
        key = (kind, tuple(sorted(locks)))
        with self._meta:
            if key in self._seen:
                return
            self._seen.add(key)
            self.violations.append(LockViolation(
                kind, locks, threading.current_thread().name, detail))
        _M_VIOLATIONS.inc()

    def _before_acquire(self, name: str, reentrant: bool) -> None:
        """Runs in the acquiring thread BEFORE the real acquire — so a
        guaranteed deadlock (non-reentrant re-acquire) raises instead of
        hanging the suite."""
        stack = self._stack()
        held_names = [e.name for e in stack]
        if name in held_names:
            if reentrant:
                return          # RLock re-entry: legal, no edges
            self._record(
                "non-reentrant-reacquire", (name, name),
                f"thread already holds non-reentrant lock `{name}`")
            raise RuntimeError(
                f"LockSanitizer: re-acquiring non-reentrant lock "
                f"{name!r} on the same thread would deadlock")
        me = threading.current_thread().name
        for held in held_names:
            if held == name:
                continue
            if held in self._leaves:
                self._record(
                    "leaf-holds", (held, name),
                    f"leaf-only lock `{held}` held while acquiring "
                    f"`{name}`")
            ra, rb = self._order.get(held), self._order.get(name)
            if ra is not None and rb is not None and rb < ra:
                self._record(
                    "canonical-order", (held, name),
                    f"acquired `{name}` (rank {rb}) while holding "
                    f"`{held}` (rank {ra}); canonical order is "
                    f"{tuple(self._order)}")
            witness = f"thread {me}: {held} -> {name}"
            with self._meta:
                self._edges.setdefault((held, name), witness)
                reverse = self._edges.get((name, held))
            if reverse is not None:
                self._record(
                    "order-inversion", (held, name),
                    f"{witness} inverts previously observed {reverse}")

    def _after_acquire(self, name: str, waited: float) -> None:
        stack = self._stack()
        for e in stack:
            if e.name == name:   # RLock re-entry
                e.depth += 1
                return
        stack.append(_HeldEntry(name, time.monotonic()))
        _M_WAIT.labels(lock=name).observe(waited)

    def _on_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].name == name:
                stack[i].depth -= 1
                if stack[i].depth == 0:
                    held = time.monotonic() - stack[i].t_acquired
                    del stack[i]
                    _M_HOLD.labels(lock=name).observe(held)
                return
        # release without a tracked acquire (lock handed across
        # threads): not an ordering hazard, just untracked — ignore.


class _SanitizedLock:
    """Duck-typed stand-in for ``threading.Lock``/``RLock`` — supports
    ``with``, ``acquire(blocking, timeout)``, ``release`` and
    ``locked``, reporting every transition to its sanitizer."""

    def __init__(self, sanitizer: LockSanitizer, inner, name: str):
        self._sanitizer = sanitizer
        self._inner = inner
        self._name = name
        self._reentrant = isinstance(inner, _RLOCK_TYPE)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._sanitizer._before_acquire(self._name, self._reentrant)
        t0 = time.monotonic()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._sanitizer._after_acquire(
                self._name, time.monotonic() - t0)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._sanitizer._on_release(self._name)

    def locked(self) -> bool:
        fn = getattr(self._inner, "locked", None)
        if fn is not None:
            return fn()
        # RLock grows .locked() only in newer CPythons; owned-by-me is
        # the closest honest answer for the duck type
        return bool(self._inner._is_owned())

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<SanitizedLock {self._name!r} over {self._inner!r}>"
