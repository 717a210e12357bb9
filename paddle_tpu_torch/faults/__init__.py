"""paddle_tpu_torch.faults: fault injection and the resilience primitives.

Counterpart of ``paddle_tpu/faults/`` (its own copy of the jax-free
modules), the serving half:

- **Fault points** (injection.py): failure-prone sites are marked with
  ``faults.point("serving.kv_alloc")``, free until a test arms a fault
  there with ``faults.inject(...)`` (raise once or every N hits, delay,
  resource exhaustion, a host callback, on seeded schedules). Every
  firing counts in ``paddle_tpu_faults_injected_total{point}``.
- **retry** (retry.py): exponential backoff with seeded jitter, an
  injectable sleep and an optional deadline; the last failure re-raises.
- **Deadline** (deadline.py): an absolute time budget on an injectable
  clock, the currency of request timeouts.
- **LockSanitizer** (sanitizer.py): an opt-in instrumented lock that
  reports lock-order inversions and non-reentrant re-acquisition.
- **StepWatchdog** (watchdog.py): trips on an over-threshold engine
  step, sees a live hang from any thread, recovers after N healthy steps;
  the state behind ``/healthz``.
- **Signals** (signals.py): scoped handler installation.

The JAX package's ``TrainSentinel`` (self-healing training) is not
ported yet.

    from paddle_tpu_torch import faults

    with faults.inject("serving.step", delay_s=0.05):
        engine.step()               # watchdog trips; /healthz -> 503

Stdlib and ``paddle_tpu_torch.metrics`` only.
"""
from .deadline import Deadline, DeadlineExceeded
from .injection import (CallbackError, FaultInjected, FaultSpec,
                        ResourceExhausted, active_faults, declare_point,
                        inject, known_points, point, reset)
from .retry import backoff_delays, retry
from .sanitizer import LockSanitizer, LockViolation
from .signals import SignalScope, install_signal_handler
from .watchdog import StepWatchdog

__all__ = [
    "CallbackError", "Deadline", "DeadlineExceeded", "FaultInjected",
    "FaultSpec", "LockSanitizer", "LockViolation", "ResourceExhausted",
    "SignalScope", "StepWatchdog", "active_faults", "backoff_delays",
    "declare_point", "inject", "install_signal_handler", "known_points",
    "point", "reset", "retry",
]
