"""paddle_tpu_torch.faults: fault injection and the resilience primitives.

Counterpart of ``paddle_tpu/faults/`` (its own copy of the jax-free
modules):

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
- **TrainSentinel** (sentinel.py): self-healing training: per-step
  health verdicts (OK / SKIP / ROLLBACK / abort) over loss and grad-norm
  detectors, last-known-good marks, rollback with a deterministic skip
  past the quarantined batches, and ``guard(step_fn)`` for custom loops.

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
from .sentinel import (Action, SentinelAbort, SentinelConfig, StepReport,
                       TrainSentinel)
from .signals import SignalScope, install_signal_handler
from .watchdog import StepWatchdog

__all__ = [
    "Action", "SentinelAbort", "SentinelConfig", "StepReport",
    "TrainSentinel", "CallbackError", "Deadline", "DeadlineExceeded",
    "FaultInjected", "FaultSpec", "LockSanitizer", "LockViolation", "ResourceExhausted",
    "SignalScope", "StepWatchdog", "active_faults", "backoff_delays",
    "declare_point", "inject", "install_signal_handler", "known_points",
    "point", "reset", "retry",
]
