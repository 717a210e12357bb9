"""paddle_tpu_torch.loadgen: trace-driven load harness and fleet autoscaler.

Counterpart of ``paddle_tpu/loadgen``, over the port's router and
engines:

- :mod:`~.trace`: seeded, deterministic request streams (Zipf-shared
  prompt prefixes, Poisson and burst arrivals, heavy-tail lengths, SLO
  tiers, slow consumers) on a :class:`VirtualClock`; the same
  :class:`TraceConfig` gives the JAX package's trace.
- :mod:`~.driver`: replays a trace against a ``Router`` paced on
  ``router.step()``, consumes the seq-numbered streams with
  exactly-once accounting and scores a :class:`LoadReport` from the
  metrics registry.
- :mod:`~.autoscaler`: the queue-depth :class:`QueueDepthAutoscaler`
  (``router.add_engine`` / ``drain`` / ``remove_engine``, hysteresis and
  cooldown, scale-down strictly drain-then-remove).
- :mod:`~.chaos`: a seeded :class:`FaultSchedule` (engine kills with
  timed revival, injected step latency) on the trace's clock.
- :mod:`~.restart`: the kill-the-process drill (a WAL-armed child fleet
  SIGKILLed mid-decode and recovered with fewer engines).

::

    from paddle_tpu_torch import loadgen
    from paddle_tpu_torch.serving import Router

    router = Router()
    router.add_model("m", model, replicas=1, page_size=16)
    trace = loadgen.generate_trace(loadgen.TraceConfig(
        seed=0, num_requests=64, burst_start=1.0, burst_duration=3.0))
    scaler = loadgen.QueueDepthAutoscaler(
        router, config=loadgen.AutoscalerConfig(max_engines=3))
    report = loadgen.LoadDriver(router, trace, autoscaler=scaler).run()
    assert report.exactly_once, report.violations
"""
from .autoscaler import AutoscalerConfig, QueueDepthAutoscaler
from .chaos import FaultEvent, FaultSchedule
from .driver import LoadDriver, LoadReport, TierReport
from .restart import run_restart_drill, streams_by_index
from .trace import (DEFAULT_TIERS, TierSpec, Trace, TraceConfig,
                    TraceRequest, VirtualClock, generate_trace, zipf_pmf)

__all__ = [
    "AutoscalerConfig", "QueueDepthAutoscaler",
    "FaultEvent", "FaultSchedule",
    "LoadDriver", "LoadReport", "TierReport",
    "DEFAULT_TIERS", "TierSpec", "Trace", "TraceConfig", "TraceRequest",
    "VirtualClock", "generate_trace", "zipf_pmf",
    "run_restart_drill", "streams_by_index",
]
