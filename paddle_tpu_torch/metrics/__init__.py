"""paddle_tpu_torch.metrics: always-on, low-overhead telemetry.

Counterpart of ``paddle_tpu/metrics/`` (its own copy: the port imports
nothing of the JAX package). Typed instruments that are always recording
and cost nanoseconds per sample, exported as Prometheus text or a JSON
snapshot; the serving engine, its pool and prefix cache, the fault
points and the request tracer register here under the same
``paddle_tpu_*`` names as in the JAX package, so one dashboard reads
either.

    from paddle_tpu_torch import metrics

    reg = metrics.get_registry()
    reqs = reg.counter("paddle_tpu_serving_requests_total",
                       "Requests by lifecycle event", labels=("event",))
    reqs.labels(event="admitted").inc()
    print(reg.expose_prometheus())
    metrics.MetricsServer(port=9100).start()   # GET /metrics, /healthz

``get_registry().disable()`` reduces every sample to a flag check.
"""
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       exponential_buckets, get_registry,
                       sanitize_metric_name, time_histogram)
from .server import MetricsServer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsServer",
    "exponential_buckets", "get_registry", "sanitize_metric_name",
    "time_histogram",
]
