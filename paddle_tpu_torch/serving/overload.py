"""The shared queue-drain predictor behind ``retry_after_s``.

Counterpart of ``paddle_tpu/serving/overload.py``'s
:class:`DrainEstimator`, the part the engine uses: a full bounded queue
rejects with :class:`~.scheduler.BackpressureError`, whose
``retry_after_s`` hint is this estimator's prediction. The overload
controller, the retry budget and the shed error of the JAX module build
on its router and are not ported yet.
"""
from __future__ import annotations

__all__ = ["DrainEstimator"]


class DrainEstimator:
    """The one queue-drain / TTFT predictor.

    ``predict_wait_s(depth, avg_step_s)`` estimates how long a request
    arriving now waits before first service: every queued request ahead
    of it costs about one step-time EWMA to clear, floored at
    ``floor_s`` so clients never busy-spin. The same number is the
    ``retry_after_s`` hint."""

    def __init__(self, floor_s: float = 0.05):
        if floor_s <= 0.0:
            raise ValueError("floor_s must be > 0")
        self.floor_s = float(floor_s)

    def predict_wait_s(self, queue_depth: int, avg_step_s: float) -> float:
        return max(self.floor_s, float(queue_depth) * float(avg_step_s))

    def for_engine(self, engine) -> float:
        """Prediction from a live engine's queue depth and step EWMA."""
        return self.predict_wait_s(engine.scheduler.queue_depth,
                                   engine.avg_step_s)
