"""Queue-depth fleet autoscaler.

Counterpart of ``paddle_tpu/loadgen/autoscaler.py``, host code only.

Closes the control loop on signals the serving stack already exports:
per-engine queue depth (``scheduler.queue_depth``) and the step-time
EWMA (``engine.avg_step_s`` — the same estimate behind
``BackpressureError.retry_after_s``). The product of the two is
*backlog seconds* — how long the waiting queue will take to clear at
the current pace — and the mean waiting depth per healthy engine is the
scaling signal.

Policy:

- **Hysteresis** — a scale decision needs the signal past threshold for
  ``hot_steps`` / ``cold_steps`` CONSECUTIVE observations; one noisy
  sweep never moves the fleet, and the up/down thresholds are separated
  so an oscillating depth between them parks the scaler at ``steady``.
- **Cooldown** — after any topology change, ``cooldown_steps``
  observations must pass before the next one; a burst ramps the fleet
  one engine per cooldown window, not all at once.
- **Scale-up** — ``router.add_engine()``: one more replica stamped from
  the model's construction spec. On a card the newcomer captures a
  CUDA graph per bucket it meets and builds no kernel (the process
  built them once); ``tools/serve_fleet.py``'s autoscale drill holds
  it to that.
- **Scale-down, drain-then-remove ONLY** — pick the least-loaded
  healthy engine, ``router.drain()`` it (waiting work requeues onto
  siblings exactly-once; in-flight work finishes locally), keep
  observing until it is empty, then ``router.remove_engine()``. No
  request is ever dropped to shed capacity. If the signal goes hot
  while draining, the drain CANCELS (``router.undrain``) — capacity in
  hand beats capacity in flight.

The scaler is a passive observer: call :meth:`QueueDepthAutoscaler.observe`
once per ``router.step()`` sweep (the load driver does). It never steps
engines itself and is safe to leave attached at zero load.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .. import metrics
from ..serving import router as _router_mod

__all__ = ["AutoscalerConfig", "QueueDepthAutoscaler"]

# every decision observe() can return — pre-created as counter label
# children so dashboards see explicit zeros (and tests can enumerate)
DECISIONS = ("steady", "scale-up", "scale-down", "draining",
             "cancel-drain", "cooldown")


@dataclass(frozen=True)
class AutoscalerConfig:
    """Scaling policy knobs. Thresholds are MEAN WAITING DEPTH PER
    HEALTHY ENGINE; ``scale_up_depth`` must sit strictly above
    ``scale_down_depth`` (the hysteresis band — a signal oscillating
    inside it never moves the fleet)."""

    min_engines: int = 1
    max_engines: int = 4
    scale_up_depth: float = 4.0      # mean waiting/engine above -> hot
    scale_down_depth: float = 0.5    # mean waiting/engine below -> cold
    hot_steps: int = 3               # consecutive hot observations to grow
    cold_steps: int = 8              # consecutive cold observations to shrink
    cooldown_steps: int = 10         # observations between topology changes

    def __post_init__(self):
        if self.min_engines < 1:
            raise ValueError("min_engines must be >= 1")
        if self.max_engines < self.min_engines:
            raise ValueError("max_engines must be >= min_engines")
        if self.scale_up_depth <= self.scale_down_depth:
            raise ValueError(
                "scale_up_depth must be strictly greater than "
                "scale_down_depth (the hysteresis band)")
        if self.hot_steps < 1 or self.cold_steps < 1:
            raise ValueError("hot_steps and cold_steps must be >= 1")
        if self.cooldown_steps < 0:
            raise ValueError("cooldown_steps must be >= 0")


class QueueDepthAutoscaler:
    """Drives :meth:`Router.add_engine` / ``drain`` / ``remove_engine``
    from queue-depth observations (see module docstring)::

        scaler = QueueDepthAutoscaler(router, config=AutoscalerConfig())
        while router.has_work:
            router.step()
            scaler.observe()

    ``observe()`` returns the decision string it counted (one of
    ``DECISIONS``) so drivers and tests can assert the trajectory."""

    def __init__(self, router, model: Optional[str] = None,
                 config: Optional[AutoscalerConfig] = None):
        self._router = router
        self._model = router._resolve_model(model)
        self.config = config or AutoscalerConfig()
        self._hot = 0                     # consecutive hot observations
        self._cold = 0                    # consecutive cold observations
        self._cooldown = 0                # observations left to sit out
        self._drain_target: Optional[str] = None
        self.events: list = []            # (decision, engine_id) history
        reg = metrics.get_registry()
        self._m_engines = reg.gauge(
            "paddle_tpu_autoscaler_engines",
            "Engines currently registered for the autoscaled model",
            labels=("model_id",))
        self._m_signal = reg.gauge(
            "paddle_tpu_autoscaler_backlog_seconds",
            "Fleet backlog: sum over healthy engines of waiting queue "
            "depth x step-time EWMA — how long the waiting work takes "
            "to clear at the current pace", labels=("model_id",))
        self._m_events = reg.counter(
            "paddle_tpu_autoscaler_scale_events_total",
            "Topology changes the autoscaler made",
            labels=("model_id", "direction"))
        self._m_decisions = reg.counter(
            "paddle_tpu_autoscaler_decisions_total",
            "observe() outcomes by decision",
            labels=("model_id", "decision"))
        for d in ("up", "down"):
            self._m_events.labels(model_id=self._model, direction=d)
        for d in DECISIONS:
            self._m_decisions.labels(model_id=self._model, decision=d)
        self._m_engines.labels(model_id=self._model).set(
            len(router.handles(self._model)))

    # ------------------------------------------------------------- signals
    def signal(self) -> float:
        """Mean waiting-queue depth per healthy engine (the scaling
        signal), also refreshing the backlog-seconds gauge. Non-healthy
        engines are excluded: a draining engine's residual work must
        not read as demand (it is capacity leaving, not load arriving)."""
        handles = self._router.handles(self._model)
        healthy = [h for h in handles
                   if h.state == _router_mod.HEALTHY]
        self._m_engines.labels(model_id=self._model).set(len(handles))
        if not healthy:
            self._m_signal.labels(model_id=self._model).set(0.0)
            return 0.0
        backlog = 0.0
        depth = 0
        for h in healthy:
            try:
                d = int(h.engine.scheduler.queue_depth)
                backlog += d * float(h.engine.avg_step_s)
                depth += d
            except Exception:
                pass  # unreadable engine: the router's health gate owns it
        self._m_signal.labels(model_id=self._model).set(backlog)
        return depth / len(healthy)

    @property
    def engine_count(self) -> int:
        return len(self._router.handles(self._model))

    # -------------------------------------------------------------- control
    def observe(self) -> str:
        """One control tick: read the signal, update hysteresis counters,
        maybe move the fleet. Call once per ``router.step()`` sweep."""
        decision = self._decide()
        self._m_decisions.labels(model_id=self._model,
                                 decision=decision).inc()
        if decision in ("scale-up", "scale-down", "cancel-drain"):
            self.events.append((decision, self.engine_count))
        return decision

    def _decide(self) -> str:
        cfg = self.config
        sig = self.signal()
        hot = sig > cfg.scale_up_depth
        cold = sig < cfg.scale_down_depth
        self._hot = self._hot + 1 if hot else 0
        self._cold = self._cold + 1 if cold else 0

        # an in-progress drain preempts everything: finish or cancel it
        # before reading the hysteresis counters for a NEW action
        if self._drain_target is not None:
            return self._continue_drain(hot)

        if self._cooldown > 0:
            self._cooldown -= 1
            return "cooldown"

        n = self.engine_count
        if self._hot >= cfg.hot_steps and n < cfg.max_engines:
            eid = self._router.add_engine(self._model)
            self._after_event("up", eid)
            return "scale-up"
        if self._cold >= cfg.cold_steps and n > cfg.min_engines:
            self._drain_target = self._pick_drain_target()
            if self._drain_target is not None:
                self._router.drain(self._drain_target)
                return "draining"
        return "steady"

    def _continue_drain(self, hot: bool) -> str:
        """Advance (or cancel) an in-progress drain-then-remove."""
        eid = self._drain_target
        states = self._router.states()
        if eid not in states:
            # removed out from under us (operator action): just reset
            self._drain_target = None
            return "steady"
        if hot:
            # demand came back mid-drain: the capacity we were about to
            # retire is needed — cancel, return the engine to rotation
            self._router.undrain(eid)
            self._drain_target = None
            self._after_event_counters_only()
            return "cancel-drain"
        try:
            empty = not self._router.engine(eid).has_work
        except Exception:
            empty = False  # unreadable: keep waiting, router contains it
        if empty and states.get(eid) == _router_mod.DRAINING:
            self._router.remove_engine(eid)
            self._drain_target = None
            self._after_event("down", eid)
            return "scale-down"
        return "draining"

    def _pick_drain_target(self) -> Optional[str]:
        """Least-loaded healthy engine — retiring it strands the least
        in-flight work and requeues the least waiting work."""
        healthy = [h for h in self._router.handles(self._model)
                   if h.state == _router_mod.HEALTHY]
        if len(healthy) <= self.config.min_engines:
            return None
        best = min(healthy, key=lambda h: self._safe_score(h))
        return best.engine_id

    @staticmethod
    def _safe_score(h) -> float:
        try:
            return float(h.engine.load_score())
        except Exception:
            return float("inf")  # unreadable engine: never pick it

    def _after_event(self, direction: str, engine_id: str) -> None:
        self._m_events.labels(model_id=self._model,
                              direction=direction).inc()
        self._m_engines.labels(model_id=self._model).set(self.engine_count)
        self._after_event_counters_only()

    def _after_event_counters_only(self) -> None:
        self._cooldown = self.config.cooldown_steps
        self._hot = 0
        self._cold = 0
