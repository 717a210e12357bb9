"""Overload as a failure mode: the shed decision, the brownout ladder, the
retry budget.

Counterpart of ``paddle_tpu/serving/overload.py``. Host code only; every
action it takes is planning data for the engines (admission, chunk
sizes, draft gating, which slots are preempted), so no token-grid
bucket and no step program is added by it, and a stream it delays comes
out as it would unloaded (tokens are keyed by (seed, position)).

- :class:`DrainEstimator`: the one queue-drain / TTFT predictor (queue
  depth x the step-time EWMA). It gives both
  ``BackpressureError.retry_after_s`` and the admission gate's
  prediction, so the hint and the shed decision agree.
- :class:`OverloadController`: deadline-aware admission (doomed work is
  shed with :class:`AdmissionShedError` before it queues) and the
  brownout ladder (``LEVELS``): under sustained backlog it pauses
  speculative drafts, caps the batch tier's prompt chunks, preempts
  batch-tier decode slots (journal and requeue, the migration move
  turned inward) and admits the interactive tier only; it walks back
  down as pressure clears, with hot/cold step counters and a cooldown
  as hysteresis.
- :class:`RetryBudget`: a per-model token bucket the router spends from
  on every requeue or migration, so a failover storm cannot amplify
  load; a dry bucket retires the request ``"unavailable"``.

Call :meth:`OverloadController.observe` once per ``router.step()``.
Engines consult the attached controller at admission and when they plan
a step; detaching it restores stock behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import metrics
from .scheduler import BackpressureError

__all__ = [
    "AdmissionShedError",
    "DrainEstimator",
    "LEVELS",
    "OverloadConfig",
    "OverloadController",
    "RetryBudget",
]

# the brownout ladder, mildest first — level N applies actions 1..N
LEVELS = (
    "normal",            # 0: no degradation
    "drafts-paused",     # 1: speculative drafts leftover -> 0
    "chunks-capped",     # 2: batch-tier prefill chunk budget shrunk
    "batch-parked",      # 3: batch decode slots preempted (journal+requeue)
    "interactive-only",  # 4: admission restricted to interactive tier
)

# every decision observe() can return — pre-created as counter label
# children so dashboards see explicit zeros (mirrors the autoscaler)
DECISIONS = ("steady", "escalate", "de-escalate", "cooldown")

# shed causes, pre-created the same way
SHED_CAUSES = ("deadline", "brownout")


class AdmissionShedError(BackpressureError):
    """Raised at submit when the overload controller refuses a request.

    Subclasses :class:`BackpressureError` so existing catch sites keep
    working; ``retry_after_s`` carries the SAME prediction that caused
    the shed (one estimator, one truth). ``cause`` is ``"deadline"``
    (predicted TTFT exceeds the request's deadline) or ``"brownout"``
    (ladder at interactive-only and the request is a lower tier)."""

    def __init__(self, message: str, retry_after_s: float,
                 queue_depth: int, cause: str):
        super().__init__(message, retry_after_s, queue_depth)
        self.cause = cause


class DrainEstimator:
    """The one shared queue-drain / TTFT predictor.

    ``predict_wait_s(depth, avg_step_s)`` estimates how long a request
    arriving NOW waits before first service: every queued request ahead
    of it costs about one step-time EWMA to clear. The same number is
    the honest ``retry_after_s`` hint — "come back when the backlog you
    would sit behind has drained"."""

    def __init__(self, floor_s: float = 0.05):
        if floor_s <= 0.0:
            raise ValueError("floor_s must be > 0")
        self.floor_s = float(floor_s)

    def predict_wait_s(self, queue_depth: int, avg_step_s: float) -> float:
        return max(self.floor_s, float(queue_depth) * float(avg_step_s))

    def for_engine(self, engine) -> float:
        """Prediction from a live engine's own signal surface."""
        return self.predict_wait_s(engine.scheduler.queue_depth,
                                   engine.avg_step_s)


class RetryBudget:
    """Per-model token bucket gating router requeue/migration retries.

    Every failover placement (requeue of waiting work, migration of
    in-flight work off a dead engine) spends one token from the model's
    bucket; :meth:`refill` restores ``refill_per_step`` tokens per
    router sweep up to ``capacity``. During steady operation the bucket
    is full and failover is free; during an incident storm the bucket
    empties and further retries fail fast to ``"unavailable"`` instead
    of amplifying load with re-dispatch churn."""

    def __init__(self, capacity: float = 32.0, refill_per_step: float = 1.0):
        if capacity <= 0.0:
            raise ValueError("capacity must be > 0")
        if refill_per_step < 0.0:
            raise ValueError("refill_per_step must be >= 0")
        self.capacity = float(capacity)
        self.refill_per_step = float(refill_per_step)
        self._tokens: Dict[str, float] = {}

    def tokens(self, model_id: str) -> float:
        return self._tokens.get(model_id, self.capacity)

    def try_take(self, model_id: str) -> bool:
        """Spend one token; False (and no spend) when the bucket is dry."""
        have = self._tokens.get(model_id, self.capacity)
        if have < 1.0:
            return False
        self._tokens[model_id] = have - 1.0
        return True

    def refill(self) -> None:
        """One router sweep's worth of budget back, every model."""
        for mid, have in list(self._tokens.items()):
            self._tokens[mid] = min(self.capacity,
                                    have + self.refill_per_step)


@dataclass(frozen=True)
class OverloadConfig:
    """Brownout policy knobs. The pressure signal is the worst healthy
    engine's predicted queue-drain time in seconds (the same
    :class:`DrainEstimator` number used for admission);
    ``hot_backlog_s`` must sit strictly above ``cold_backlog_s`` — the
    hysteresis band a noisy signal parks inside."""

    hot_backlog_s: float = 1.0       # worst-engine backlog above -> hot
    cold_backlog_s: float = 0.25     # worst-engine backlog below -> cold
    hot_steps: int = 2               # consecutive hot obs to escalate
    cold_steps: int = 4              # consecutive cold obs to de-escalate
    cooldown_steps: int = 4          # observations between transitions
    max_level: int = len(LEVELS) - 1
    floor_s: float = 0.05            # DrainEstimator floor
    batch_chunk_cap: int = 4         # prefill chunk cap at chunks-capped
    interactive_priority: int = 0    # priority admitted at interactive-only
    batch_priority: int = 2          # priority parked at batch-parked
    deadline_slack: float = 1.0      # shed when predicted > slack * deadline

    def __post_init__(self):
        if self.hot_backlog_s <= self.cold_backlog_s:
            raise ValueError(
                "hot_backlog_s must be strictly greater than "
                "cold_backlog_s (the hysteresis band)")
        if self.hot_steps < 1 or self.cold_steps < 1:
            raise ValueError("hot_steps and cold_steps must be >= 1")
        if self.cooldown_steps < 0:
            raise ValueError("cooldown_steps must be >= 0")
        if not 1 <= self.max_level <= len(LEVELS) - 1:
            raise ValueError(
                f"max_level must be in [1, {len(LEVELS) - 1}]")
        if self.batch_chunk_cap < 1:
            raise ValueError("batch_chunk_cap must be >= 1")
        if self.deadline_slack <= 0.0:
            raise ValueError("deadline_slack must be > 0")


class OverloadController:
    """Deadline-aware admission + the brownout ladder (module docstring
    has the policy)::

        ctl = OverloadController(router)
        while router.has_work:
            router.step()
            ctl.observe()

    ``observe()`` returns the decision string it counted (one of
    ``DECISIONS``) so drivers and tests can assert the trajectory, and
    (re-)attaches the controller to every current engine handle — an
    autoscaler-spawned newcomer is governed from the next sweep."""

    def __init__(self, router, model: Optional[str] = None,
                 config: Optional[OverloadConfig] = None):
        self._router = router
        self._model = router._resolve_model(model)
        self.config = config or OverloadConfig()
        self.estimator = DrainEstimator(floor_s=self.config.floor_s)
        self.level = 0
        self._hot = 0                    # consecutive hot observations
        self._cold = 0                   # consecutive cold observations
        self._cooldown = 0               # observations left to sit out
        self.events: List[Tuple[str, int]] = []   # (decision, new level)
        reg = metrics.get_registry()
        self._m_level = reg.gauge(
            "paddle_tpu_overload_brownout_level",
            "Current brownout ladder level (0 = normal, "
            f"{len(LEVELS) - 1} = interactive-only)",
            labels=("model_id",))
        self._m_transitions = reg.counter(
            "paddle_tpu_overload_transitions_total",
            "Brownout ladder level transitions by direction",
            labels=("model_id", "direction"))
        self._m_decisions = reg.counter(
            "paddle_tpu_overload_decisions_total",
            "observe() outcomes by decision",
            labels=("model_id", "decision"))
        self._m_shed = reg.counter(
            "paddle_tpu_overload_shed_total",
            "Requests refused at admission by the overload controller",
            labels=("model_id", "cause"))
        self._m_signal = reg.gauge(
            "paddle_tpu_overload_backlog_seconds",
            "Worst healthy engine's predicted queue-drain time — the "
            "brownout pressure signal", labels=("model_id",))
        for d in ("up", "down"):
            self._m_transitions.labels(model_id=self._model, direction=d)
        for d in DECISIONS:
            self._m_decisions.labels(model_id=self._model, decision=d)
        for c in SHED_CAUSES:
            self._m_shed.labels(model_id=self._model, cause=c)
        self._m_level.labels(model_id=self._model).set(0)
        self.attach()

    # ---------------------------------------------------------- attachment
    def attach(self) -> None:
        """Point every current engine of the governed model at this
        controller. Idempotent; re-run each observe() so engines the
        autoscaler spawns later are governed too."""
        for h in self._router.handles(self._model):
            try:
                h.engine._overload = self
            except Exception:
                pass  # dead/unreadable engine: the router owns it

    def detach(self) -> None:
        """Restore stock behavior on every engine (tests use this)."""
        for h in self._router.handles(self._model):
            try:
                if getattr(h.engine, "_overload", None) is self:
                    h.engine._overload = None
            except Exception:
                pass

    # ------------------------------------------------------------- signals
    def signal(self) -> float:
        """Worst healthy engine's predicted queue-drain seconds. The
        MAX (not mean) because brownout protects the tail: one swamped
        engine missing every interactive deadline is an incident even
        if its siblings are idle."""
        from .router import HEALTHY  # the router imports the engine

        healthy = [h for h in self._router.handles(self._model)
                   if h.state == HEALTHY]
        worst = 0.0
        for h in healthy:
            try:
                worst = max(worst, self.estimator.for_engine(h.engine))
            except Exception:
                pass  # unreadable engine: the router's health gate owns it
        self._m_signal.labels(model_id=self._model).set(worst)
        return worst

    # ----------------------------------------------------- engine-side API
    # Engines call these from add_request / _step_once; every answer is
    # host-side data (chunk sizes, draft gating, park decisions) so the
    # compile surface cannot change.
    @property
    def drafts_paused(self) -> bool:
        return self.level >= 1

    def chunk_cap(self) -> Optional[int]:
        """Batch-tier prefill chunk cap, or None when not capping."""
        return self.config.batch_chunk_cap if self.level >= 2 else None

    @property
    def park_batch(self) -> bool:
        return self.level >= 3

    @property
    def interactive_only(self) -> bool:
        return self.level >= 4

    def admit_priority_cap(self) -> Optional[int]:
        """Admission hold for ``FCFSScheduler.admit``: at
        ``batch-parked`` the batch tier stays queued (admitting it
        would only hand back the slots preemption just freed — an
        admit/preempt ping-pong); at ``interactive-only`` everything
        above the interactive priority holds. ``None`` = no hold."""
        if self.level >= 4:
            return self.config.interactive_priority
        if self.level >= 3:
            return self.config.batch_priority - 1
        return None

    def preempt_priority_cut(self) -> Optional[int]:
        """Lowest priority value the engine should PREEMPT (journal +
        requeue) out of its decode slots, or ``None`` when not
        preempting. At ``batch-parked`` only the batch tier is evicted;
        at ``interactive-only`` every non-interactive tier is — an
        admission hold alone cannot help the premium tier while
        already-running standard streams sit on the slots for their
        whole decode."""
        if self.level >= 4:
            return self.config.interactive_priority + 1
        if self.level >= 3:
            return self.config.batch_priority
        return None

    def admission_check(self, engine, req) -> None:
        """Gate one request at submit time; raises
        :class:`AdmissionShedError` to shed. Runs BEFORE the request
        enters the queue, so shed work never holds pages or slots."""
        cfg = self.config
        predicted = self.estimator.for_engine(engine)
        if self.interactive_only and req.priority > cfg.interactive_priority:
            self._shed(engine, req, predicted, "brownout")
        if req.deadline_s is not None and \
                predicted > cfg.deadline_slack * req.deadline_s:
            self._shed(engine, req, predicted, "deadline")

    def _shed(self, engine, req, predicted: float, cause: str) -> None:
        self._m_shed.labels(model_id=self._model, cause=cause).inc()
        engine._trace.emit("req.shed", req.req_id,
                           arg=predicted, label=cause)
        raise AdmissionShedError(
            f"request {req.req_id} shed at admission ({cause}): "
            f"predicted wait {predicted:.3f}s",
            retry_after_s=predicted,
            queue_depth=engine.scheduler.queue_depth,
            cause=cause)

    # -------------------------------------------------------------- control
    def observe(self) -> str:
        """One control tick: read the signal, update hysteresis
        counters, maybe move the ladder. Call once per ``router.step()``
        sweep (after it, like the autoscaler)."""
        self.attach()
        decision = self._decide()
        self._m_decisions.labels(model_id=self._model,
                                 decision=decision).inc()
        if decision in ("escalate", "de-escalate"):
            self.events.append((decision, self.level))
        return decision

    def _decide(self) -> str:
        cfg = self.config
        sig = self.signal()
        hot = sig > cfg.hot_backlog_s
        cold = sig < cfg.cold_backlog_s
        self._hot = self._hot + 1 if hot else 0
        self._cold = self._cold + 1 if cold else 0

        if self._cooldown > 0:
            self._cooldown -= 1
            return "cooldown"

        if self._hot >= cfg.hot_steps and self.level < cfg.max_level:
            self._move(+1)
            return "escalate"
        if self._cold >= cfg.cold_steps and self.level > 0:
            self._move(-1)
            return "de-escalate"
        return "steady"

    def _move(self, delta: int) -> None:
        self.level += delta
        direction = "up" if delta > 0 else "down"
        self._m_transitions.labels(model_id=self._model,
                                   direction=direction).inc()
        self._m_level.labels(model_id=self._model).set(self.level)
        self._emit_level()
        self._cooldown = self.config.cooldown_steps
        self._hot = 0
        self._cold = 0

    def _emit_level(self) -> None:
        """Trace the transition on every governed engine's stream (the
        model id rides as req_id, mirroring the step.* idiom)."""
        for h in self._router.handles(self._model):
            try:
                h.engine._trace.emit("brownout.level", self._model,
                                     arg=self.level,
                                     label=LEVELS[self.level])
            except Exception:
                pass
