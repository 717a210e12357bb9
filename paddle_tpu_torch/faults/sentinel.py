"""Train sentinel: anomaly detection + automatic rollback-and-skip
(``paddle_tpu/faults/sentinel.py``).

The training-side twin of the serving resilience layer: a long run must
not lose a day because one poisoned batch sent the loss to NaN at 3am.
The sentinel watches per-step health scalars (loss, global grad-norm,
finite flag) with one host fetch a step (``_grad_health``: each grad's
f32 norm in the optimizer's parameter order, from one multi-tensor
launch, stacked and reduced on the device, one ``.cpu()``), and answers
every step with a deterministic
verdict:

- ``OK``       apply the update; after a healthy window, mark the state
               *last-known-good* (in-memory snapshot, and a committed
               ``CheckpointManager`` step when one is bound);
- ``SKIP``     suppress the update (the optimizer's ``_found_inf`` skip
               path, a 0-d bool on the device every new value is
               ``torch.where``'d with, as GradScaler's; origin
               ``"sentinel"``, so the AMP skip counter does not count
               it) and advance data past the suspect batch;
- ``ROLLBACK`` restore the last-known-good step (checksum-verified
               ``CheckpointManager.restore`` when bound), quarantine the
               batch window consumed since the mark, and use the
               dataloader's sample-exact position to skip deterministically
               past it; after ``lr_reramp_after`` rollbacks into the same
               region the skip widens and the LR re-ramps;
- abort        ``SentinelAbort`` carrying the anomaly journal once a
               region keeps failing (``abort_after_rollbacks``) or no
               rollback target exists.

Detectors (evaluated in order; the first match names the anomaly):

1. ``nonfinite_loss``  — loss is NaN/inf;
2. ``nonfinite_grad``  — the global grad-norm is non-finite;
3. ``loss_spike``      — robust z-score over a rolling median/MAD window
                         exceeds ``z_threshold`` (median/MAD, not
                         mean/std: a spike must not inflate its own
                         baseline);
4. ``grad_spike``      — same statistic over the grad-norm series;
5. ``divergence``      — the loss EWMA exceeds ``divergence_factor`` ×
                         the best (lowest) EWMA seen — the slow-creep
                         failure no single-step test catches.

Anomalous steps never enter the rolling baselines, so a burst cannot
teach the detector that burst losses are normal.

The journal and the full escalation state ride ``state_dict()`` — pure
python scalars, so inside a checkpoint they land in ``scalars.json`` and
a preempted run resumes mid-incident with its memory intact (counters,
region rollback counts, quarantine bookkeeping).

Wiring: ``Model.fit(sentinel=TrainSentinel(...))`` guards the hapi loop;
``sentinel.guard(step_fn)`` guards any custom loop (the wrapper owns
backward + optimizer + rollback). A bound :class:`StepWatchdog` makes a
hung/over-threshold train step trip ``health()`` (→ ``/healthz`` via
``MetricsServer(health_cb=sentinel.health)``) and — when a manager is
bound — checkpoint-and-abort so the scheduler can restart the job.

In-memory marks clone: ``Layer.state_dict()`` returns the live cells,
and the optimizer writes its state with ``copy_``, so a mark that held
them would roll back to the current values (:func:`_detach_state`).

Device-free: the sentinel works on the devices of what it is bound to.
Module imports stay stdlib + ``paddle_tpu_torch.metrics``; torch and the
checkpoint machinery are imported inside the methods train loops call.
"""
from __future__ import annotations

import json
import math
import statistics
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from .. import metrics
from .injection import declare_point, point
from .watchdog import StepWatchdog

__all__ = [
    "Action", "SentinelAbort", "SentinelConfig", "StepReport",
    "TrainSentinel",
]

declare_point(
    "train.step",
    "top of one sentinel-guarded train step (Model._sentinel_batch / "
    "sentinel.guard wrapper): delay_s simulates a hung step -> watchdog; "
    "raise_ kills the step")
declare_point(
    "train.grads",
    "after backward, before the health-scalar fetch in a guarded step: "
    "call= poisons gradients (seeded NaN injection -> skip/rollback "
    "drills, tools/train_chaos.py scenarios 6-8)")

_REG = metrics.get_registry()
_M_ANOMALIES = _REG.counter(
    "paddle_tpu_train_anomalies_total",
    "Train-step anomalies detected by the sentinel", labels=("kind",))
_M_ROLLBACKS = _REG.counter(
    "paddle_tpu_train_rollbacks_total",
    "Sentinel rollbacks to the last-known-good step")
_M_SKIPPED = _REG.counter(
    "paddle_tpu_train_skipped_batches_total",
    "Batches whose update the sentinel suppressed (skip-batch) or "
    "quarantined past (rollback skip-forward)")
_M_LAST_GOOD = _REG.gauge(
    "paddle_tpu_train_last_good_step",
    "Newest step marked last-known-good by the sentinel")
_M_LOSS = _REG.histogram(
    "paddle_tpu_train_loss",
    "Per-step training loss seen by the sentinel (finite samples only)")
_M_GNORM = _REG.histogram(
    "paddle_tpu_train_grad_norm",
    "Per-step global gradient norm seen by the sentinel (finite only)")
_M_RERAMPS = _REG.counter(
    "paddle_tpu_train_lr_reramps_total",
    "LR re-ramps triggered by repeated rollbacks into one region")
_M_ABORTS = _REG.counter(
    "paddle_tpu_train_aborts_total",
    "Sentinel aborts by reason", labels=("reason",))
_M_STALLS = _REG.counter(
    "paddle_tpu_train_watchdog_trips_total",
    "Train-step watchdog trip episodes (hung/over-threshold steps)")


class Action:
    """Sentinel verdicts (plain strings so they journal/JSON cleanly)."""

    OK = "ok"
    SKIP = "skip"
    ROLLBACK = "rollback"


class SentinelAbort(RuntimeError):
    """The sentinel gave up: the escalation ladder is exhausted (or a
    watchdog stall demanded checkpoint-and-exit). Carries the anomaly
    ``journal`` (most recent last) and the machine-readable ``reason`` —
    the actionable incident report, not just a traceback."""

    def __init__(self, reason: str, journal: List[Dict], detail: str = ""):
        self.reason = str(reason)
        self.journal = list(journal)
        tail = journal[-3:]
        msg = f"train sentinel abort ({reason})"
        if detail:
            msg += f": {detail}"
        if tail:
            msg += "; journal tail: " + json.dumps(tail)
        super().__init__(msg)


class StepReport(NamedTuple):
    """What one ``guard()``-wrapped step did."""

    action: str           # Action.OK / SKIP / ROLLBACK
    loss: float
    grad_norm: float
    rolled_back: bool     # True => the data iterator must be rebuilt
    info: Optional[Dict]  # rollback details (target step, skipped, ...)


class SentinelConfig:
    """Detector + escalation knobs (all deterministic; no wall clocks).

    ``healthy_window`` consecutive healthy steps arm a last-known-good
    mark; ``mark_every`` (default ``healthy_window``) is the minimum step
    spacing between marks. ``skip_limit`` consecutive anomalies are
    handled as skip-batch before escalating to rollback; the
    ``lr_reramp_after``-th rollback into the same region re-ramps the LR
    (float LRs only) and widens the quarantine skip by ``widen_factor``;
    the ``abort_after_rollbacks``-th raises :class:`SentinelAbort`.
    """

    def __init__(self, *, window: int = 32, min_history: int = 8,
                 z_threshold: float = 8.0, grad_z_threshold: float = 8.0,
                 ewma_alpha: float = 0.05, divergence_factor: float = 3.0,
                 healthy_window: int = 8, mark_every: Optional[int] = None,
                 skip_limit: int = 2, lr_reramp_after: int = 2,
                 abort_after_rollbacks: int = 4, reramp_factor: float = 0.1,
                 reramp_steps: int = 20, widen_factor: int = 2,
                 quarantine_pad: int = 0, max_unrecoverable_skips: int = 8,
                 journal_limit: int = 256, abort_on_stall: bool = True):
        if window < 2 or min_history < 2:
            raise ValueError("window and min_history must be >= 2")
        if healthy_window < 1 or skip_limit < 0:
            raise ValueError("healthy_window >= 1 and skip_limit >= 0")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if divergence_factor <= 1.0:
            # factor 1.0 makes the divergence margin zero: every
            # fluctuation above the best-ever EWMA would be an incident
            raise ValueError("divergence_factor must be > 1.0")
        if abort_after_rollbacks < 1 or lr_reramp_after < 1:
            raise ValueError("rollback escalation thresholds must be >= 1")
        if widen_factor < 1 or reramp_steps < 1:
            raise ValueError("widen_factor and reramp_steps must be >= 1")
        if not 0.0 < reramp_factor <= 1.0:
            raise ValueError("reramp_factor must be in (0, 1]")
        self.window = int(window)
        self.min_history = int(min_history)
        self.z_threshold = float(z_threshold)
        self.grad_z_threshold = float(grad_z_threshold)
        self.ewma_alpha = float(ewma_alpha)
        self.divergence_factor = float(divergence_factor)
        self.healthy_window = int(healthy_window)
        self.mark_every = int(mark_every if mark_every is not None
                              else healthy_window)
        self.skip_limit = int(skip_limit)
        self.lr_reramp_after = int(lr_reramp_after)
        self.abort_after_rollbacks = int(abort_after_rollbacks)
        self.reramp_factor = float(reramp_factor)
        self.reramp_steps = int(reramp_steps)
        self.widen_factor = int(widen_factor)
        self.quarantine_pad = int(quarantine_pad)
        self.max_unrecoverable_skips = int(max_unrecoverable_skips)
        self.journal_limit = int(journal_limit)
        self.abort_on_stall = bool(abort_on_stall)


def _finite(v) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


def _jsonable(v):
    """Journal values must survive strict JSON (scalars.json): non-finite
    floats become their repr strings."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


def _robust_z(value: float, series) -> float:
    """|value - median| / (1.4826·MAD + floors): outlier-resistant scale,
    with a relative + absolute floor so a near-constant baseline (MAD≈0)
    doesn't turn numeric dust into an incident."""
    med = statistics.median(series)
    mad = statistics.median([abs(x - med) for x in series])
    scale = 1.4826 * mad + 1e-3 * abs(med) + 1e-12
    return abs(value - med) / scale


class TrainSentinel:
    """Guards a train loop: detect → skip → rollback-and-skip → re-ramp →
    abort, with exactly-once accounting and a persistent journal. See the
    module docstring for the state machine."""

    OK = Action.OK
    SKIP = Action.SKIP
    ROLLBACK = Action.ROLLBACK

    def __init__(self, config: Optional[SentinelConfig] = None,
                 watchdog: Optional[StepWatchdog] = None, **overrides):
        if config is not None and overrides:
            raise ValueError("pass config= or keyword overrides, not both")
        self.config = config or SentinelConfig(**overrides)
        self.watchdog = watchdog
        # bound training objects (bind()); all optional until rollback
        self._model = None
        self._optimizer = None
        self._dataloader = None
        self._manager = None
        # detector baselines
        c = self.config
        self._loss_win: deque = deque(maxlen=c.window)
        self._gnorm_win: deque = deque(maxlen=c.window)
        self._ewma: Optional[float] = None
        self._best_ewma: Optional[float] = None
        # escalation state
        self.global_step = 0
        self._epoch: Optional[int] = None
        self._healthy_streak = 0
        self._anomaly_streak = 0
        self._batches_since_mark = 0
        self._mark: Optional[Dict[str, Any]] = None
        self._last_good_step: Optional[int] = None
        self._region_step: Optional[int] = None
        self._region_rollbacks = 0
        self._reramp: Optional[Dict[str, float]] = None
        self._pending_mark = False
        # exactly-once python mirrors of the process-wide counters (the
        # registry is shared across sentinels; tests and state_dict need
        # THIS incident's numbers)
        self.anomalies: Dict[str, int] = {}
        self.rollbacks = 0
        self.skipped_batches = 0
        self.aborts = 0
        self.stalls = 0
        self._journal: List[Dict] = []

    # ------------------------------------------------------------ binding
    def bind(self, model=None, optimizer=None, dataloader=None,
             manager=None, prune_future: bool = True) -> "TrainSentinel":
        """Attach the live training objects rollback needs. With a
        ``CheckpointManager``, marks become committed steps and rollback
        restores checksum-verified; ``prune_future`` deletes committed
        marks AHEAD of ``self.global_step`` — they belong to a timeline a
        coarser resume (fit's epoch-granular restore) already rewound
        behind, and restoring one would fast-forward params into the
        future of the data stream."""
        self._model = model if model is not None else self._model
        self._optimizer = (optimizer if optimizer is not None
                           else self._optimizer)
        self._dataloader = (dataloader if dataloader is not None
                            else self._dataloader)
        if manager is not None:
            self._manager = manager
            if prune_future:
                for s in manager.all_steps():
                    if s > self.global_step:
                        manager.delete_step(s)
            # restore-then-bind (fit's order): set_state_dict ran without a
            # manager, so the newest committed mark must be re-acquired
            # here or a mid-incident resume would have no rollback target
            if self._mark is None:
                self._reacquire_mark()
        return self

    def _reacquire_mark(self) -> None:
        if self._manager is None:
            return
        steps = [s for s in self._manager.all_steps()
                 if s <= self.global_step]
        if steps:
            # epoch=None: which epoch the committed mark belongs to is
            # unknown until its state is read — rollback() derives the
            # true epoch from the RESTORED dataloader, never from here
            self._mark = {"step": steps[-1], "epoch": None,
                          "data": None, "state": None}

    # ----------------------------------------------------- step protocol
    def begin_step(self) -> None:
        """Bracket the guarded step for the watchdog (any-thread
        ``stalled_now`` makes a live hang visible to ``health()``)."""
        if self.watchdog is not None:
            self.watchdog.begin_step()

    def observe(self, loss, grad_norm=None, grads_finite: bool = True,
                ) -> str:
        """One step's verdict from its health scalars. Detection runs
        BEFORE the update is applied, so ``SKIP`` can suppress it; the
        caller reports back through :meth:`after_update` (OK/SKIP) or
        :meth:`rollback` (ROLLBACK)."""
        if self.watchdog is not None:
            if self.watchdog.end_step():
                self._on_stall()
        loss = float(loss)
        gnorm = None if grad_norm is None else float(grad_norm)
        if _finite(loss):
            _M_LOSS.observe(loss)
        if gnorm is not None and _finite(gnorm):
            _M_GNORM.observe(gnorm)

        kind = self._detect(loss, gnorm, grads_finite)
        if kind is None:
            self._note_healthy(loss, gnorm)
            return Action.OK
        return self._escalate(kind, loss, gnorm)

    def after_update(self, applied: bool) -> None:
        """Advance the step clock after the caller applied (OK) or
        suppressed (SKIP) the update; commits a pending last-known-good
        mark — post-update state, which is what rollback must restore."""
        self.global_step += 1
        self._batches_since_mark += 1
        if applied and self._pending_mark:
            self._pending_mark = False
            self.mark()

    # ---------------------------------------------------------- detectors
    def _detect(self, loss: float, gnorm: Optional[float],
                grads_finite: bool) -> Optional[str]:
        c = self.config
        if not _finite(loss):
            return "nonfinite_loss"
        if not grads_finite or (gnorm is not None and not _finite(gnorm)):
            return "nonfinite_grad"
        if (len(self._loss_win) >= c.min_history
                and _robust_z(loss, self._loss_win) > c.z_threshold):
            return "loss_spike"
        if (gnorm is not None and len(self._gnorm_win) >= c.min_history
                and _robust_z(gnorm, self._gnorm_win) > c.grad_z_threshold):
            return "grad_spike"
        if self._best_ewma is not None:
            tentative = ((1.0 - c.ewma_alpha) * self._ewma
                         + c.ewma_alpha * loss)
            # margin formulation (== factor × best for positive best):
            # stays sound when the loss is negative or bottoms near zero —
            # `tentative > factor * best` flips meaning for best <= 0
            best = self._best_ewma
            margin = (c.divergence_factor - 1.0) * max(abs(best), 1e-6)
            if tentative > best + margin:
                return "divergence"
        return None

    def _note_healthy(self, loss: float, gnorm: Optional[float]) -> None:
        c = self.config
        self._loss_win.append(loss)
        if gnorm is not None:
            self._gnorm_win.append(gnorm)
        self._ewma = (loss if self._ewma is None
                      else (1.0 - c.ewma_alpha) * self._ewma
                      + c.ewma_alpha * loss)
        if len(self._loss_win) >= c.min_history:
            self._best_ewma = (self._ewma if self._best_ewma is None
                               else min(self._best_ewma, self._ewma))
        self._anomaly_streak = 0
        self._healthy_streak += 1
        self._tick_reramp()
        if (self._healthy_streak >= c.healthy_window
                and self._batches_since_mark + 1 >= c.mark_every):
            # +1: the mark lands in after_update, once THIS step applied
            self._pending_mark = True

    # --------------------------------------------------------- escalation
    def _escalate(self, kind: str, loss: float,
                  gnorm: Optional[float]) -> str:
        c = self.config
        self._healthy_streak = 0
        self._anomaly_streak += 1
        self._pending_mark = False
        _M_ANOMALIES.labels(kind=kind).inc()
        self.anomalies[kind] = self.anomalies.get(kind, 0) + 1
        entry = self._journal_event(
            "anomaly", kind=kind, loss=_jsonable(loss),
            grad_norm=_jsonable(gnorm), streak=self._anomaly_streak)
        if self._anomaly_streak <= c.skip_limit:
            entry["action"] = Action.SKIP
            self.skipped_batches += 1
            _M_SKIPPED.inc()
            return Action.SKIP
        if not self._can_rollback():
            if self._anomaly_streak >= c.skip_limit + c.max_unrecoverable_skips:
                entry["action"] = "abort"
                self._abort("no_rollback_target",
                            "anomalies persist and no last-known-good mark "
                            "exists to roll back to")
            entry["action"] = Action.SKIP
            self.skipped_batches += 1
            _M_SKIPPED.inc()
            return Action.SKIP
        target = self._mark["step"]
        if (self._region_step == target
                and self._region_rollbacks >= c.abort_after_rollbacks):
            entry["action"] = "abort"
            self._abort("rollback_limit",
                        f"{self._region_rollbacks} rollbacks into the "
                        f"region after step {target} did not clear the "
                        f"anomaly")
        entry["action"] = Action.ROLLBACK
        return Action.ROLLBACK

    def _can_rollback(self) -> bool:
        return self._mark is not None

    def rollback(self) -> Dict[str, Any]:
        """Restore the last-known-good mark and queue a deterministic
        skip past the quarantined batch window. Returns
        ``{"step", "epoch", "skipped", "region_rollbacks"}`` — the caller
        must rebuild its data iterator (fit restarts the epoch loop;
        ``guard()`` reports ``rolled_back=True``)."""
        if not self._can_rollback():
            self._abort("no_rollback_target",
                        "rollback requested with no mark")
        c = self.config
        mark = self._mark
        target = int(mark["step"])
        # restore FIRST: verification may fall back to an older committed
        # step, and every piece of bookkeeping below must key on the step
        # actually restored, not the one we hoped for
        actual = self._restore_mark_state(target, mark)
        if self._region_step == actual:
            self._region_rollbacks += 1
        else:
            self._region_step = actual
            self._region_rollbacks = 1
        # quarantine window: every batch consumed since the TARGET mark,
        # plus the batch that triggered this verdict (after_update never
        # ran for it), plus — on a fallback restore — the one-batch-per-
        # step stretch between the actual and target marks, so the skip
        # still lands past the anomaly from the older data position
        window = self._batches_since_mark + 1 + max(0, target - actual)
        # the lr_reramp_after-th rollback into one region starts widening:
        # the region is visibly larger than the window observed so far
        widen = c.widen_factor ** max(
            0, self._region_rollbacks - c.lr_reramp_after + 1)
        skip = window * widen + c.quarantine_pad

        if self._dataloader is not None and hasattr(self._dataloader,
                                                    "advance_batches"):
            self._dataloader.advance_batches(skip)
        self.rollbacks += 1
        _M_ROLLBACKS.inc()
        self.skipped_batches += skip
        _M_SKIPPED.inc(skip)
        reramped = False
        if self._region_rollbacks >= c.lr_reramp_after:
            reramped = self._start_reramp()
        # the restored DATALOADER knows the true epoch the mark was taken
        # in — a mark re-acquired after resume carries epoch=None, and
        # stamping the resume-time epoch would desync fit's epoch counter
        # from the replayed data stream
        mark_epoch = mark.get("epoch")
        if self._dataloader is not None and hasattr(self._dataloader,
                                                    "state_dict"):
            try:
                mark_epoch = int(
                    self._dataloader.state_dict().get("epoch", mark_epoch))
            except Exception:
                pass
        info = {
            "step": actual,
            "epoch": mark_epoch,
            "skipped": int(skip),
            "region_rollbacks": self._region_rollbacks,
            "reramped": reramped,
        }
        self._journal_event(
            "rollback", target=actual, window=int(window),
            skipped=int(skip), region_rollbacks=self._region_rollbacks,
            reramped=reramped, data=mark.get("data"),
            fallback_from=(target if actual != target else None))
        self.global_step = actual
        self._batches_since_mark = 0
        self._anomaly_streak = 0
        self._healthy_streak = 0
        self._pending_mark = False
        return info

    def _restore_mark_state(self, target: int, mark: Dict) -> int:
        """Restore the mark's state into the bound objects; returns the
        step ACTUALLY restored (an older one when the target's committed
        step failed verification and restore fell back)."""
        from ..checkpoint import restore_train_state

        state, actual = None, target
        if self._manager is not None:
            try:
                state, _ = self._manager.restore(target)
            except Exception:
                # the mark's committed step failed verification (or went
                # missing): fall back to the newest valid older step,
                # then to the in-memory snapshot
                try:
                    state, actual = self._manager.restore()
                    mark["step"] = actual
                    mark["data"] = None  # position belonged to the target
                except Exception:
                    state = None
        if state is None:
            state = mark.get("state")
        if state is None:
            self._abort("rollback_failed",
                        f"no restorable state for mark step {target}")
        restore_train_state(state, model=self._model,
                            optimizer=self._optimizer,
                            dataloader=self._dataloader)
        return actual

    def _start_reramp(self) -> bool:
        opt = self._optimizer
        if opt is None:
            return False
        restarted = self._reramp is not None
        try:
            # a ramp already in flight keeps its ORIGINAL base — repeated
            # rollbacks must restart the ramp, not compound the reduction
            base = (self._reramp["base"] if restarted else opt.get_lr())
            opt.set_lr(base * self.config.reramp_factor)
        except (RuntimeError, AttributeError):
            # LRScheduler-driven optimizer: the schedule owns the LR; the
            # widened skip still applies, journal records the decision
            self._journal_event("lr_reramp_skipped",
                                reason="scheduler-driven lr")
            return False
        self._reramp = {"base": float(base),
                        "remaining": self.config.reramp_steps,
                        "total": self.config.reramp_steps}
        if not restarted:  # a restart extends THIS ramp, not a new event
            _M_RERAMPS.inc()
        self._journal_event("lr_reramp", base=float(base),
                            factor=self.config.reramp_factor,
                            steps=self.config.reramp_steps,
                            restarted=restarted or None)
        return True

    def _tick_reramp(self) -> None:
        r = self._reramp
        if r is None or self._optimizer is None:
            return
        r["remaining"] -= 1
        frac = 1.0 - max(0, r["remaining"]) / r["total"]
        f = self.config.reramp_factor
        try:
            self._optimizer.set_lr(r["base"] * (f + (1.0 - f) * frac))
        except (RuntimeError, AttributeError):
            self._reramp = None
            return
        if r["remaining"] <= 0:
            self._reramp = None

    def _abort(self, reason: str, detail: str = "") -> None:
        self.aborts += 1
        _M_ABORTS.labels(reason=reason).inc()
        self._journal_event("abort", reason=reason, detail=detail)
        raise SentinelAbort(reason, self._journal, detail)

    # --------------------------------------------------------------- marks
    def mark(self, force: bool = False) -> Optional[int]:
        """Capture the CURRENT state as last-known-good. Called
        automatically after a healthy window; ``force=True`` marks
        regardless (fit uses it at epoch starts via :meth:`note_epoch`).
        Returns the marked step, or None when nothing is bound to
        capture."""
        if self._model is None and self._optimizer is None:
            return None
        if not force and self._anomaly_streak:
            return None
        from ..checkpoint import capture_train_state

        # lazy per-param accumulators must exist in the snapshot: a mark
        # taken before the first update (the step-0 init mark) would
        # otherwise capture an EMPTY optimizer state, and restoring it
        # would leave post-mark moments in place (set_state_dict only
        # overwrites keys present in the state)
        if self._optimizer is not None and hasattr(
                self._optimizer, "_materialize_accumulators"):
            try:
                self._optimizer._materialize_accumulators()
            except Exception:
                pass
        state = capture_train_state(
            model=self._model, optimizer=self._optimizer,
            dataloader=self._dataloader, step=self.global_step,
            sentinel=self)
        data_pos = None
        if self._dataloader is not None and hasattr(self._dataloader,
                                                    "state_dict"):
            data_pos = dict(self._dataloader.state_dict())
        mark: Dict[str, Any] = {"step": self.global_step,
                                "epoch": self._epoch, "data": data_pos,
                                "state": None}
        if self._manager is not None:
            try:
                self._manager.save_if_absent(self.global_step, state)
            except Exception:
                # durability is best-effort; the in-memory snapshot keeps
                # rollback possible even when the disk is unhappy
                mark["state"] = _detach_state(state)
        else:
            mark["state"] = _detach_state(state)
        self._mark = mark
        self._last_good_step = self.global_step
        _M_LAST_GOOD.set(self.global_step)
        self._batches_since_mark = 0
        return self.global_step

    def note_epoch(self, epoch: int) -> None:
        """fit's epoch-boundary hook: records the epoch for journal/mark
        bookkeeping and takes a mark when eligible — at step 0 the init
        state is trivially good; later boundaries mark only when the
        healthy-window contract is met (mid-incident boundaries keep the
        previous mark, so a rollback may legitimately land in the prior
        epoch)."""
        self._epoch = int(epoch)
        if self.global_step == 0 and self._mark is None:
            self.mark(force=True)
        elif (self._anomaly_streak == 0
              and self._healthy_streak >= self.config.healthy_window):
            self.mark()

    @property
    def last_good_step(self) -> Optional[int]:
        return self._last_good_step

    # ------------------------------------------------------------ journal
    def _journal_event(self, event: str, **fields) -> Dict:
        entry = {"event": event, "step": int(self.global_step)}
        if self._epoch is not None:
            entry["epoch"] = int(self._epoch)
        if (self._dataloader is not None and "data" not in fields
                and hasattr(self._dataloader, "state_dict")):
            try:
                entry["data"] = dict(self._dataloader.state_dict())
            except Exception:
                pass
        entry.update({k: _jsonable(v) for k, v in fields.items()
                      if v is not None})
        self._journal.append(entry)
        if len(self._journal) > self.config.journal_limit:
            del self._journal[:-self.config.journal_limit]
        return entry

    def journal(self) -> List[Dict]:
        """The incident log, oldest first (bounded to
        ``journal_limit``)."""
        return [dict(e) for e in self._journal]

    # ----------------------------------------------------- watchdog/health
    def _on_stall(self) -> None:
        self.stalls += 1
        _M_STALLS.inc()
        self._journal_event("stall",
                            threshold_s=self.watchdog.stall_threshold_s)
        if not self.config.abort_on_stall:
            return
        if self._manager is not None and (self._model is not None
                                          or self._optimizer is not None):
            # checkpoint-and-exit: persist the CURRENT state (pre-verdict
            # params are one over-long step past last-known-good, not
            # anomalous) so the restarted job loses nothing
            from ..checkpoint import capture_train_state

            try:
                self._manager.save_if_absent(
                    self.global_step,
                    capture_train_state(
                        model=self._model, optimizer=self._optimizer,
                        dataloader=self._dataloader, step=self.global_step,
                        sentinel=self))
            except Exception:
                pass
        self._abort("stall", "train step exceeded the watchdog threshold")

    def health(self) -> Dict[str, Any]:
        """``MetricsServer(health_cb=sentinel.health)`` payload: degraded
        while a step is live-hung / the watchdog is tripped / an incident
        is open."""
        degraded = bool(self._anomaly_streak)
        if self.watchdog is not None:
            degraded = degraded or self.watchdog.status() != "ok"
        return {
            "status": "degraded" if degraded else "ok",
            "last_good_step": self._last_good_step,
            "step": self.global_step,
            "anomaly_streak": self._anomaly_streak,
            "rollbacks": self.rollbacks,
            "skipped_batches": self.skipped_batches,
        }

    # ------------------------------------------------------- guard wrapper
    def guard(self, step_fn: Callable, optimizer=None) -> Callable:
        """Wrap a custom train step. ``step_fn(*args, **kw)`` runs
        forward + loss and returns the scalar loss Tensor (grads NOT yet
        computed, optimizer NOT yet stepped) — the wrapper owns backward,
        the single health-scalar fetch, the verdict, the (possibly
        suppressed) optimizer step, and rollback. Returns a
        :class:`StepReport`; ``report.rolled_back`` means the caller must
        rebuild its data iterator (the restored dataloader has the
        quarantine skip queued)."""
        opt = optimizer if optimizer is not None else self._optimizer
        if opt is None:
            raise ValueError("guard() needs an optimizer (argument or "
                             "bind(optimizer=...))")

        def guarded(*args, **kwargs) -> StepReport:
            self.begin_step()
            point("train.step")
            loss = step_fn(*args, **kwargs)
            if isinstance(loss, (tuple, list)):
                loss = loss[0]
            loss.backward()
            point("train.grads")
            loss_v, gnorm, finite = _grad_health(loss, opt)
            action = self.observe(loss_v, gnorm, grads_finite=finite)
            if action == Action.OK:
                opt.step()
                opt.clear_grad()
                self.after_update(True)
                return StepReport(action, loss_v, gnorm, False, None)
            if action == Action.SKIP:
                _suppress_update(opt)
                opt.clear_grad()
                self.after_update(False)
                return StepReport(action, loss_v, gnorm, False, None)
            opt.clear_grad()
            info = self.rollback()
            return StepReport(action, loss_v, gnorm, True, info)

        guarded.__name__ = getattr(step_fn, "__name__", "train_step")
        return guarded

    # --------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, Any]:
        """Pure-python scalars (one JSON blob), so inside a checkpoint the
        whole escalation state + journal land in ``scalars.json`` and a
        preempted run resumes mid-incident with exact counters."""
        payload = {
            "global_step": self.global_step,
            "epoch": self._epoch,
            "healthy_streak": self._healthy_streak,
            "anomaly_streak": self._anomaly_streak,
            "batches_since_mark": self._batches_since_mark,
            "last_good_step": self._last_good_step,
            "region_step": self._region_step,
            "region_rollbacks": self._region_rollbacks,
            "reramp": self._reramp,
            "loss_win": list(self._loss_win),
            "gnorm_win": list(self._gnorm_win),
            "ewma": self._ewma,
            "best_ewma": self._best_ewma,
            "anomalies": dict(self.anomalies),
            "rollbacks": self.rollbacks,
            "skipped_batches": self.skipped_batches,
            "aborts": self.aborts,
            "stalls": self.stalls,
            "journal": self._journal,
        }
        return {"version": 1, "json": json.dumps(payload)}

    def set_state_dict(self, state: Dict[str, Any]) -> None:
        payload = json.loads(state["json"]) if "json" in state else dict(state)
        c = self.config
        self.global_step = int(payload.get("global_step", 0))
        ep = payload.get("epoch")
        self._epoch = None if ep is None else int(ep)
        self._healthy_streak = int(payload.get("healthy_streak", 0))
        self._anomaly_streak = int(payload.get("anomaly_streak", 0))
        self._batches_since_mark = int(payload.get("batches_since_mark", 0))
        self._last_good_step = payload.get("last_good_step")
        self._region_step = payload.get("region_step")
        self._region_rollbacks = int(payload.get("region_rollbacks", 0))
        self._reramp = payload.get("reramp")
        self._loss_win = deque(payload.get("loss_win", ()), maxlen=c.window)
        self._gnorm_win = deque(payload.get("gnorm_win", ()),
                                maxlen=c.window)
        self._ewma = payload.get("ewma")
        self._best_ewma = payload.get("best_ewma")
        self.anomalies = dict(payload.get("anomalies", {}))
        self.rollbacks = int(payload.get("rollbacks", 0))
        self.skipped_batches = int(payload.get("skipped_batches", 0))
        self.aborts = int(payload.get("aborts", 0))
        self.stalls = int(payload.get("stalls", 0))
        self._journal = list(payload.get("journal", []))
        if self._last_good_step is not None:
            _M_LAST_GOOD.set(self._last_good_step)
        # marks are NOT serialized here (they are the checkpoints
        # themselves): a manager-bound resume re-acquires the newest
        # committed mark lazily; in-memory-only resume re-marks after the
        # next healthy window
        self._mark = None
        self._pending_mark = False
        self._reacquire_mark()

    load_state_dict = set_state_dict


def _detach_state(state):
    """Deep-copy a capture_train_state dict for an IN-MEMORY mark:
    ``model.state_dict()`` returns the LIVE cells, which
    ``Optimizer.step`` writes in place (``copy_``) — holding them would
    make rollback restore the current params into themselves (a silent
    no-op). Every tensor is cloned on its device; non-tensor leaves
    (ints, floats, strings) are already immutable."""
    import torch

    from ..tensor import Tensor

    def snap(v):
        if isinstance(v, dict):
            return {k: snap(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(snap(x) for x in v)
        if isinstance(v, Tensor):
            return Tensor(v._value.detach().clone())
        if isinstance(v, torch.Tensor):
            return v.detach().clone()
        return v

    return snap(state)


def _grad_health(loss, optimizer):
    """(loss, global grad-norm, grads_finite) with ONE host fetch: an f32
    sum of squares per grad, in the optimizer's parameter order, stacked
    on the device and summed there; loss, norm and finite flag go to the
    host in one ``.cpu()``, the sync the loss read costs anyway."""
    import torch

    lv = getattr(loss, "_value", loss)
    lv = torch.as_tensor(lv).detach().float().reshape(())
    grads = []
    for param in optimizer._parameter_list or []:
        p = getattr(param, "_value", param)
        if p.grad is None or not p.requires_grad \
                or not getattr(param, "trainable", True):
            continue
        grads.append(p.grad.detach())
    if grads:
        # each grad's f32 norm in one multi-tensor launch: sqrt of its sum
        # of squares, squared back below
        norms = torch.stack(torch._foreach_norm(grads, 2,
                                                dtype=torch.float32))
        gsq = (norms * norms).sum()
    else:
        gsq = lv.new_zeros(())
    stats = torch.stack([lv.to(gsq.device), gsq.sqrt(),
                         torch.isfinite(gsq).float()])
    host = stats.cpu().double().tolist()
    return float(host[0]), float(host[1]), bool(host[2])


def _suppress_update(optimizer) -> None:
    """Skip-batch via the optimizer's own ``_found_inf`` no-op path (a
    0-d bool on the parameters' device, GradScaler's skip), tagged so the
    AMP skip counter doesn't claim sentinel skips."""
    import torch

    params = optimizer._parameter_list or []
    dev = getattr(params[0], "_value", params[0]).device if params \
        else torch.device("cpu")
    optimizer._found_inf = torch.ones((), dtype=torch.bool, device=dev)
    optimizer._found_inf_origin = "sentinel"
    optimizer.step()
