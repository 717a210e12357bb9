"""hapi callbacks (``paddle_tpu/hapi/callbacks.py``; reference:
python/paddle/hapi/callbacks.py — Callback base, config_callbacks
assembly, ProgBarLogger, ModelCheckpoint, EarlyStopping, LRScheduler,
ReduceLROnPlateau, VisualDL, WandbCallback). ``VisualDL`` and
``WandbCallback`` write the JAX module's JSONL scalar log when their
package is absent."""
from __future__ import annotations

import numbers
import os
import time
import warnings
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "ReduceLROnPlateau", "CallbackList",
           "config_callbacks", "VisualDL", "WandbCallback"]


class Callback:
    """reference: callbacks.py Callback — every hook is a no-op default."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """reference: callbacks.py ProgBarLogger — prints per-step metrics."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()

    def _fmt(self, logs):
        bits = []
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)):
                v = v[0] if v else 0.0
            if isinstance(v, numbers.Number):
                bits.append(f"{k}: {v:.4f}")
        return " - ".join(bits)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose >= 2 and step % self.log_freq == 0:
            epochs = self.params.get("epochs")
            steps = self.params.get("steps")
            print(f"Epoch {self._epoch + 1}/{epochs} step {step}/{steps} "
                  f"- {self._fmt(logs)}", flush=True)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose >= 1:
            print(f"Epoch {epoch + 1} done ({time.time() - self._t0:.1f}s) "
                  f"- {self._fmt(logs)}", flush=True)

    def on_eval_end(self, logs=None):
        if self.verbose >= 1:
            print(f"Eval - {self._fmt(logs)}", flush=True)


class ModelCheckpoint(Callback):
    """reference: callbacks.py ModelCheckpoint — save every N epochs."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """reference: callbacks.py EarlyStopping."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater
        self.best_value = np.inf if self.monitor_op == np.less else -np.inf
        self.wait_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        if self.baseline is not None:
            self.best_value = self.baseline

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self.monitor_op(current - self.min_delta, self.best_value):
            self.best_value = current
            self.wait_epoch = 0
            if self.save_best_model and getattr(self.model, "_save_dir", None):
                self.model.save(
                    os.path.join(self.model._save_dir, "best_model"))
        else:
            self.wait_epoch += 1
        if self.wait_epoch > self.patience:
            self.model.stop_training = True
            if self.verbose:
                print(f"Early stopping at epoch {self.stopped_epoch}",
                      flush=True)


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer's learning rate when a monitored eval metric
    stops improving (reference: hapi/callbacks.py ReduceLROnPlateau —
    monitor/factor/patience/cooldown/min_lr semantics, 'auto' mode
    inferring max for 'acc'-like monitors)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        if factor >= 1.0:
            raise ValueError(
                "ReduceLROnPlateau does not support a factor >= 1.0")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = lambda a, b: np.less(a, b - self.min_delta)
            self._init_best = np.inf
        else:
            self.monitor_op = lambda a, b: np.greater(a, b + self.min_delta)
            self._init_best = -np.inf
        self.best_value = self._init_best
        self.wait_epoch = 0
        self.cooldown_counter = 0

    def on_train_begin(self, logs=None):
        self.best_value = self._init_best
        self.wait_epoch = 0
        self.cooldown_counter = 0

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait_epoch = 0
        if self.monitor_op(current, self.best_value):
            self.best_value = current
            self.wait_epoch = 0
        elif self.cooldown_counter <= 0:
            self.wait_epoch += 1
            if self.wait_epoch >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is None:
                    return
                if not isinstance(opt._learning_rate, (int, float)):
                    # reference behavior: warn and skip when the lr is a
                    # scheduler (set_lr would raise mid-fit otherwise)
                    warnings.warn(
                        "ReduceLROnPlateau expects a float learning rate; "
                        f"got {type(opt._learning_rate).__name__} — "
                        "skipping the reduction")
                    return
                old_lr = opt.get_lr()
                if old_lr > self.min_lr:
                    new_lr = max(old_lr * self.factor, self.min_lr)
                    opt.set_lr(new_lr)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: reducing learning rate "
                              f"to {new_lr:.6g}", flush=True)
                self.cooldown_counter = self.cooldown
                self.wait_epoch = 0


class LRScheduler(Callback):
    """reference: callbacks.py LRScheduler — step the optimizer's scheduler
    per epoch (by_epoch) or per step."""

    def __init__(self, by_step: bool = False, by_epoch: bool = True):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    """reference: callbacks.py config_callbacks — assemble the default
    callback stack around user callbacks."""
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [],
    })
    return lst


class _ScalarWriter:
    """Append-only JSONL scalar event log — the native telemetry sink.

    One line per scalar: {"tag", "step", "value", "wall_time"}. Chosen
    over binary event formats because (a) it needs neither visualdl nor
    tensorboard installed, (b) JSONL greps/streams/imports anywhere,
    and (c) an append is one syscall — nothing that can stall a step.
    """

    def __init__(self, log_dir: str, filename: str = "scalars.jsonl"):
        import json
        self._json = json
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, filename)
        self._f = open(self._path, "a", buffering=1)  # line-buffered

    def add_scalar(self, tag, value, step):
        self._f.write(self._json.dumps(
            {"tag": str(tag), "step": int(step), "value": float(value),
             "wall_time": time.time()}) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def _metric_names(metrics):
    """Flatten params['metrics'] entries to names — a Metric.name() may
    return a LIST (Accuracy with topk) — and lead with 'loss' (the
    reference Model's metric-name list starts with loss)."""
    names = []
    for m in metrics or []:
        for n in (m if isinstance(m, (list, tuple)) else [m]):
            if isinstance(n, str) and n not in names:
                names.append(n)
    return names if "loss" in names else ["loss"] + names


def _scalar_logs(logs, metrics):
    """(tag, value) pairs for the metric keys present in logs — list/tuple
    metric values log their first element (reference VisualDL._updates)."""
    out = []
    for k in metrics:
        if k not in (logs or {}):
            continue
        v = logs[k]
        if isinstance(v, (list, tuple)):
            v = v[0] if v else None
        if isinstance(v, numbers.Number):
            out.append((k, float(v)))
    return out


class _TelemetryBase(Callback):
    """Shared train/eval bookkeeping for the telemetry callbacks
    (reference: callbacks.py VisualDL — same hook set and step math)."""

    def __init__(self):
        super().__init__()
        self.epoch = 0
        self.train_step = 0
        self._is_fit = False

    def _is_write(self):
        from ..distributed import get_rank
        return get_rank() == 0

    def _write_scalar(self, tag, value, step):  # pragma: no cover - abstract
        raise NotImplementedError

    def _updates(self, logs, mode):
        if not self._is_write():
            return
        metrics = getattr(self, f"{mode}_metrics", None) or []
        step = self.train_step if mode == "train" else self.epoch
        for k, v in _scalar_logs(logs, metrics):
            self._write_scalar(f"{mode}/{k}", v, step)

    def on_train_begin(self, logs=None):
        self.train_metrics = _metric_names(self.params.get("metrics"))
        self._is_fit = True
        self.train_step = 0

    def on_epoch_begin(self, epoch=None, logs=None):
        self.epoch = epoch or 0

    def on_train_batch_end(self, step, logs=None):
        self.train_step += 1
        self._updates(logs or {}, "train")

    def on_eval_begin(self, logs=None):
        logs = logs or {}
        self.eval_metrics = _metric_names(
            logs.get("metrics") or self.params.get("metrics"))

    def on_eval_end(self, logs=None):
        self._updates(logs or {}, "eval")
        if not self._is_fit:
            self._close()

    def on_train_end(self, logs=None):
        self._close()

    def _close(self):  # pragma: no cover - abstract
        raise NotImplementedError


class VisualDL(_TelemetryBase):
    """reference: hapi/callbacks.py:883 VisualDL — scalar telemetry into
    ``log_dir`` with the reference's tags (``train/<metric>`` per train
    step, ``eval/<metric>`` per epoch) and rank-0 gating.

    Sink: the real ``visualdl.LogWriter`` when the package is importable;
    otherwise the native JSONL writer (documented divergence — the
    reference raises ImportError instead. Same
    tags/steps either way, so dashboards can be rebuilt from the JSONL)."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None

    def _ensure_writer(self):
        if self._writer is None:
            try:
                import visualdl
                self._writer = visualdl.LogWriter(self.log_dir)
                self._native = False
            except ImportError:
                self._writer = _ScalarWriter(self.log_dir)
                self._native = True
        return self._writer

    def _write_scalar(self, tag, value, step):
        w = self._ensure_writer()
        if self._native:
            w.add_scalar(tag, value, step)
        else:
            w.add_scalar(tag=tag, value=value, step=step)

    def _close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class WandbCallback(_TelemetryBase):
    """reference: hapi/callbacks.py:999 WandbCallback — Weights & Biases
    run tracking with the reference's constructor surface.

    When ``wandb`` is importable the real client is used (reusing an
    in-progress run exactly like the reference). Otherwise falls back to
    an OFFLINE native run directory (``<dir>/wandb-offline/<name>`` with
    config.json + scalars.jsonl) instead of raising — a hard ImportError
    would make the callback dead weight where wandb is absent (divergence
    documented)."""

    def __init__(self, project=None, entity=None, name=None, dir=None,
                 mode=None, job_type=None, **kwargs):
        super().__init__()
        self.wandb_args = {"project": project, "name": name,
                           "entity": entity, "dir": dir, "mode": mode,
                           "job_type": job_type}
        self.wandb_args.update(kwargs)
        self._run = None
        self._wandb = None
        self._writer = None
        try:
            import wandb
            self._wandb = wandb
        except ImportError:
            pass

    @property
    def run(self):
        if not self._is_write():
            return None
        if self._wandb is not None and self._run is None:
            if self._wandb.run is not None:
                import warnings
                warnings.warn(
                    "There is a wandb run already in progress; this "
                    "WandbCallback will reuse it. Call wandb.finish() "
                    "first if that is not desired.")
                self._run = self._wandb.run
            else:
                self._run = self._wandb.init(
                    **{k: v for k, v in self.wandb_args.items()
                       if v is not None})
        return self._run

    def _ensure_writer(self):
        if self._writer is None:
            import json
            base = self.wandb_args.get("dir") or "wandb"
            name = self.wandb_args.get("name") or "run"
            run_dir = os.path.join(base, "wandb-offline", str(name))
            self._writer = _ScalarWriter(run_dir)
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump({k: v for k, v in self.wandb_args.items()
                           if v is not None}, f)
        return self._writer

    def _write_scalar(self, tag, value, step):
        if self._wandb is not None:
            if self.run is not None:
                # no step= kwarg (reference does the same): eval scalars
                # use epoch-steps which are NOT monotonic vs train steps,
                # and wandb silently drops non-monotonic steps
                self.run.log({tag: value})
        else:
            self._ensure_writer().add_scalar(tag, value, step)

    def _close(self):
        if self._run is not None:
            self._run.finish()
            self._run = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
