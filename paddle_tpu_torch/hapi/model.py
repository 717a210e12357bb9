"""hapi Model — the high-level train/eval/predict facade
(``paddle_tpu/hapi/model.py``).

Reference parity: ``Model`` (python/paddle/hapi/model.py:1018) with
``prepare`` (:1598), ``fit``, ``evaluate``, ``predict``,
``train_batch``/``eval_batch``/``predict_batch``, ``save``/``load``,
``parameters``, ``summary``; callbacks per hapi/callbacks.py. The loop is
eager, as the JAX ``fit`` is. Metrics compute on the device and
accumulate on the host (metric).

Batches come off the dataloader on the CPU and are moved to the
network's device (its first parameter's) before the forward.
``fit(checkpoint_dir=)`` commits through ``checkpoint.CheckpointManager``
on that device; ``fit(sentinel=)`` guards every step with a
``faults.TrainSentinel``. ``prepare(amp_configs=)`` (``"O1"``/``"O2"``
or a dict with ``level`` and ``dtype``) runs each batch's forward and
loss under ``amp.auto_cast``, as the reference's Model does; decorating
the network and optimizer for O2 is the caller's (``amp.decorate``). The
JAX Model ignores ``amp_configs``.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import numpy as np
import torch

from .. import amp
from ..autograd import no_grad
from ..framework import io as _fio
from ..io.dataloader import DataLoader
from ..metric import Metric
from ..nn.layer_base import Layer
from ..tensor import Tensor
from .callbacks import config_callbacks

__all__ = ["Model"]


def _on(d, device) -> Tensor:
    if isinstance(d, Tensor):
        return Tensor._wrap(d._value.to(device))
    if isinstance(d, torch.Tensor):
        return Tensor._wrap(d.detach().to(device))
    return Tensor(torch.from_numpy(np.ascontiguousarray(np.asarray(d)))
                  .to(device))


def _to_tensor_list(data, device) -> List[Tensor]:
    if isinstance(data, (list, tuple)):
        return [_on(d, device) for d in data]
    return [_on(data, device)]


def _network_device(network) -> torch.device:
    for p in network.parameters():
        return getattr(p, "_value", p).device
    from ..device import default_device
    return default_device()


class Model:
    """reference: hapi/model.py:1018."""

    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._save_dir = None
        self._fit_sentinel = None
        self._amp = None
        # batches and restored state go where the network lives
        self._device = _network_device(network)

    # ------------------------------------------------------------ prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """reference: model.py prepare — bind optimizer/loss/metrics, and
        ``amp_configs`` (module docstring)."""
        if isinstance(amp_configs, str):
            amp_configs = {"level": amp_configs}
        self._amp = dict(amp_configs) if amp_configs else None
        self._optimizer = optimizer
        if loss is not None and not (isinstance(loss, Layer) or callable(loss)):
            raise TypeError(
                "'loss' must be sub classes of `paddle.nn.Layer` or any "
                "callable function.")
        self._loss = loss
        metrics = metrics or []
        if isinstance(metrics, Metric):
            metrics = [metrics]
        for m in metrics:
            if not isinstance(m, Metric):
                raise TypeError(
                    f"metrics must be paddle_tpu.metric.Metric, got "
                    f"{type(m).__name__}")
        self._metrics = metrics

    # ------------------------------------------------------------- batches
    def _compute_loss(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        labs = labels if isinstance(labels, (list, tuple)) else [labels]
        return self._loss(*outs, *labs)

    def _autocast(self):
        if self._amp is None:
            return contextlib.nullcontext()
        return amp.auto_cast(level=self._amp.get("level", "O1"),
                             dtype=self._amp.get("dtype", "bfloat16"))

    def _forward_loss(self, ins, labs):
        with self._autocast():
            outputs = self.network(*ins)
            return outputs, self._compute_loss(outputs, labs)

    def train_batch(self, inputs, labels=None, update=True):
        """reference: model.py train_batch — one step, returns loss (and
        metric results when metrics are bound)."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("Model.prepare(optimizer, loss) first")
        self.network.train()
        ins = _to_tensor_list(inputs, self._device)
        labs = _to_tensor_list(labels, self._device) \
            if labels is not None else []
        outputs, loss = self._forward_loss(ins, labs)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labs)
        lv = float(np.asarray(loss.numpy(), dtype="float64"))
        return ([lv] + metrics) if metrics else [lv]

    def _sentinel_batch(self, inputs, labels, sentinel):
        """One sentinel-guarded train step. The health scalars the
        detectors need — loss, global grad-norm, finite flag — are
        stacked device-side and fetched in ONE host sync (the same fetch
        ``train_batch`` already pays for the loss). The verdict lands
        BEFORE the update, so
        SKIP suppresses it through the optimizer's ``_found_inf`` no-op
        path and ROLLBACK leaves params untouched for the restore."""
        from .. import faults
        from ..faults.sentinel import _grad_health, _suppress_update

        self.network.train()
        sentinel.begin_step()
        faults.point("train.step")
        ins = _to_tensor_list(inputs, self._device)
        labs = _to_tensor_list(labels, self._device) \
            if labels is not None else []
        outputs, loss = self._forward_loss(ins, labs)
        loss.backward()
        faults.point("train.grads")
        loss_v, gnorm, finite = _grad_health(loss, self._optimizer)
        action = sentinel.observe(loss_v, grad_norm=gnorm,
                                  grads_finite=finite)
        if action == sentinel.OK:
            self._optimizer.step()
            self._optimizer.clear_grad()
            sentinel.after_update(True)
            # metrics only accumulate applied steps: a suppressed or
            # rolled-back batch must not pollute the epoch's accuracy
            metrics = self._update_metrics(outputs, labs)
        elif action == sentinel.SKIP:
            _suppress_update(self._optimizer)
            self._optimizer.clear_grad()
            sentinel.after_update(False)
            metrics = []
        else:  # ROLLBACK: the caller restores; these grads are moot
            self._optimizer.clear_grad()
            metrics = []
        lv = float(loss_v)
        return (([lv] + metrics) if metrics else [lv]), action

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        with no_grad(), self._autocast():
            ins = _to_tensor_list(inputs, self._device)
            labs = _to_tensor_list(labels, self._device) \
                if labels is not None else []
            outputs = self.network(*ins)
            loss = (self._compute_loss(outputs, labs)
                    if self._loss is not None and labs else None)
            metrics = self._update_metrics(outputs, labs)
        out = [float(np.asarray(loss.numpy()))] if loss is not None else []
        return out + metrics

    def predict_batch(self, inputs):
        self.network.eval()
        with no_grad(), self._autocast():
            outputs = self.network(*_to_tensor_list(inputs, self._device))
        return outputs

    def _update_metrics(self, outputs, labels) -> list:
        res = []
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        for m in self._metrics:
            computed = m.compute(outs[0], *labels)
            r = m.update(computed)
            res.append(r)
        return res

    # ----------------------------------------------------------------- fit
    def _make_loader(self, data, batch_size, shuffle, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=False)

    def _logs(self, loss_and_metrics) -> dict:
        logs = {"loss": loss_and_metrics[0]}
        i = 1
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            logs[names[0]] = (loss_and_metrics[i]
                              if i < len(loss_and_metrics) else m.accumulate())
            i += 1
        return logs

    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, eval_freq: int = 1, log_freq: int = 10,
            save_dir: Optional[str] = None, save_freq: int = 1,
            verbose: int = 2, drop_last: bool = False, shuffle: bool = True,
            num_workers: int = 0, callbacks=None,
            accumulate_grad_batches: int = 1, num_iters: Optional[int] = None,
            checkpoint_dir: Optional[str] = None, resume: bool = True,
            sentinel=None):
        """reference: model.py fit — epoch/step loop + callbacks + periodic
        eval + checkpointing. ``accumulate_grad_batches`` applies the
        optimizer every N micro-batches (reference gradient merge).

        ``checkpoint_dir`` switches on crash-consistent, preemption-aware
        checkpointing via ``paddle_tpu_torch.checkpoint.CheckpointManager``: a
        committed step (params + optimizer + RNG) lands every ``save_freq``
        epochs, and with ``resume=True`` (default) fit() first restores the
        newest valid step and continues from the following epoch — rerunning
        the same command after a crash or preemption picks the run back up.
        (``save_dir`` remains the reference's plain .pdparams path.)

        ``sentinel`` (a :class:`paddle_tpu_torch.faults.TrainSentinel`)
        makes the loop self-healing: per-step health scalars feed its
        detectors (one stacked host fetch — the same sync the loss read
        costs), a suspect batch's update is suppressed, and a persistent
        anomaly rolls params/optimizer/RNG/data back to the last-known-good
        step and deterministically skips the quarantined batches. With
        ``checkpoint_dir`` set, sentinel marks are committed under
        ``<checkpoint_dir>/sentinel`` and the journal rides every
        checkpoint's ``scalars.json``. An epoch interrupted by a rollback
        restarts from the restored position and is only recorded as done
        once it actually runs to its end."""
        loader = self._make_loader(train_data, batch_size, shuffle, num_workers)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        steps = len(loader) if hasattr(loader, "__len__") else None
        self._save_dir = save_dir
        self.stop_training = False
        if sentinel is not None:
            if self._optimizer is None or self._loss is None:
                raise RuntimeError(
                    "Model.prepare(optimizer, loss) before fit(sentinel=)")
            if accumulate_grad_batches != 1:
                raise ValueError(
                    "sentinel guarding assumes one update per batch; "
                    "accumulate_grad_batches > 1 is not supported yet")
        self._fit_sentinel = sentinel
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=steps, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir,
            metrics=[m.name() for m in self._metrics])

        ckpt_mgr = None
        start_epoch = 0
        if checkpoint_dir is not None:
            from .. import checkpoint as _ckpt

            ckpt_mgr = _ckpt.CheckpointManager(checkpoint_dir,
                                               device=self._device)
            if resume:
                res = ckpt_mgr.restore_or_init()
                if res.restored:
                    if "epoch" not in res.state:
                        # e.g. written by save_checkpoint(step=...): a
                        # global step is NOT an epoch count — resuming
                        # "epoch 5001 of 10" would silently train nothing
                        raise ValueError(
                            f"checkpoint step {res.step} in "
                            f"{checkpoint_dir!r} has no epoch marker "
                            f"(written by save_checkpoint?); fit can only "
                            f"resume epoch-granular checkpoints it wrote")
                    self._restore_training_state(res.state)
                    start_epoch = int(res.state["epoch"]) + 1
                    if hasattr(loader, "set_epoch"):
                        # align the shuffle stream: epoch-seeded sampling
                        # must replay the orders the uninterrupted run
                        # would have used from this epoch on
                        loader.set_epoch(start_epoch)
            elif ckpt_mgr.all_steps():
                # a fresh run would collide with (and silently never
                # overwrite) the committed steps already here — refuse
                # loudly rather than lose every new checkpoint
                raise ValueError(
                    f"checkpoint_dir {checkpoint_dir!r} already holds "
                    f"committed steps {ckpt_mgr.all_steps()}; pass "
                    f"resume=True to continue that run, or point "
                    f"checkpoint_dir at a fresh directory")

        if sentinel is not None:
            smgr = None
            if checkpoint_dir is not None:
                from .. import checkpoint as _ckpt

                # marks live beside (never inside the step namespace of)
                # fit's epoch checkpoints; bind() prunes marks ahead of a
                # resumed epoch-granular timeline
                smgr = _ckpt.CheckpointManager(
                    os.path.join(checkpoint_dir, "sentinel"), max_to_keep=3,
                    device=self._device)
            sentinel.bind(model=self.network, optimizer=self._optimizer,
                          dataloader=loader, manager=smgr)
        from .. import metrics as _metrics

        _amp_fam = _metrics.get_registry().get(
            "paddle_tpu_amp_skipped_steps_total")
        amp_skip_base = _amp_fam.value if _amp_fam is not None else 0.0

        cbks.on_train_begin()
        iters_done = 0
        logs = {}  # resume may satisfy every epoch: loop body never runs
        epoch = start_epoch
        while epoch < epochs:
            if self.stop_training:
                break
            for m in self._metrics:
                m.reset()
            cbks.on_epoch_begin(epoch)
            logs = {}
            if sentinel is not None:
                sentinel.note_epoch(epoch)
            # the restart loop: a sentinel ROLLBACK restores mid-epoch
            # state (dataloader included, quarantine skip queued) and
            # re-enters iteration from there. epoch_completed flips True
            # only when the LAST pass ran to natural exhaustion — a
            # rollback or num_iters break mid-epoch must not let the
            # resume=True path record this epoch as done.
            epoch_completed = False
            epoch_rewind = None
            restart = True
            while restart and not self.stop_training:
                restart = False
                data_iter = iter(loader)
                step = 0
                if sentinel is not None and hasattr(loader, "state_dict"):
                    # post-rollback the iterator starts mid-epoch; keep
                    # callback step indices aligned with the data stream
                    step = int(loader.state_dict().get("batch", 0))
                while True:
                    try:
                        batch = next(data_iter)
                    except StopIteration:
                        epoch_completed = True
                        break
                    cbks.on_train_batch_begin(step)
                    x, y = (batch[0], batch[1]) if isinstance(
                        batch, (list, tuple)) and len(batch) >= 2 \
                        else (batch, None)
                    if sentinel is not None:
                        result, action = self._sentinel_batch(x, y, sentinel)
                        if action == sentinel.ROLLBACK:
                            # pair the on_train_batch_begin above before
                            # breaking — begin/end-scoped callbacks must
                            # not leak an open span per rollback
                            logs = self._logs(result)
                            cbks.on_train_batch_end(step, logs)
                            info = sentinel.rollback()
                            if (info.get("epoch") is not None
                                    and info["epoch"] != epoch):
                                # the healthy window straddled the epoch
                                # boundary: re-run the marked epoch's tail
                                epoch_rewind = int(info["epoch"])
                                break
                            restart = True
                            break
                    else:
                        update = ((step + 1) % accumulate_grad_batches == 0)
                        result = self.train_batch(x, y, update=update)
                    logs = self._logs(result)
                    if sentinel is not None and sentinel.skipped_batches:
                        logs["skipped_batches"] = sentinel.skipped_batches
                    if _amp_fam is None:
                        _amp_fam = _metrics.get_registry().get(
                            "paddle_tpu_amp_skipped_steps_total")
                    if (_amp_fam is not None
                            and _amp_fam.value > amp_skip_base):
                        logs["amp_skipped"] = int(
                            _amp_fam.value - amp_skip_base)
                    cbks.on_train_batch_end(step, logs)
                    iters_done += 1
                    step += 1
                    if num_iters is not None and iters_done >= num_iters:
                        self.stop_training = True
                        break
            if epoch_rewind is not None:
                # close the aborted epoch's callback bracket before the
                # rewound epoch opens its own with on_epoch_begin
                cbks.on_epoch_end(epoch, logs)
                epoch = epoch_rewind
                continue
            cbks.on_epoch_end(epoch, logs)
            # only a COMPLETED epoch commits: a num_iters break mid-epoch
            # must not record epoch N as done, or resume would skip the
            # batches it never saw. A callback stopping training AFTER the
            # batch loop finished (early stopping) still checkpoints its
            # final epoch. (A duplicate step is a loud ValueError from the
            # manager, never a silent skip.)
            if ckpt_mgr is not None and epoch_completed \
                    and (epoch + 1) % save_freq == 0:
                if sentinel is not None and epoch in set(ckpt_mgr.all_steps()):
                    # a cross-epoch rollback replayed an epoch whose
                    # marker is already committed — that marker holds the
                    # PRE-rollback timeline (and pre-incident sentinel
                    # state); replace it so resume can't resurrect the
                    # path the rollback just repaired
                    ckpt_mgr.delete_step(epoch)
                ckpt_mgr.save(epoch, self._training_state(epoch))

            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                # reference fit loop brackets evaluation with
                # on_eval_begin({'steps', 'metrics'}) / on_eval_end(logs)
                cbks.on_eval_begin({
                    "steps": None,
                    "metrics": ["loss"] + [m.name()
                                           for m in self._metrics]})
                eval_logs = self.evaluate(eval_loader, batch_size=batch_size,
                                          verbose=0, num_workers=num_workers,
                                          callbacks=cbks,
                                          _inner_callbacks=True)
                cbks.on_eval_end(eval_logs)
                if self.stop_training:
                    break
            epoch += 1
        cbks.on_train_end(logs if steps else None)

    def _wrap_callbacks(self, callbacks):
        """Standalone-callback wrapping shared by evaluate/predict."""
        from .callbacks import CallbackList
        cbks = CallbackList(callbacks if isinstance(callbacks, (list, tuple))
                            else [callbacks])
        cbks.set_model(self)
        return cbks

    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 2, num_workers: int = 0, callbacks=None,
                 num_samples: Optional[int] = None, _inner_callbacks=False):
        """reference: model.py evaluate — returns {metric_name: value}.
        Standalone user callbacks are honored with the reference's
        on_eval_begin/on_eval_batch_*/on_eval_end bracket (fit() drives
        its own callback list and passes _inner_callbacks=True)."""
        cbks = None
        if callbacks is not None and not _inner_callbacks:
            cbks = self._wrap_callbacks(callbacks)
            cbks.on_eval_begin({
                "steps": None,
                "metrics": ["loss"] + [m.name() for m in self._metrics]})
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            if cbks is not None:
                cbks.on_eval_batch_begin(step)
            x, y = (batch[0], batch[1]) if isinstance(
                batch, (list, tuple)) and len(batch) >= 2 else (batch, None)
            r = self.eval_batch(x, y)
            if r and self._loss is not None:
                losses.append(r[0])
            if cbks is not None:
                cbks.on_eval_batch_end(step)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            logs[names[0]] = m.accumulate()
        if verbose:
            print(" - ".join(f"{k}: {v}" for k, v in logs.items()), flush=True)
        if cbks is not None:
            cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size: int = 1, num_workers: int = 0,
                stack_outputs: bool = False, verbose: int = 1, callbacks=None):
        """reference: model.py predict — list of per-batch outputs (or
        stacked arrays). User callbacks get the reference's
        on_predict_begin/batch/end bracket."""
        cbks = None
        if callbacks is not None:
            cbks = self._wrap_callbacks(callbacks)
            cbks.on_predict_begin()
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        outs = []
        for step, batch in enumerate(loader):
            if cbks is not None:
                cbks.on_predict_batch_begin(step)
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            o = self.predict_batch(x)
            o = o if isinstance(o, (list, tuple)) else [o]
            outs.append([np.asarray(t.numpy()) for t in o])
            if cbks is not None:
                cbks.on_predict_batch_end(step)
        n_out = len(outs[0]) if outs else 0
        grouped = [[b[i] for b in outs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        if cbks is not None:
            cbks.on_predict_end()
        return grouped

    # ------------------------------------------------------------ persist
    def save(self, path: str, training: bool = True):
        """reference: model.py save — `path + .pdparams` (+ .pdopt when
        training=True)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _fio.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False, reset_optimizer: bool = False):
        """reference: model.py load."""
        params = _fio.load(path + ".pdparams", device=self._device)
        self.network.set_state_dict(params)
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(
                _fio.load(opt_path, device=self._device))

    # -------------------------------------------- crash-consistent ckpt
    def _training_state(self, epoch: Optional[int] = None) -> dict:
        from .. import checkpoint as _ckpt

        state = _ckpt.capture_train_state(
            model=self.network, optimizer=self._optimizer,
            sentinel=self._fit_sentinel)
        if epoch is not None:
            state["epoch"] = int(epoch)
        return state

    def _restore_training_state(self, state: dict):
        from .. import checkpoint as _ckpt

        _ckpt.restore_train_state(state, model=self.network,
                                  optimizer=self._optimizer,
                                  sentinel=self._fit_sentinel)

    def save_checkpoint(self, directory: str, step: int,
                        max_to_keep: Optional[int] = 5,
                        async_save: bool = False):
        """Commit a crash-consistent checkpoint (params + optimizer + RNG)
        as step ``step`` under ``directory`` — the CheckpointManager commit
        protocol, unlike :meth:`save`'s plain (but atomic) pickle files.
        The step is a GLOBAL step, stored as ``step`` (not ``epoch`` —
        fit's epoch-granular resume refuses step-only checkpoints rather
        than misreading a step count as an epoch count). Returns the
        manager's async handle (``wait()`` it for async)."""
        from .. import checkpoint as _ckpt

        mgr = _ckpt.CheckpointManager(directory, max_to_keep=max_to_keep,
                                      device=self._device)
        state = _ckpt.capture_train_state(
            model=self.network, optimizer=self._optimizer, step=int(step))
        return mgr.save(int(step), state, async_save=async_save)

    def restore_checkpoint(self, directory: str) -> Optional[int]:
        """Auto-resume: restore the newest valid committed step (verifying
        checksums, quarantining corruption). Returns the restored step, or
        None when the directory holds nothing restorable."""
        from .. import checkpoint as _ckpt

        res = _ckpt.CheckpointManager(
            directory, device=self._device).restore_or_init()
        if not res.restored:
            return None
        self._restore_training_state(res.state)
        return res.step

    # ------------------------------------------------------------- intro
    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        """reference: hapi summary — parameter counting table."""
        rows, total = [], 0
        for name, p in self.network.named_parameters():
            n = int(np.prod(p.shape)) if p.shape else 1
            total += n
            rows.append((name, tuple(p.shape), n))
        width = max((len(r[0]) for r in rows), default=10) + 2
        lines = [f"{'Layer (param)':<{width}}{'Shape':<20}{'Param #':>10}"]
        lines += [f"{n:<{width}}{str(s):<20}{c:>10}" for n, s, c in rows]
        lines.append(f"Total params: {total}")
        out = "\n".join(lines)
        print(out, flush=True)
        return {"total_params": total, "trainable_params": total}
