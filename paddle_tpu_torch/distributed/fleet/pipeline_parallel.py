"""``PipelineParallel``: the pipeline training API
(``paddle_tpu/distributed/fleet/pipeline_parallel.py``).

``train_batch`` reads ``accumulate_steps`` and ``micro_batch_size`` as
the JAX package does (the microbatch count is ``accumulate_steps``; when
that is 1 and ``micro_batch_size`` is set, the batch over it; for 1F1B,
when still 1, the ``pp`` degree) and ``pipeline_configs['schedule_mode']``
(``"1F1B"``, or the default ``"F-then-B"``). On a ``pp`` mesh above 1
both run the port's per-stage timetable (``pipeline_schedule.
pipeline_train``): a model with a ``StackedPipelineBlocks`` trunk fuses
the entries before it into stage 0 and those after it, with
``loss_fn``, into the last stage; a segmented ``PipelineLayer`` runs
each stage's own entries, and its shared layers' gradients are summed
over the stages. At ``pp`` 1 the microbatches run one after another with
their losses divided by the count, as there. The mean microbatch loss
is returned; with a ``GradScaler`` the loss is scaled and the
optimizer steps through it.
"""
from __future__ import annotations

from ...nn.layer_base import Layer
from .pipeline_schedule import (StackedPipelineBlocks, _like, _params_of,
                                _v, pipeline_train)
from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel"]


def _seq(fs):
    """The entries ``fs`` one after another (``PipelineLayer``'s tuple
    convention), or None."""
    if not fs:
        return None

    def run(x):
        for f in fs:
            x = f(*x) if isinstance(x, tuple) else f(x)
        return x

    run.entries = list(fs)
    return run


class PipelineParallel(Layer):
    """reference: pipeline_parallel.py:32 (module docstring)."""

    def __init__(self, layers: Layer, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        micro = 1
        self.micro_batch_size = None
        if strategy is not None:
            hc = getattr(strategy, "hybrid_configs", {})
            micro = int(hc.get("accumulate_steps", 1))
            mbs = int(hc.get("micro_batch_size", 1))
            self.micro_batch_size = mbs if mbs > 1 else None
        self.accumulate_steps = max(micro, 1)
        self._loss_fn = getattr(layers, "_loss_fn", None)
        self._schedule_mode = "F-then-B"
        if strategy is not None:
            pc = getattr(strategy, "pipeline_configs", {}) or {}
            self._schedule_mode = pc.get("schedule_mode", "F-then-B")

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _parts(self):
        """(prefix, stack, suffix) around a stacked trunk, or None."""
        funcs = list(getattr(self._layers, "run_funcs", []))
        if isinstance(self._layers, StackedPipelineBlocks):
            return None, self._layers, None
        idx = [i for i, f in enumerate(funcs)
               if isinstance(f, StackedPipelineBlocks)]
        if len(idx) != 1:
            return None
        i = idx[0]
        return _seq(funcs[:i]), funcs[i], _seq(funcs[i + 1:])

    def _num_microbatches(self, B: int, one_f_one_b: bool, pp: int) -> int:
        n = self.accumulate_steps
        if n == 1 and self.micro_batch_size:
            if B % self.micro_batch_size:
                raise ValueError(f"batch {B} not divisible by "
                                 f"micro_batch_size {self.micro_batch_size}")
            n = B // self.micro_batch_size
        if n == 1 and one_f_one_b:
            n = pp
        return n

    def _pipelined_loss(self, data, scaler):
        """The timetable on a ``pp`` mesh above 1, or None at pp 1."""
        from ...tensor import Tensor

        xb, yb = data
        B = _v(xb).shape[0]
        parts = self._parts()
        schedule = "1F1B" if self._schedule_mode == "1F1B" else "F-then-B"
        scale = None if scaler is None or not scaler._enable \
            else scaler._scale
        if parts is not None and parts[1]._pp > 1:
            prefix, stack, suffix = parts
            user = self._loss_fn
            loss_fn = user if suffix is None else (
                lambda out, lab: user(suffix(out), lab))
            vals = stack.stacked_values()
            M = self._num_microbatches(B, schedule == "1F1B", stack._pp)
            return pipeline_train(
                lambda h: stack._chunk(h, vals), xb, yb, loss_fn, M,
                prefix=prefix, group=stack._group, schedule=schedule,
                grad_scale=scale, stack=stack,
                loss_params=_params_of(
                    ([] if suffix is None else suffix.entries) + [user]),
                prefix_params=[] if prefix is None
                else _params_of(prefix.entries))
        model = self._layers
        if isinstance(model, PipelineLayer) and model.segmented:
            M = self._num_microbatches(B, schedule == "1F1B",
                                       model.get_num_stages())
            loss = pipeline_train(
                lambda h: _v(model.stage_forward(Tensor._wrap(h))), xb, yb,
                self._loss_fn, M, group=model.pp_group(), schedule=schedule,
                grad_scale=scale, loss_params=[], prefix_params=[])
            self._sum_shared(model)
            return loss
        return None

    @staticmethod
    def _sum_shared(model) -> None:
        """The shared layers' gradients summed over the stages."""
        from .. import collective

        group = model.pp_group()
        for p in model.shared_parameters():
            v = _v(p)
            g = v.grad if v.grad is not None else v.detach() * 0
            g = g.contiguous()
            collective.all_reduce(g, group=group)
            v.grad = g

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """reference: pipeline_parallel.py:127: one optimizer step over
        the batch's microbatches; returns the mean microbatch loss."""
        if self._loss_fn is None:
            raise RuntimeError(
                "train_batch needs the PipelineLayer to be built with loss_fn")
        total = self._pipelined_loss(data, scaler)
        if total is None:  # pp 1: the microbatches one after another
            xs, ys = data
            B = _v(xs).shape[0]
            n = self._num_microbatches(B, False, 1)
            if B % n:
                raise ValueError(f"batch {B} not divisible by "
                                 f"accumulate_steps {n}")
            m = B // n
            for i in range(n):
                xb = _like(xs, _v(xs)[i * m:(i + 1) * m])
                yb = _like(ys, _v(ys)[i * m:(i + 1) * m])
                loss = self._loss_fn(self._layers(xb), yb)
                if n > 1:
                    loss = loss / float(n)
                if scaler is not None:
                    scaler.scale(loss).backward()
                else:
                    loss.backward()
                total = loss if total is None else total + loss
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total

    def eval_batch(self, data, compute_loss: bool = True):
        """The model's output on the batch (every stage holds the last
        stage's), or its loss."""
        xs, ys = data
        out = self._layers(xs)
        if compute_loss and self._loss_fn is not None:
            return self._loss_fn(out, ys)
        return out

