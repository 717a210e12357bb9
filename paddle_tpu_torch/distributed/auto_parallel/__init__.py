"""Auto-parallel: the Engine high-level distributed training loop
(``paddle_tpu/distributed/auto_parallel/__init__.py``).

Reference parity: ``Engine``
(python/paddle/distributed/auto_parallel/engine.py:55 — ``fit`` :848,
``evaluate`` :1018, ``predict`` :1128, ``prepare`` :1309, ``save`` :1615,
``load`` :1699, ``cost`` :1751) and ``Strategy``
(auto_parallel/strategy.py).

The JAX package places each batch with a ``dp``-sharded ``NamedSharding``
and lets GSPMD propagate it through one compiled step. The port runs one
process per rank:

- the mesh is the live one, or an all-``dp`` fleet mesh over every rank
  (``fleet.init`` with ``dp_degree`` -1), as there;
- every rank's loader yields the same global batch (the same seed and
  the same shuffle), and each rank keeps its rows of it along ``dp``
  (rank ``i`` of ``n`` the ``i``-th block); a batch whose rows do not
  split evenly stays whole on every rank, as the JAX package keeps it
  replicated;
- with ``dp`` above 1 the model goes through ``fleet.distributed_model``
  (``DataParallel`` when fleet is not initialised), whose reducer
  averages the gradients over ``dp``: each rank's loss is the mean over
  its rows, so the update is the global batch's mean, as under GSPMD;
- the step is ``jit.StaticFunction`` over the JAX package's ``step``
  closures: a CUDA graph per signature on the card, eager on the CPU,
  and eager where a collective of the step runs on ``gloo`` (its ranks
  share a card; ``DataParallel.__jit_capture__``);
- the losses the loop reports are averaged over ``dp`` and the outputs
  (for the metrics and ``predict``) gathered back to the global batch,
  so they equal one process's;
- ``cost()`` is ``StaticFunction.cost_analysis``: the products that
  ``torch.utils.flop_counter`` counts on a signature's first call plus
  the flash kernels' flops, and the peak bytes of that call.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ...io.dataloader import DataLoader
from ...metric import Metric
from ...nn.layer_base import Layer
from ...ops._apply import ensure_tensor
from ...tensor import Tensor
from .. import collective, topology
from ..sharding_api import ProcessMesh, reshard, shard_tensor  # noqa: F401

__all__ = ["Engine", "Strategy", "ProcessMesh", "shard_tensor", "reshard"]


class Strategy:
    """reference: auto_parallel/strategy.py — config sections carried as
    attribute namespaces; the data-parallel degree comes from the live
    mesh."""

    class _Section(dict):
        def __getattr__(self, k):
            return self.get(k)

        def __setattr__(self, k, v):
            self[k] = v

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        for name in ("amp", "sharding", "gradient_merge", "recompute",
                     "pipeline", "fused_passes", "dataset"):
            setattr(self, name, Strategy._Section(config.get(name, {})))
        self.auto_mode = config.get("auto_mode", "semi")
        self.seed = config.get("seed", None)


def _default_mesh():
    """The live hybrid mesh, or a fresh all-dp mesh (reference: Engine
    builds a default 1D process mesh over all ranks when none is
    annotated)."""
    mesh = topology.get_mesh()
    if mesh is not None:
        return mesh
    from ..fleet import DistributedStrategy, fleet

    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": -1}
    fleet.init(is_collective=True, strategy=s)
    return topology.get_mesh()


class Engine:
    """reference: engine.py:55."""

    def __init__(self, model=None, loss=None, optimizer=None,
                 metrics=None, cluster=None, strategy: Strategy = None):
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        metrics = metrics or []
        if isinstance(metrics, Metric):
            metrics = [metrics]
        self._metrics: List[Metric] = metrics
        self._strategy = strategy or Strategy()
        self._cluster = cluster
        self._mesh = None
        self._net = None      # the model the steps call (module docstring)
        self._steps = {}      # mode -> StaticFunction
        self.history = None

    # ------------------------------------------------------------ plumbing
    def _ensure_mesh(self):
        if self._mesh is None:
            self._mesh = _default_mesh()
        return self._mesh

    def _dp(self):
        """``(dp size, this rank's index on dp, the dp group or None)``."""
        mesh = self._ensure_mesh()
        if "dp" not in mesh.axis_names or mesh.shape["dp"] <= 1:
            return 1, 0, None
        return mesh.shape["dp"], mesh.coordinate()["dp"], mesh.group("dp")

    def _network(self):
        """The model, wrapped for ``dp`` above 1 (module docstring)."""
        if self._net is None:
            n, _, group = self._dp()
            if n <= 1:
                self._net = self._model
            else:
                from ..fleet import fleet
                from ..parallel import DataParallel

                if fleet._is_initialized and fleet._is_collective:
                    self._net = fleet.distributed_model(self._model)
                else:
                    self._net = DataParallel(self._model, group=group)
        return self._net

    def _device(self) -> torch.device:
        for p in self._model.parameters():
            return getattr(p, "_value", p).device
        from ...device import default_device

        return default_device()

    def _to_device(self, arr) -> Tensor:
        t = ensure_tensor(arr)
        dev = self._device()
        if t._value.device != dev:
            t = Tensor._wrap(t._value.to(dev))
        return t

    def _shard_batch(self, arr):
        """This rank's rows of the global batch along ``dp`` (module
        docstring), on the model's device; the whole batch when ``dp``
        is 1 or its rows do not split evenly."""
        t = self._to_device(arr)
        n, i, _ = self._dp()
        if n <= 1 or t._value.shape[0] % n:
            return t
        rows = t._value.shape[0] // n
        return Tensor._wrap(t._value.narrow(0, i * rows, rows))

    def _sharded(self, batch_rows: int) -> bool:
        n = self._dp()[0]
        return n > 1 and batch_rows % n == 0

    def _gather(self, out, sharded: bool):
        """``out`` (a Tensor or a list/tuple of them) gathered back to the
        global batch over ``dp`` when the batch was split."""
        if not sharded or out is None:
            return out
        if isinstance(out, (list, tuple)):
            return type(out)(self._gather(o, True) for o in out)
        v = getattr(out, "_value", out)
        parts = collective.all_gather(None, v.detach().contiguous(),
                                      group=self._dp()[2])
        return Tensor._wrap(torch.cat(list(parts.unbind(0)), dim=0))

    def _mean_loss(self, loss, sharded: bool) -> float:
        """The step's loss, averaged over ``dp`` when the batch was split
        (equal rows a rank: the mean of the ranks' means is the global
        batch's)."""
        v = getattr(loss, "_value", loss).detach().float().reshape(1)
        if sharded:
            v = v.clone()
            collective.all_reduce(v, op=collective.ReduceOp.AVG,
                                  group=self._dp()[2])
        return float(v)

    def _get_step(self, mode: str):
        if mode in self._steps:
            return self._steps[mode]
        from ... import jit

        model, loss_fn, opt = self._network(), self._loss, self._optimizer

        if mode == "train":
            def step(inputs, labels):
                out = model(inputs)
                loss = loss_fn(out, labels)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss, out
        elif mode == "eval":
            def step(inputs, labels):
                from ...autograd import no_grad

                with no_grad():
                    out = model(inputs)
                    loss = (loss_fn(out, labels)
                            if loss_fn is not None else None)
                return loss, out
        else:
            def step(inputs):
                from ...autograd import no_grad

                with no_grad():
                    return model(inputs)

        observe = [model] + ([opt] if opt is not None else []) \
            + ([loss_fn] if isinstance(loss_fn, Layer) else [])
        sf = jit.StaticFunction(step, observe=observe, warmup=False)
        self._steps[mode] = sf
        return sf

    def _loader(self, data, batch_size, shuffle=False):
        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=True)

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) == 2:
                return batch[0], batch[1]
            return batch[0], list(batch[1:])
        return batch, None

    def _place(self, inputs, labels):
        """``(inputs, labels, global labels, sharded)`` of one batch."""
        inputs = ensure_tensor(inputs)
        sharded = self._sharded(inputs._value.shape[0])
        glabels = None if labels is None else self._to_device(labels)
        return (self._shard_batch(inputs),
                None if labels is None else self._shard_batch(labels),
                glabels, sharded)

    # ------------------------------------------------------------ user API
    def fit(self, train_data=None, valid_data=None, batch_size: int = 1,
            epochs: int = 1, steps_per_epoch: Optional[int] = None,
            log_freq: int = 10, save_dir: Optional[str] = None,
            save_freq: int = 1, valid_freq: int = 1,
            valid_steps: Optional[int] = None, collate_fn=None,
            callbacks=None, verbose: int = 2, nvprof_range=None):
        """reference: engine.py:848 — the distributed training loop."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError(
                "Engine(model, loss, optimizer) must all be set for fit()")
        self._ensure_mesh()
        loader = self._loader(train_data, batch_size, shuffle=True)
        step_fn = self._get_step("train")
        history = {"loss": []}
        global_step = 0
        for epoch in range(epochs):
            # re-assert train mode each epoch: a valid_data evaluate() at the
            # end of the previous epoch switched the model to eval
            self._model.train()
            for m in self._metrics:
                m.reset()
            epoch_losses = []
            for i, batch in enumerate(loader):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                inputs, labels, glabels, sharded = self._place(
                    *self._split_batch(batch))
                loss, out = step_fn(inputs, labels)
                lv = self._mean_loss(loss, sharded)
                epoch_losses.append(lv)
                self._update_metrics(self._gather(out, sharded), glabels)
                global_step += 1
                if verbose and i % log_freq == 0:
                    msg = f"epoch {epoch} step {i} loss {lv:.5f}"
                    for m in self._metrics:
                        for nm, v in self._metric_items(m):
                            msg += f" {nm} {v:.5f}"
                    print(f"[auto_parallel.Engine] {msg}", flush=True)
            history["loss"].append(
                float(np.mean(epoch_losses)) if epoch_losses else None)
            for m in self._metrics:
                for nm, v in self._metric_items(m):
                    history.setdefault(nm, []).append(v)
            if valid_data is not None and (epoch + 1) % valid_freq == 0:
                self.evaluate(valid_data, batch_size=batch_size,
                              steps=valid_steps, verbose=0)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, f"epoch{epoch}"))
        self.history = history
        return history

    def evaluate(self, valid_data=None, batch_size: int = 1,
                 steps: Optional[int] = None, log_freq: int = 10,
                 collate_fn=None, callbacks=None, verbose: int = 2):
        """reference: engine.py:1018."""
        self._ensure_mesh()
        loader = self._loader(valid_data, batch_size)
        step_fn = self._get_step("eval")
        self._model.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        for i, batch in enumerate(loader):
            if steps is not None and i >= steps:
                break
            inputs, labels, glabels, sharded = self._place(
                *self._split_batch(batch))
            loss, out = step_fn(inputs, labels)
            if loss is not None:
                losses.append(self._mean_loss(loss, sharded))
            self._update_metrics(self._gather(out, sharded), glabels)
        res = {"loss": float(np.mean(losses)) if losses else None}
        for m in self._metrics:
            res.update(self._metric_items(m))
        if verbose:
            print(f"[auto_parallel.Engine] eval {res}", flush=True)
        return res

    def predict(self, test_data=None, batch_size: int = 1,
                steps: Optional[int] = None, collate_fn=None,
                callbacks=None, verbose: int = 2):
        """reference: engine.py:1128 — returns the list of batch outputs
        (the global batch's, as host arrays)."""
        self._ensure_mesh()
        loader = self._loader(test_data, batch_size)
        step_fn = self._get_step("predict")
        self._model.eval()
        outputs = []
        for i, batch in enumerate(loader):
            if steps is not None and i >= steps:
                break
            inputs, _ = self._split_batch(batch)
            inputs = ensure_tensor(inputs)
            sharded = self._sharded(inputs._value.shape[0])
            out = self._gather(step_fn(self._shard_batch(inputs)), sharded)
            out = out[0] if isinstance(out, (list, tuple)) else out
            outputs.append(np.asarray(out.numpy()))
        return outputs

    def prepare(self, inputs_spec=None, labels_spec=None, mode: str = "train"):
        """reference: engine.py:1309 — run the given mode's step once for
        the given input specs (shape/dtype): on the card its first call,
        which the capture follows."""
        self._ensure_mesh()
        step_fn = self._get_step(mode)
        if inputs_spec is None:
            return step_fn

        def zeros_of(spec):
            from ...dtypes import convert_dtype

            shape = [d if d is not None else 1 for d in spec.shape]
            return Tensor._wrap(torch.zeros(shape,
                                            dtype=convert_dtype(spec.dtype)))
        ins = zeros_of(inputs_spec if not isinstance(inputs_spec, (list, tuple))
                       else inputs_spec[0])
        if mode == "predict":
            step_fn(self._shard_batch(ins))
        else:
            labs = zeros_of(labels_spec if not isinstance(
                labels_spec, (list, tuple)) else labels_spec[0])
            step_fn(self._shard_batch(ins), self._shard_batch(labs))
        return step_fn

    @staticmethod
    def _metric_items(m: Metric):
        """(name, value) pairs — Metric.name() may be a list (topk)."""
        names, accs = m.name(), m.accumulate()
        if isinstance(names, (list, tuple)):
            accs = accs if isinstance(accs, (list, tuple)) else [accs]
            return list(zip(names, accs))
        return [(names, accs)]

    def _update_metrics(self, outputs, labels):
        out = outputs if not isinstance(outputs, (list, tuple)) else outputs[0]
        for m in self._metrics:
            try:
                r = m.compute(out, labels)
                m.update(*(r if isinstance(r, (list, tuple)) else (r,)))
            except Exception as e:
                import warnings

                warnings.warn(
                    f"metric {type(m).__name__} failed to update and will "
                    f"report stale values: {type(e).__name__}: {e}",
                    stacklevel=2)

    # ------------------------------------------------------------ save/load
    def save(self, path: str, training: bool = True):
        """reference: engine.py:1615 — through the distributed checkpoint
        module (``distributed/checkpoint``: process 0 writes the
        replicated leaves); with several ranks, every rank has returned
        from it only once all have."""
        from ..checkpoint import save_state_dict

        state = {"model": self._model.state_dict()}
        if training and self._optimizer is not None:
            state["optimizer"] = self._optimizer.state_dict()
        save_state_dict(state, path)
        if topology.world_group().nranks > 1:
            collective.barrier()

    def load(self, path: str, strict: bool = True, load_optimizer: bool = True):
        """reference: engine.py:1699 — onto the model's device."""
        from ..checkpoint import load_state_dict

        state = load_state_dict(path, device=self._device())
        model_state = state.get("model", {})
        if isinstance(self._model, Layer):
            self._model.set_state_dict(model_state)
        else:
            self._model.load_state_dict(
                {k: getattr(v, "_value", v) for k, v in model_state.items()},
                strict=strict)
        if load_optimizer and self._optimizer is not None and \
                "optimizer" in state:
            self._optimizer.set_state_dict(state["optimizer"])

    # ------------------------------------------------------------ cost
    def cost(self, inputs_spec=None, labels_spec=None, mode: str = "train"):
        """reference: engine.py:1751 — the reference estimates with a python
        cost model (auto_parallel/cost/); here the step reports what its
        first call did (``StaticFunction.cost_analysis``: ``flops``,
        ``peak_bytes``). Runs the step for ``inputs_spec`` first when
        given; None if the mode's step has not run."""
        if inputs_spec is not None:
            self.prepare(inputs_spec, labels_spec, mode=mode)
        sf = self._steps.get(mode)
        if sf is None:
            return None
        return sf.cost_analysis()
