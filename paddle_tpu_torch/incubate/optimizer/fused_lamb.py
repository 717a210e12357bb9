"""DistributedFusedLamb, the port's
``paddle_tpu/incubate/optimizer/fused_lamb.py``: large-batch LAMB for
data-parallel training.

The update is :class:`optimizer.Lamb`'s. What the reference adds on top
stays: gradient accumulation over ``gradient_accumulation_steps`` calls
in buffers of its own (on each parameter's device, summed in place), so
the usual ``backward(); step(); clear_grad()`` loop keeps the pending
microbatches and the applied update uses their mean; and, with
``is_grad_scaled_by_nranks=False``, gradients that arrive summed over
the ranks divided by the mesh's size (``distributed.topology``). The
buffer and NCCL staging knobs (``alignment``, hierarchical all-reduce,
master-parameter norms) are taken and not used.
"""
from __future__ import annotations

import torch

from ...optimizer.optimizer import _value
from ...optimizer.optimizers import Lamb

__all__ = ["DistributedFusedLamb"]


class DistributedFusedLamb(Lamb):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 clip_after_allreduce=True, is_grad_scaled_by_nranks=True,
                 alignment=128, use_master_param_norm=True,
                 gradient_accumulation_steps=1, use_master_acc_grad=True,
                 nproc_per_node=None, use_hierarchical_allreduce=False,
                 name=None):
        super().__init__(learning_rate, lamb_weight_decay, beta1, beta2,
                         epsilon, parameters, grad_clip,
                         exclude_from_weight_decay_fn, name)
        self._is_grad_scaled_by_nranks = bool(is_grad_scaled_by_nranks)
        self._acc_steps = max(int(gradient_accumulation_steps), 1)
        self._acc_count = 0
        self._acc_grads: dict = {}  # parameter index -> summed grads

    def _world_size(self) -> int:
        from ...distributed import topology

        mesh = topology.get_mesh()
        return int(mesh.size) if mesh is not None else 1

    @torch.no_grad()
    def step(self):
        self._acc_count += 1
        params = [_value(p) for p in self._parameter_list]
        if self._acc_steps > 1:
            for i, p in enumerate(params):
                if p.grad is None:
                    continue
                acc = self._acc_grads.get(i)
                if acc is None:
                    self._acc_grads[i] = p.grad.detach().clone()
                else:
                    acc.add_(p.grad)
            if self._acc_count % self._acc_steps:
                return
            scale = 1.0 / self._acc_steps
            for i, p in enumerate(params):
                acc = self._acc_grads.get(i)
                if acc is not None:
                    p.grad = acc * scale
            self._acc_grads.clear()
        world = self._world_size()
        if not self._is_grad_scaled_by_nranks and world > 1:
            for p in params:
                if p.grad is not None:
                    p.grad = p.grad / world
        super().step()
