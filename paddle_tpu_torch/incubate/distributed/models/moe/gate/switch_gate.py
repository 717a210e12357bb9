"""reference: incubate/distributed/models/moe/gate/switch_gate.py: the
top-1 Switch Transformer gate: additive jitter in training, softmax
scores, capacity limiting and the switch load-balance loss
``sum_e fraction_e * prob_e * E`` over the kept assignments.

Under expert parallelism (``_ep``, set by ``MoELayer``) the capacity and
the loss are over every rank's tokens, as ``GShardGate``'s: the kept
count, the per-expert fractions and the probability sums are summed
over the group before the loss is formed."""
from __future__ import annotations

import math

import torch

from ......generator import device_generator
from ......tensor import Tensor
from ..utils import all_reduce_autograd, limit_by_capacity
from .naive_gate import NaiveGate


class SwitchGate(NaiveGate):
    def __init__(self, d_model: int, num_expert: int, world_size: int,
                 topk: int = 1, switch_eps: float = 0.1,
                 capacity=(1.2, 2.4), group=None):
        assert topk == 1, "topk should be 1 in switch"
        super().__init__(d_model, num_expert, world_size, topk=1)
        self.switch_eps = switch_eps
        self.capacity = capacity
        self.group = group

    def forward(self, inp):
        score = self.gate(inp)._value
        if self.training:
            gen = device_generator(score.device)
            noise = torch.rand(score.shape, generator=gen,
                               device=score.device)
            score = score + (noise * (2 * self.switch_eps)
                             + (1.0 - self.switch_eps))
        score = torch.softmax(score.float(), dim=-1).to(score.dtype)
        top1_score, top1_idx = torch.topk(score, 1, dim=-1)

        cap_rate = self.capacity[0 if self.training else 1]
        capacity = math.ceil(cap_rate * inp.shape[0] * self._ep_size())
        _, _, top1_idx = limit_by_capacity(
            top1_idx, self.num_expert, self.world_size, capacity,
            group=self._ep)

        kept = (top1_idx[:, 0] >= 0).float()
        n_kept = all_reduce_autograd(kept.sum(), self._ep).clamp_min(1.0)
        frac = all_reduce_autograd(
            (torch.nn.functional.one_hot(top1_idx[:, 0].clamp_min(0),
                                         self.tot_expert)
             * kept[:, None]).sum(0), self._ep) / n_kept
        prob = all_reduce_autograd(score.sum(0), self._ep) / n_kept
        self.set_loss(Tensor._wrap((frac * prob).sum() * self.tot_expert))
        return Tensor._wrap(top1_score), Tensor._wrap(top1_idx)
