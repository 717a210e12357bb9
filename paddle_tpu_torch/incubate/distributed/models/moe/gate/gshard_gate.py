"""reference: incubate/distributed/models/moe/gate/gshard_gate.py: the
top-2 gate with GShard's load-balance loss, capacity limiting and the
second expert's random routing.

Under expert parallelism (``_ep``, set by ``MoELayer``) the statistics
are the JAX package's, over every rank's tokens: the capacity is
``ceil(rate * T)`` over the global token count and arrival order
(``limit_by_capacity`` with the group), and the aux loss is the product
of the global means ``c_e`` and ``m_e``, each all-reduced before it
(an average of the ranks' products is another loss)."""
from __future__ import annotations

import math

import torch

from ......generator import device_generator
from ......tensor import Tensor
from ..utils import _random_routing, all_reduce_autograd, limit_by_capacity
from .naive_gate import NaiveGate


class GShardGate(NaiveGate):
    def __init__(self, d_model: int, num_expert: int, world_size: int,
                 topk: int = 2, capacity=(1.2, 2.4),
                 random_routing: bool = True, group=None):
        assert topk == 2, "topk should be 2 in gshard"
        super().__init__(d_model, num_expert, world_size)
        self.capacity = capacity
        self.random_routing = random_routing
        self.group = group

    def forward(self, x):
        topk_val, topk_idx, gate_score = super().forward(
            x, return_all_scores=True)
        score = gate_score._value
        s = score.shape[0]
        top1 = topk_idx._value[:, 0]
        c_e = torch.nn.functional.one_hot(top1, self.tot_expert).float() \
            .mean(0)
        m_e = torch.softmax(score.float(), dim=1).mean(0)
        c_e = all_reduce_autograd(c_e, self._ep, "avg")
        m_e = all_reduce_autograd(m_e, self._ep, "avg")
        self.set_loss(Tensor._wrap((c_e * m_e).mean()
                                   * (self.num_expert ** 2)))

        cap_rate = self.capacity[0 if self.training else 1]
        capacity = math.ceil(cap_rate * s * self._ep_size())
        _, _, topk_idx = limit_by_capacity(
            topk_idx, self.num_expert, self.world_size, capacity,
            group=self._ep)

        if self.random_routing and self.training:
            gen = device_generator(score.device)
            rand_prob = torch.rand((s,), generator=gen, device=score.device)
            topk_idx = _random_routing(topk_idx, topk_val, rand_prob)
        return topk_val, topk_idx
