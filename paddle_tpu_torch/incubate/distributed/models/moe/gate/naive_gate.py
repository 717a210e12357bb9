"""reference: incubate/distributed/models/moe/gate/naive_gate.py: a
linear gate and top-k selection (no capacity limit, no aux loss)."""
from __future__ import annotations

import torch

from ......nn.layer.common import Linear
from ......tensor import Tensor
from .base_gate import BaseGate


class NaiveGate(BaseGate):
    def __init__(self, d_model: int, num_expert: int, world_size: int,
                 topk: int = 2):
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert)
        self.top_k = topk

    def forward(self, inp, return_all_scores: bool = False):
        gate = self.gate(inp)
        val, idx = torch.topk(gate._value, self.top_k, dim=-1, largest=True,
                              sorted=True)
        val, idx = Tensor._wrap(val), Tensor._wrap(idx)
        if return_all_scores:
            return val, idx, gate
        return val, idx
