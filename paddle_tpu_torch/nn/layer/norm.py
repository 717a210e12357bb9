"""``LayerNorm`` and ``RMSNorm`` (``paddle_tpu/nn/layer/norm.py``). Their
class names keep their parameters in f32 under
``amp.decorate(level="O2")``."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.eps)


class RMSNorm(nn.Module):
    """RMS norm over the last dim with a unit-initialised weight
    (:func:`..functional.rms_norm`)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.epsilon = epsilon

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
