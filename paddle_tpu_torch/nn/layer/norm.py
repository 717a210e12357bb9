"""``LayerNorm`` (``paddle_tpu/nn/layer/norm.py``). Its class name keeps
its parameters in f32 under ``amp.decorate(level="O2")``."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.eps)
