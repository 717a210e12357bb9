"""The ``torch.nn`` layers that the port's GPT and Llama models are built
from, and ``rms_norm`` (the JAX package's ``nn.RMSNorm`` formula, not a
Paddle functional).

These are not Paddle's API: the models are ``torch.nn.Module``s whose
``Linear`` weight is ``[out, in]`` (``torch.nn.Linear``'s storage; the
JAX package's is ``[in, out]``, which ``models/convert.py`` transposes
on the way in). Each forward goes through the amp cast rule under the
JAX package's op name (:func:`..amp.cast_inputs`), as the Paddle
functionals of ``nn.functional`` do. ``paddle.nn`` holds the Paddle
layers (``nn.Layer`` over facade Parameters, ``[in, out]`` weights).
"""
from __future__ import annotations

import torch
from torch import nn

from ..amp import cast_inputs
from ..nn import functional as F

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "rms_norm"]


def rms_norm(x, weight, epsilon: float = 1e-6):
    """``x * (1 / sqrt(mean(x.f32 ** 2) + eps)).to(x.dtype) * weight`` over
    the last dim, the JAX package's ``nn.RMSNorm`` formula. ``rms_norm``
    is on the amp black list, so under ``auto_cast`` a bf16 input and its
    f32 weight compute in f32 and give f32; outside it mixed dtypes
    promote (a bf16 input over f32 weights gives f32)."""
    x, weight = cast_inputs("rms_norm", x, weight)
    var = x.to(torch.float32).pow(2).mean(dim=-1, keepdim=True)
    return x * (1.0 / torch.sqrt(var + epsilon)).to(x.dtype) * weight


class Linear(nn.Linear):
    """``torch.nn.Linear``'s ``[out, in]`` weight, read by Paddle's
    ``F.linear`` through its transpose (a view: the product is
    ``torch``'s ``x @ weight.T + bias``, promoted and amp-cast as
    ``linear``)."""

    def forward(self, x):
        return F.linear(x, self.weight.t(), self.bias)


class Embedding(nn.Embedding):
    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LayerNorm(nn.LayerNorm):
    """Its class name keeps its parameters in f32 under
    ``amp.decorate(level="O2")``."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.eps)


class RMSNorm(nn.Module):
    """RMS norm over the last dim with a unit-initialised weight
    (:func:`rms_norm`)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.epsilon = epsilon

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
