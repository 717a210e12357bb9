"""``linear``, ``embedding`` and ``dropout``
(``paddle_tpu/nn/functional/common.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as tF

from ...amp import cast_inputs
from ...generator import device_generator

__all__ = ["linear", "embedding", "dropout"]


def linear(x, weight, bias=None):
    """``x @ weight.T + bias``; ``weight`` is ``[out, in]``. Mixed dtypes
    (an f32 input over bf16 weights, outside ``auto_cast``) compute in
    the promoted dtype, as ``jnp.matmul`` promotes: the weight is up-cast
    for the call, and no copy is kept."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    dt = x.dtype
    for t in (weight, bias):
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    x, weight, bias = (t.to(dt) if t is not None else None
                       for t in (x, weight, bias))
    return tF.linear(x, weight, bias)


def embedding(ids, weight):
    (weight,) = cast_inputs("embedding", weight)
    return tF.embedding(ids, weight)


def dropout(x, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None):
    """Upscale-in-train dropout: each element kept with probability
    ``1 - p`` and divided by it. The keep bits come from ``generator``
    (on x's device), by default a fresh one seeded from the global
    generator."""
    if not training or p == 0.0:
        return x
    (x,) = cast_inputs("dropout", x)
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        generator = device_generator(x.device)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
