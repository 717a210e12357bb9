"""Carry weights across from the JAX package's ``state_dict``.

A Paddle ``Layer`` model of the port (BERT) holds the JAX model's
names, layouts and buffers, and takes its ``state_dict`` as it is. For
the ``torch.nn`` models (GPT, Llama) the JAX package and the port name
every parameter alike
(``llama.layers.0.self_attn.q_proj.weight``,
``gpt.layers.0.attn.qkv_proj.weight``, ...). Its ``Linear`` stores
``[in, out]`` and ``torch.nn.Linear`` ``[out, in]``, so every Linear
weight is transposed on the way in; embeddings, biases and norms copy as
they are. Loading is strict: every key on both sides is used and every
shape must match.

bf16 arrays (``ml_dtypes.bfloat16``, what the JAX package's ``state_dict``
holds after ``amp.decorate(level="O2")``) cross as their 16-bit patterns:
numpy ``uint16`` -> ``torch.int16`` -> ``.view(torch.bfloat16)``, so the
values arrive bit for bit and never pass through f32.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..nn.layer_base import Layer

__all__ = ["load_reference_state_dict"]


@torch.no_grad()
def load_reference_state_dict(model: nn.Module,
                              ref: Dict[str, np.ndarray]) -> None:
    """Copy ``ref`` (the JAX model's ``state_dict()`` as numpy arrays) into
    ``model`` in place, in the model's dtype and on its device. Raises
    ``KeyError`` on a missing or unexpected key and ``ValueError`` on a
    shape mismatch. A Paddle ``Layer`` model (BERT) has the reference's
    names, layouts and buffers, so it loads through ``set_state_dict``
    with no transposes."""
    if isinstance(model, Layer):
        missing, unexpected = model.set_state_dict(ref)
        if missing or unexpected:
            raise KeyError(f"state dict mismatch: missing {missing}, "
                           f"unexpected {unexpected}")
        return
    linear = {f"{name}.weight" for name, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(ref))
    unexpected = sorted(set(ref) - set(params))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for key, p in params.items():
        src = np.asarray(ref[key])
        if key in linear:
            src = src.T
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(
                f"{key}: reference shape {tuple(np.asarray(ref[key]).shape)}"
                f" does not fit {tuple(p.shape)}"
                f"{' (transposed Linear)' if key in linear else ''}")
        p.copy_(_to_torch(src).to(p.dtype))


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor of its own dtype; bf16 by bit pattern."""
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: torch refuses it
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))
