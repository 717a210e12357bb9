"""Per-slot absmax int8 quantization of KV pages.

Counterpart of the KV helpers of ``paddle_tpu/quantization/observers.py``
(``kv_absmax_scales``, ``quantize_kv``, ``dequantize_kv``): the serving
engine stores int8 pages with one f32 scale per (token slot, kv head),
``scale = max(max|x| / 127, 1e-8)`` over the head dimension, computed at
every KV write. Plain torch ops, as the JAX package computes them outside
any Pallas kernel; the paged-attention kernel (K4) dequantizes in
registers with the same ``q * scale``.

Bit for bit with the JAX package: the division and the clamp are f32 in
both, and ``torch.round`` rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

__all__ = ["AbsmaxObserver", "KV_QMAX", "KV_SCALE_FLOOR", "kv_absmax_scales",
           "quantize_kv", "dequantize_kv"]


def __getattr__(name):
    """``AbsmaxObserver``, the model observer, lives in the package."""
    if name == "AbsmaxObserver":
        from . import AbsmaxObserver

        return AbsmaxObserver
    raise AttributeError(name)

# symmetric int8 grid [-127, 127] (the -128 code is unused)
KV_QMAX = 127.0
# an all-zero slot still gets a nonzero scale, so dequantization gives 0
KV_SCALE_FLOOR = 1e-8


def kv_absmax_scales(x: torch.Tensor, qmax: float = KV_QMAX,
                     floor: float = KV_SCALE_FLOOR) -> torch.Tensor:
    """Per-slot absmax scales over the last axis: ``x`` ``[...,
    head_dim]`` -> f32 ``[...]``, ``max(max|x| / qmax, floor)``."""
    ax = x.to(torch.float32).abs().amax(dim=-1)
    return torch.clamp_min(ax / qmax, floor)


def quantize_kv(x: torch.Tensor, qmax: float = KV_QMAX,
                floor: float = KV_SCALE_FLOOR):
    """``(codes int8 [..., head_dim], scales f32 [...])`` with ``codes =
    clip(round(x / scale), -qmax, qmax)``."""
    s = kv_absmax_scales(x, qmax=qmax, floor=floor)
    q = torch.clamp(torch.round(x.to(torch.float32) / s[..., None]),
                    -qmax, qmax).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``q * scales[..., None]`` in f32."""
    return q.to(torch.float32) * scales[..., None].to(torch.float32)
