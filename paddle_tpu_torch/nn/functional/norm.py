"""Normalization functionals (``paddle_tpu/nn/functional/norm.py``).

Each takes the JAX package's signature, facade or torch tensors
(``tensor.facade_io``), and casts by the amp rule under its op name
(all five are on the black list: f32 under ``auto_cast``). Variances
are the population's. ``batch_norm`` in training writes the running
statistics it is given in place (``copy_`` under ``no_grad``), so a
Layer's buffers, and a captured step that holds them, see every update.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as tF

from ...amp import cast_inputs
from ...tensor import facade_io
from .common import as_torch

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm"]


def _opt(t, ref=None):
    return None if t is None else as_torch(t, ref)


def _affine(y, w, b, shape):
    if w is not None:
        y = y * w.reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    return y


@facade_io
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats: Optional[bool] = None, name=None):
    """Batch statistics in training (unless ``use_global_stats``), which
    also move the running ones: ``r = momentum * r + (1 - momentum) *
    batch``; the running statistics otherwise."""
    x = as_torch(x)
    rm, rv = as_torch(running_mean, x), as_torch(running_var, x)
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    shape = [1] * x.dim()
    shape[ch] = -1
    if training and not use_global_stats:
        with torch.no_grad():
            xs = x.detach()
            mean, var = xs.mean(axes), xs.var(axes, unbiased=False)
            rm.copy_(momentum * rm + (1 - momentum) * mean.to(rm.dtype))
            rv.copy_(momentum * rv + (1 - momentum) * var.to(rv.dtype))
        a, w, b = cast_inputs("batch_norm", x, _opt(weight), _opt(bias))
        mu = a.mean(axes, keepdim=True)
        v2 = a.var(axes, unbiased=False, keepdim=True)
        return _affine((a - mu) / torch.sqrt(v2 + epsilon), w, b,
                       shape).to(a.dtype)
    a, mu, v2, w, b = cast_inputs("batch_norm", x, rm, rv, _opt(weight),
                                  _opt(bias))
    y = (a - mu.reshape(shape)) * (1.0 / torch.sqrt(
        v2.reshape(shape) + epsilon)).to(a.dtype)
    return _affine(y, w, b, shape).to(a.dtype)


@facade_io
def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5, name=None):
    """``(x - mean) / sqrt(var + eps) * weight + bias`` over the trailing
    ``normalized_shape`` dims, in x's dtype after the amp cast (f32 under
    ``auto_cast``). Mixed dtypes (a bf16 input with f32 norm parameters,
    outside ``auto_cast``) compute in f32."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = cast_inputs("layer_norm", as_torch(x), _opt(weight),
                                  _opt(bias))
    dtypes = {t.dtype for t in (x, weight, bias) if t is not None}
    if len(dtypes) == 1:
        return tF.layer_norm(x, tuple(normalized_shape), weight, bias,
                             epsilon)
    up = [t.float() if t is not None else None for t in (x, weight, bias)]
    return tF.layer_norm(up[0], tuple(normalized_shape), up[1], up[2],
                         epsilon).to(x.dtype)


@facade_io
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats: bool = True,
                  momentum: float = 0.9, eps: float = 1e-5,
                  data_format: str = "NCHW", name=None):
    """Statistics per (sample, channel) over the spatial axes."""
    a, w, b = cast_inputs("instance_norm", as_torch(x), _opt(weight),
                          _opt(bias))
    ch = 1 if data_format.startswith("NC") else a.dim() - 1
    sp = (tuple(range(2, a.dim())) if ch == 1
          else tuple(range(1, a.dim() - 1)))
    mu = a.mean(sp, keepdim=True)
    var = a.var(sp, unbiased=False, keepdim=True)
    shape = [1] * a.dim()
    shape[ch] = -1
    return _affine((a - mu) / torch.sqrt(var + eps), w, b,
                   shape).to(a.dtype)


@facade_io
def group_norm(x, num_groups: int, epsilon: float = 1e-5, weight=None,
               bias=None, data_format: str = "NCHW", name=None):
    """Statistics per (sample, group of channels)."""
    a, w, b = cast_inputs("group_norm", as_torch(x), _opt(weight),
                          _opt(bias))
    channel_last = not data_format.startswith("NC")
    at = a.movedim(-1, 1) if channel_last else a
    n, c = at.shape[:2]
    g = at.reshape((n, num_groups, c // num_groups) + tuple(at.shape[2:]))
    axes = tuple(range(2, g.dim()))
    mu = g.mean(axes, keepdim=True)
    var = g.var(axes, unbiased=False, keepdim=True)
    y = ((g - mu) / torch.sqrt(var + epsilon)).reshape(at.shape)
    y = _affine(y, w, b, [1, c] + [1] * (at.dim() - 2))
    if channel_last:
        y = y.movedim(1, -1)
    return y.to(a.dtype)


@facade_io
def local_response_norm(x, size: int, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0,
                        data_format: str = "NCHW", name=None):
    """``x / (k + alpha * sum of x^2 over a window of size channels) **
    beta``, the window ``[c - size // 2, c + (size - 1) // 2]``."""
    (a,) = cast_inputs("local_response_norm", as_torch(x))
    ch = 1 if data_format.startswith("NC") else a.dim() - 1
    half = size // 2
    sq = (a * a).movedim(ch, -1)
    padded = tF.pad(sq, [half, size - half - 1])
    n = a.shape[ch]
    acc = sum(padded[..., i: i + n] for i in range(size))
    return a / (k + alpha * acc.movedim(-1, ch)) ** beta
