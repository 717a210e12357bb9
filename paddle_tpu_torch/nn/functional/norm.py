"""``layer_norm`` (``paddle_tpu/nn/functional/norm.py``) and ``rms_norm``
(the JAX package's ``nn.RMSNorm`` forward, ``nn/layer/norm.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...amp import cast_inputs

__all__ = ["layer_norm", "rms_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """``(x - mean) / sqrt(var + eps) * weight + bias`` over the trailing
    ``normalized_shape`` dims, population variance, in x's dtype after the
    amp cast (f32 under ``auto_cast``). Mixed dtypes (a bf16 input with
    f32 norm parameters, outside ``auto_cast``) compute in f32."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    dtypes = {t.dtype for t in (x, weight, bias) if t is not None}
    if len(dtypes) == 1:
        return tF.layer_norm(x, tuple(normalized_shape), weight, bias,
                             epsilon)
    up = [t.float() if t is not None else None for t in (x, weight, bias)]
    return tF.layer_norm(up[0], tuple(normalized_shape), up[1], up[2],
                         epsilon).to(x.dtype)


def rms_norm(x, weight, epsilon: float = 1e-6):
    """``x * (1 / sqrt(mean(x.f32 ** 2) + eps)).to(x.dtype) * weight`` over
    the last dim, the JAX package's formula. ``rms_norm`` is on the amp
    black list, so under ``auto_cast`` a bf16 input and its f32 weight
    compute in f32 and give f32; outside it mixed dtypes promote (a bf16
    input over f32 weights gives f32)."""
    x, weight = cast_inputs("rms_norm", x, weight)
    var = x.to(torch.float32).pow(2).mean(dim=-1, keepdim=True)
    return x * (1.0 / torch.sqrt(var + epsilon)).to(x.dtype) * weight
