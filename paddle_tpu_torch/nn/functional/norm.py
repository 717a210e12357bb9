"""``layer_norm`` (``paddle_tpu/nn/functional/norm.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...amp import cast_inputs

__all__ = ["layer_norm"]


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
