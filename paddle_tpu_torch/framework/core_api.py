"""Dtype meta, predicates and ``create_parameter``
(``paddle_tpu/framework/core_api.py:30-84``, ``:139``).

``iinfo`` and ``finfo`` are torch's (``finfo(bfloat16)`` included).
``set_default_dtype`` records the name ``get_default_dtype`` returns, as
there; creation ops take their dtype from their own defaults, as there.
``create_parameter`` draws from the global generator: zeros for a bias,
else Xavier-normal (``std = sqrt(2 / (fan_in + fan_out))``, the fans of
a Paddle ``[in, out]`` weight), on the default device.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from .. import dtypes

__all__ = ["dtype", "iinfo", "finfo", "get_default_dtype",
           "set_default_dtype", "is_tensor", "is_grad_enabled",
           "in_dynamic_mode", "create_parameter"]


def dtype(name):
    """``paddle.dtype``: a dtype spec as a torch dtype."""
    return dtypes.convert_dtype(name)


def iinfo(dt):
    return torch.iinfo(dtypes.convert_dtype(dt))


def finfo(dt):
    return torch.finfo(dtypes.convert_dtype(dt))


_default_dtype = ["float32"]


def get_default_dtype() -> str:
    return _default_dtype[0]


def set_default_dtype(d) -> None:
    name = dtypes.dtype_name(d)
    if name not in ("float16", "float32", "float64", "bfloat16"):
        raise TypeError(f"set_default_dtype only accepts floating dtypes, "
                        f"got {d!r}")
    _default_dtype[0] = name


def is_tensor(x) -> bool:
    from ..tensor import Tensor

    return isinstance(x, Tensor)


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def in_dynamic_mode() -> bool:
    """Always eager: the port has no static mode yet."""
    return True


def create_parameter(shape: Sequence[int], dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A standalone Parameter (module docstring). ``default_initializer``
    is a callable ``(shape, torch dtype) -> tensor`` when given; ``attr``
    is not ported."""
    from ..device import default_device
    from ..generator import default_generator
    from ..tensor import Parameter

    if attr is not None:
        raise NotImplementedError("create_parameter(attr=...) is not ported")
    shape = tuple(int(s) for s in shape)
    dt = dtypes.convert_dtype(dtype)
    if default_initializer is not None:
        value = default_initializer(shape, dt)
    elif is_bias:
        value = torch.zeros(shape, dtype=dt)
    else:
        fan_in = shape[0] if shape else 1
        fan_out = shape[1] if len(shape) > 1 else fan_in
        std = math.sqrt(2.0 / (fan_in + fan_out))
        value = torch.randn(shape, generator=default_generator).to(dt) * std
    return Parameter(torch.as_tensor(value).to(default_device()), name=name)
