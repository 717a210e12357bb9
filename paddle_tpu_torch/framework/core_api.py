"""Dtype meta, predicates and ``create_parameter``
(``paddle_tpu/framework/core_api.py:30-84``, ``:139``).

``iinfo`` and ``finfo`` are torch's (``finfo(bfloat16)`` included).
``set_default_dtype`` records the name ``get_default_dtype`` returns, as
there; creation ops take their dtype from their own defaults, as there.
``create_parameter`` builds on ``nn.initializer`` and
``ParamAttr._to_attr``, as the JAX package's does: ``attr``'s
initializer when it has one, else ``default_initializer``, else zeros
for a bias and ``XavierNormal`` for a weight (fans of ``[in, out]``, or
``[out, in, k...]`` times the receptive field), drawn from the global
generator on the default device.
"""
from __future__ import annotations

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
    """A standalone Parameter (module docstring). An initializer is an
    ``nn.initializer`` object or any callable ``(shape, dtype) ->
    tensor``."""
    from ..device import default_device
    from ..nn.initializer import Constant, XavierNormal
    from ..nn.param_attr import ParamAttr
    from ..tensor import Parameter

    init = default_initializer
    a = ParamAttr._to_attr(attr)
    if a and getattr(a, "initializer", None) is not None:
        init = a.initializer
    if init is None:
        init = Constant(0.0) if is_bias else XavierNormal()
    value = init(tuple(int(s) for s in shape), dtypes.convert_dtype(dtype))
    trainable = not a or a.trainable
    return Parameter(torch.as_tensor(value).to(default_device()),
                     trainable=trainable,
                     name=name or (a.name if a else None))
