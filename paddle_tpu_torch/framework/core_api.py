"""Dtype meta, predicates, the places, ``create_parameter`` and the small
names (``paddle_tpu/framework/core_api.py``).

``iinfo`` and ``finfo`` are torch's (``finfo(bfloat16)`` included).
``set_default_dtype`` records the name ``get_default_dtype`` returns, as
there; creation ops take their dtype from their own defaults, as there.
``create_parameter`` builds on ``nn.initializer`` and
``ParamAttr._to_attr``, as the JAX package's does: ``attr``'s
initializer when it has one, else ``default_initializer``, else zeros
for a bias and ``XavierNormal`` for a weight (fans of ``[in, out]``, or
``[out, in, k...]`` times the receptive field), drawn from the global
generator on the default device.

The places keep the JAX package's class tree (``CUDAPlace(TPUPlace)``,
``CUDAPinnedPlace(CPUPlace)``); in the port ``TPUPlace``/``CUDAPlace``
name the card (``str(CUDAPlace(0)) == "gpu:0"``, which every entry point
takes as a device) and the host places the CPU. ``set_printoptions``
sets numpy's options, through which ``Tensor.__repr__`` prints, as
there; ``get_cuda_rng_state``/``set_cuda_rng_state`` are
:mod:`..generator`'s.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import dtypes

__all__ = ["dtype", "iinfo", "finfo", "get_default_dtype",
           "set_default_dtype", "is_tensor", "is_grad_enabled",
           "in_dynamic_mode", "create_parameter", "CPUPlace", "TPUPlace",
           "CUDAPlace", "CUDAPinnedPlace", "set_printoptions", "LazyGuard",
           "batch", "get_cuda_rng_state", "set_cuda_rng_state",
           "disable_signal_handler", "check_shape"]


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


# ---------------------------------------------------------------- places
class _Place:
    _kind = "unknown"

    def __init__(self, device_id: int = 0):
        self._id = int(device_id)

    def get_device_id(self) -> int:
        return self._id

    def __repr__(self):
        return f"Place({self._kind}:{self._id})"

    def __str__(self):
        """The device name entry points take: ``cpu`` or ``gpu:<id>``."""
        return "cpu" if self._kind == "cpu" else f"{self._kind}:{self._id}"

    def __eq__(self, other):
        return (type(self) is type(other)
                and self._id == getattr(other, "_id", None))

    def __hash__(self):
        return hash((type(self).__name__, self._id))


class CPUPlace(_Place):
    _kind = "cpu"

    def __init__(self):
        super().__init__(0)


class TPUPlace(_Place):
    """The accelerator: in the port, the card."""
    _kind = "gpu"


class CUDAPlace(TPUPlace):
    _kind = "gpu"


class CUDAPinnedPlace(CPUPlace):
    """Pinned host memory: a host place."""
    _kind = "cpu"


# ---------------------------------------------------------------- misc
def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Printing options of ``Tensor.__repr__``, which prints through numpy:
    numpy's options (``sci_mode`` is ``not suppress``)."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


class LazyGuard:
    """Marks a scope of deferred parameter initialisation; parameters
    are made at once, as in the JAX package."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """``paddle.batch``: a reader of lists of ``batch_size`` items (the
    last one shorter unless ``drop_last``)."""

    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def get_cuda_rng_state():
    from ..generator import get_cuda_rng_state as _get

    return _get()


def set_cuda_rng_state(state) -> None:
    from ..generator import set_cuda_rng_state as _set

    _set(state)


def disable_signal_handler() -> None:
    """Nothing to disable: the port installs no crash handlers."""


def check_shape(shape) -> None:
    """``paddle.check_shape``: a list or tuple of ints >= -1, None or
    Tensors, or a Tensor."""
    if isinstance(shape, (list, tuple)):
        for s in shape:
            if not isinstance(s, (int, np.integer)) and s is not None:
                from ..tensor import Tensor

                if not isinstance(s, Tensor):
                    raise TypeError(f"invalid dim {s!r} in shape")
            if isinstance(s, (int, np.integer)) and s < -1:
                raise ValueError(f"shape dims must be >= -1, got {s}")
    elif not is_tensor(shape):
        raise TypeError(f"shape must be list/tuple/Tensor, got {type(shape)}")
