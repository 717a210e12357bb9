"""Creation ops (``paddle_tpu/ops/creation.py``). Ops that take no tensor
make their result on the default device (``device.set_device``, else the
card: ``RuntimeError`` without one); ``*_like`` ops on their input's."""
from __future__ import annotations

import torch

from .. import dtypes
from ..autograd.engine import apply_op, inplace_rebind
from ..device import default_device
from ..tensor import Tensor, to_tensor
from ._apply import binary, ensure_tensor, unary

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "diag", "diagflat", "tril", "triu", "meshgrid", "assign", "clone",
    "tril_indices", "triu_indices", "complex",
]

_wrap = Tensor._wrap


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy().reshape(-1))
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, Tensor) else v


def zeros(shape, dtype="float32", name=None):
    return _wrap(torch.zeros(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                             device=default_device()))


def ones(shape, dtype="float32", name=None):
    return _wrap(torch.ones(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                            device=default_device()))


def full(shape, fill_value, dtype="float32", name=None):
    return _wrap(torch.full(_shape(shape), _scalar(fill_value),
                            dtype=dtypes.convert_dtype(dtype),
                            device=default_device()))


def empty(shape, dtype="float32", name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return _wrap(torch.zeros_like(ensure_tensor(x)._value,
                                  dtype=dtypes.convert_dtype(dtype)))


def ones_like(x, dtype=None, name=None):
    return _wrap(torch.ones_like(ensure_tensor(x)._value,
                                 dtype=dtypes.convert_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return _wrap(torch.full_like(ensure_tensor(x)._value, _scalar(fill_value),
                                 dtype=dtypes.convert_dtype(dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = "int64" if all(isinstance(v, int) for v in (start, end, step)) \
            else "float32"
    return _wrap(torch.arange(start, end, step,
                              dtype=dtypes.convert_dtype(dtype),
                              device=default_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return _wrap(torch.linspace(
        _scalar(start), _scalar(stop), int(_scalar(num)),
        dtype=dtypes.convert_dtype(dtype or "float32"),
        device=default_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _wrap(torch.logspace(
        _scalar(start), _scalar(stop), int(_scalar(num)), base=_scalar(base),
        dtype=dtypes.convert_dtype(dtype or "float32"),
        device=default_device()))


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    m = num_rows if num_columns is None else num_columns
    return _wrap(torch.eye(num_rows, m, dtype=dtypes.convert_dtype(dtype),
                           device=default_device()))


def diag(x, offset=0, padding_value=0, name=None):
    def fn(a):
        out = torch.diag(a, offset)
        if a.dim() == 1 and padding_value != 0:
            on = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
            out = torch.where(on, out, torch.full_like(out, padding_value))
        return out

    return unary(fn, x, name="diag")


def diagflat(x, offset=0, name=None):
    return unary(lambda a: torch.diagflat(a, offset), x, name="diagflat")


def tril(x, diagonal=0, name=None):
    return unary(lambda a: torch.tril(a, diagonal), x, name="tril")


def triu(x, diagonal=0, name=None):
    return unary(lambda a: torch.triu(a, diagonal), x, name="triu")


def tril_indices(row, col, offset=0, dtype="int64", name=None):
    return _wrap(torch.tril_indices(row, col, offset,
                                    dtype=dtypes.convert_dtype(dtype),
                                    device=default_device()))


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    return _wrap(torch.triu_indices(row, row if col is None else col, offset,
                                    dtype=dtypes.convert_dtype(dtype),
                                    device=default_device()))


def meshgrid(*args, name=None):
    seq = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    ts = [ensure_tensor(a) for a in seq]
    return apply_op(lambda *vs: torch.meshgrid(*vs, indexing="ij"), ts,
                    name="meshgrid")


def assign(x, output=None):
    """``paddle.assign``: a copy of ``x`` (on the tape); with ``output``,
    written into it as an in-place op writes."""
    out = unary(torch.clone, x, name="assign")
    if output is not None:
        return inplace_rebind(output, out)
    return out


def clone(x, name=None):
    return assign(x)


def complex(real, imag, name=None):
    return binary(torch.complex, real, imag, name="complex")
