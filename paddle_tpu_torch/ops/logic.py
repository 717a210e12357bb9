"""Comparison, logical and predicate ops (``paddle_tpu/ops/logic.py``).
None is differentiable; comparisons give bool tensors."""
from __future__ import annotations

import torch

from ..tensor import Tensor
from ._apply import as_value, binary, ensure_tensor, unary

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "isnan", "isinf", "isfinite", "is_empty", "isin",
]


def _cmp(fn, name):
    def op(x, y, name_=None):
        return binary(fn, x, y, differentiable=False, name=name)

    op.__name__ = name
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater_equal = _cmp(torch.ge, "greater_equal")
less_than = _cmp(torch.lt, "less_than")
less_equal = _cmp(torch.le, "less_equal")
logical_and = _cmp(torch.logical_and, "logical_and")
logical_or = _cmp(torch.logical_or, "logical_or")
logical_xor = _cmp(torch.logical_xor, "logical_xor")
bitwise_and = _cmp(torch.bitwise_and, "bitwise_and")
bitwise_or = _cmp(torch.bitwise_or, "bitwise_or")
bitwise_xor = _cmp(torch.bitwise_xor, "bitwise_xor")


def _array_equal(a, b):
    if a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return (a == b).all()


def equal_all(x, y, name=None):
    return binary(_array_equal, x, y, differentiable=False, name="equal_all")


def logical_not(x, name=None):
    return unary(torch.logical_not, x, differentiable=False,
                 name="logical_not")


def bitwise_not(x, name=None):
    return unary(torch.bitwise_not, x, differentiable=False,
                 name="bitwise_not")


def isnan(x, name=None):
    return unary(torch.isnan, x, differentiable=False, name="isnan")


def isinf(x, name=None):
    return unary(torch.isinf, x, differentiable=False, name="isinf")


def isfinite(x, name=None):
    return unary(torch.isfinite, x, differentiable=False, name="isfinite")


def is_empty(x, name=None):
    v = ensure_tensor(x)._value
    return Tensor._wrap(torch.tensor(v.numel() == 0, device=v.device))


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    x = ensure_tensor(x)
    t = as_value(test_x, x)

    def fn(a):
        dt = torch.promote_types(a.dtype, t.dtype)
        return torch.isin(a.to(dt), t.to(dt), assume_unique=assume_unique,
                          invert=invert)

    return unary(fn, x, differentiable=False, name="isin")
