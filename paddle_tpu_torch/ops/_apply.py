"""Op-application helpers (``paddle_tpu/ops/_apply.py``).

Every op is one plain torch function of its inputs' values, run through
:func:`..autograd.engine.apply_op`. What stays here is the glue, with
the JAX package's type rules (it runs with ``jax_enable_x64``):

- :func:`ensure_tensor` makes a Tensor of an array, list or scalar; a
  float64 or int64 one that meets a floating tensor takes that tensor's
  dtype.
- :func:`binary` keeps Python scalars as scalars, typed as JAX's weak
  scalars: they take the tensor's dtype, except a Python float against an
  integer or bool tensor, which gives float64 (torch would give f32). Two
  tensors of different dtypes meet at ``torch.promote_types``, whatever
  their ranks (torch alone lets a 0-d tensor's dtype lose to the other's
  within a kind; JAX does not), after the amp cast of the op's inputs (a
  bf16 and an f64 tensor meet as bf16 under O2, as in JAX). A numpy
  scalar is a 0-d tensor of its own dtype.
- :func:`inexact` is JAX's cast of an integer input to an op that gives
  floats: int64 to float64, other integers and bool to float32.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..autograd.engine import apply_op
from ..tensor import Tensor, _as_torch

__all__ = ["ensure_tensor", "unary", "binary", "inexact", "as_value"]


def inexact(a: torch.Tensor) -> torch.Tensor:
    if a.is_floating_point() or a.is_complex():
        return a
    return a.to(torch.float64 if a.dtype in (torch.int64, torch.uint64)
                else torch.float32)


def _device_of(ref):
    return ref._value.device if isinstance(ref, Tensor) else None


def ensure_tensor(x, ref: Tensor = None) -> Tensor:
    """``x`` as a Tensor, on ``ref``'s device when given (module
    docstring)."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    arr = np.asarray(x)
    dtype = None
    if (ref is not None and arr.dtype in (np.float64, np.int64)
            and (ref._value.is_floating_point() or ref._value.is_complex())):
        dtype = ref._value.dtype
    return Tensor._wrap(_as_torch(arr, dtype, _device_of(ref)))


def as_value(x, ref: Tensor = None) -> torch.Tensor:
    """The torch value of ``x`` (``ensure_tensor``'s rule), for index
    arguments captured outside the tape."""
    return ensure_tensor(x, ref)._value


def unary(fn, x, attrs=None, differentiable=True, name=""):
    x = ensure_tensor(x)
    return apply_op(fn, [x], attrs, differentiable=differentiable,
                    name=name or fn.__name__)


def _weak(a: torch.Tensor, s) -> torch.Tensor:
    """``a`` as it meets the weak Python scalar ``s`` in JAX."""
    if (isinstance(s, (float, complex)) and not isinstance(s, bool)
            and not (a.is_floating_point() or a.is_complex())):
        return a.to(torch.float64)
    return a


def _is_weak(v) -> bool:
    return isinstance(v, numbers.Number) and not isinstance(v, np.generic)


def _strong(s, ref) -> Tensor:
    """A numpy scalar as a 0-d tensor of its own dtype (JAX types it
    strongly), on ``ref``'s device."""
    return Tensor._wrap(_as_torch(np.asarray(s), None, _device_of(ref)))


def binary(fn, x, y, attrs=None, differentiable=True, name=""):
    """A binary op (module docstring for the typing)."""
    name = name or fn.__name__
    kw = attrs or {}
    if isinstance(x, Tensor) and _is_weak(y):
        return apply_op(lambda a: fn(_weak(a, y), y, **kw), [x], None,
                        differentiable=differentiable, name=name)
    if isinstance(y, Tensor) and _is_weak(x):
        return apply_op(lambda b: fn(x, _weak(b, x), **kw), [y], None,
                        differentiable=differentiable, name=name)
    xt = _strong(x, y) if isinstance(x, np.generic) else \
        ensure_tensor(x, ref=y if isinstance(y, Tensor) else None)
    yt = _strong(y, xt) if isinstance(y, np.generic) else \
        ensure_tensor(y, ref=xt)
    if xt._value.dtype != yt._value.dtype:
        # promoted after the amp cast, as the JAX op promotes what it is
        # given: under auto_cast both may already share a dtype
        def promoted(a, b):
            dt = torch.promote_types(a.dtype, b.dtype)
            return fn(a.to(dt), b.to(dt), **kw)

        return apply_op(promoted, [xt, yt], None,
                        differentiable=differentiable, name=name)
    return apply_op(fn, [xt, yt], attrs, differentiable=differentiable,
                    name=name)
