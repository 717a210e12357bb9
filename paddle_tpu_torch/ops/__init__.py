"""The op library of the port (``paddle_tpu/ops``), and its kernels.

The ops of ``creation``, ``extras``, ``linalg``, ``logic``,
``manipulation``, ``math``, ``random`` and ``stat`` take and return
:class:`..tensor.Tensor`; each is plain torch on its inputs' values
through :func:`..autograd.engine.apply_op` (the JAX package computes
them outside any Pallas kernel too). Importing this package patches
them onto ``Tensor`` as methods, with the operator overloads and
``__getitem__``/``__setitem__`` (:func:`getitem`, :func:`setitem`).

The kernels (``csrc/``) are the modules ``ops.paged_attention`` (K4),
``ops.flash_attention`` (K1-K3) and ``ops.fused_adamw`` (K5), with their
launch counters, and ``ops.fused_loss``, the fused linear-cross-entropy;
import the functions from them.

Beware that the star imports below shadow the builtins ``sum``, ``max``,
``min``, ``all``, ``any``, ``abs``, ``round``, ``pow`` and ``slice`` in
this module; its own code calls them through ``builtins``.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..autograd.engine import apply_op, inplace_rebind, writes_in_place
from ..tensor import Tensor
from . import creation, extras, linalg, logic, manipulation, math, random, stat
from ._apply import unary
from .creation import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .manipulation import clip_index, wrap_negative
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403

__all__ = (
    creation.__all__ + extras.__all__ + linalg.__all__ + logic.__all__
    + manipulation.__all__ + math.__all__ + random.__all__ + stat.__all__
    + ["getitem", "setitem"]
)


# ---------------------------------------------------------------- indexing
def _check_int_bounds(shape, item):
    """An out-of-range Python int index raises ``IndexError``, as numpy
    does (``paddle_tpu/ops/__init__.py:46``); slices clamp, and any array
    index leaves the whole subscript to the array rule."""
    items = item if isinstance(item, tuple) else (item,)
    for i in items:
        if isinstance(i, (Tensor, torch.Tensor, np.ndarray, list)):
            return
    # None and scalar bools add an axis and consume none
    positional = [i for i in items
                  if i is not None and not isinstance(i, (bool, np.bool_))]
    ndim = len(shape)
    remaining = builtins.sum(1 for i in positional if i is not Ellipsis)
    axis = 0
    for i in positional:
        if i is Ellipsis:
            axis = ndim - remaining
            continue
        remaining -= 1
        if (isinstance(i, (int, np.integer)) and not isinstance(i, bool)
                and 0 <= axis < ndim):
            dim = shape[axis]
            if not -dim <= i < dim:
                raise IndexError(f"index {i} is out of bounds for axis "
                                 f"{axis} with size {dim}")
        axis += 1


def _consumes(i) -> int:
    if i is None or i is Ellipsis or isinstance(i, (bool, np.bool_)):
        return 0
    if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
        return i.dim()
    return 1


def _prep_index(v: torch.Tensor, item, for_write: bool = False):
    """``(index, axes)``: ``item`` as torch takes it on ``v``, Tensors,
    lists and arrays made tensors on ``v``'s device. An integer array
    index is wrapped once, then clamped into its axis (JAX's gather) or,
    to write, sent out of range to the row just past its axis, which
    :func:`_set` appends and drops (JAX's scatter drops it); ``axes``
    names the axes that need that row (empty to read)."""
    items = item if isinstance(item, tuple) else (item,)
    conv = []
    for i in items:
        if isinstance(i, Tensor):
            i = i._value
        elif isinstance(i, (list, np.ndarray)):
            i = torch.as_tensor(np.asarray(i))
        elif isinstance(i, np.bool_):
            i = bool(i)
        elif isinstance(i, np.integer):
            i = int(i)
        if isinstance(i, torch.Tensor) and i.device != v.device:
            i = i.to(v.device)
        conv.append(i)
    ndim = v.dim()
    remaining = builtins.sum(_consumes(i) for i in conv)
    axis, out, pad = 0, [], []
    for i in conv:
        used = _consumes(i)
        if i is Ellipsis:
            axis = ndim - remaining
        elif isinstance(i, torch.Tensor) and i.dtype != torch.bool \
                and axis < ndim:
            n = v.shape[axis]
            if for_write:
                i = wrap_negative(i.long(), n)
                i = torch.where((i >= 0) & (i < n), i, n)
                pad.append(axis)
            else:
                i = clip_index(i, n)
        remaining -= used
        axis += used
        out.append(i)
    return (tuple(out) if isinstance(item, tuple) else out[0]), pad


def getitem(x, item):
    _check_int_bounds(x.shape, item)
    idx, _ = _prep_index(x._value, item)
    return unary(lambda a: a[idx], x, name="getitem")


def _set(a, idx, v, pad):
    """``a`` with ``a[idx] = v``, out of place; each axis of ``pad`` gets
    one row appended for the dropped writes, and loses it after."""
    out = a
    for ax in pad:
        shape = list(out.shape)
        shape[ax] = 1
        out = torch.cat([out, out.new_zeros(shape)], ax)
    out = out.clone() if not pad else out
    out[idx] = v.to(a.dtype)
    for ax in pad:
        out = out.narrow(ax, 0, a.shape[ax])
    return out.contiguous()


def setitem(x, item, value):
    """Indexed write: out of place and rebound (autograd keeps the old
    value where a graph saved it), or in place where
    :func:`..autograd.engine.writes_in_place`. An integer array index out
    of range drops its write, as JAX's ``.at[].set`` does."""
    _check_int_bounds(x.shape, item)
    idx, pad = _prep_index(x._value, item, for_write=True)
    vt = value if isinstance(value, Tensor) else Tensor._wrap(
        torch.as_tensor(np.asarray(value), device=x._value.device))
    if writes_in_place(x._value) and not pad:
        x._value[idx] = vt._value.to(x._value.dtype)
        return x
    return inplace_rebind(x, apply_op(lambda a, v: _set(a, idx, v, pad),
                                      [x, vt], name="setitem"))


# ----------------------------------------------- Tensor method/op patching
def _patch_tensor():
    T = Tensor

    T.__add__ = lambda s, o: math.add(s, o)
    T.__radd__ = lambda s, o: math.add(o, s)
    T.__sub__ = lambda s, o: math.subtract(s, o)
    T.__rsub__ = lambda s, o: math.subtract(o, s)
    T.__mul__ = lambda s, o: math.multiply(s, o)
    T.__rmul__ = lambda s, o: math.multiply(o, s)
    T.__truediv__ = lambda s, o: math.divide(s, o)
    T.__rtruediv__ = lambda s, o: math.divide(o, s)
    T.__floordiv__ = lambda s, o: math.floor_divide(s, o)
    T.__mod__ = lambda s, o: math.remainder(s, o)
    T.__pow__ = lambda s, o: math.pow(s, o)
    T.__rpow__ = lambda s, o: math.pow(o, s)
    T.__matmul__ = lambda s, o: math.matmul(s, o)
    T.__rmatmul__ = lambda s, o: math.matmul(o, s)
    T.__neg__ = lambda s: math.neg(s)
    T.__abs__ = lambda s: math.abs(s)
    T.__invert__ = lambda s: logic.bitwise_not(s)
    T.__eq__ = lambda s, o: logic.equal(s, o)
    T.__ne__ = lambda s, o: logic.not_equal(s, o)
    T.__lt__ = lambda s, o: logic.less_than(s, o)
    T.__le__ = lambda s, o: logic.less_equal(s, o)
    T.__gt__ = lambda s, o: logic.greater_than(s, o)
    T.__ge__ = lambda s, o: logic.greater_equal(s, o)
    # Paddle maps &, |, ^ and ~ to the bitwise ops
    T.__and__ = lambda s, o: logic.bitwise_and(s, o)
    T.__or__ = lambda s, o: logic.bitwise_or(s, o)
    T.__xor__ = lambda s, o: logic.bitwise_xor(s, o)
    T.is_tensor = lambda s: True
    T.create_parameter = staticmethod(
        lambda *a, **k: __import__(
            "paddle_tpu_torch.framework.core_api",
            fromlist=["create_parameter"]).create_parameter(*a, **k))
    T.__getitem__ = getitem
    T.__setitem__ = setitem
    T.__hash__ = lambda s: id(s)

    # every op whose first argument is a tensor, as a method
    skip = {
        "to_tensor", "zeros", "ones", "full", "empty", "arange", "linspace",
        "logspace", "eye", "meshgrid", "tril_indices", "triu_indices",
        "uniform", "gaussian", "normal", "standard_normal", "randn", "rand",
        "randint", "randperm",
    }
    for mod in (creation, extras, linalg, logic, manipulation, math, random,
                stat):
        for name in mod.__all__:
            if name in skip or hasattr(T, name):
                continue
            fn = getattr(mod, name)
            if callable(fn):
                setattr(T, name, fn)

    # Paddle's Tensor method names
    T.dim = lambda s: s.ndim
    T.rank = lambda s: Tensor._wrap(torch.tensor(s.ndim))
    T.T = property(lambda s: manipulation.transpose(
        s, list(range(s.ndim))[::-1]))
    T.norm = linalg.norm
    T.topk = manipulation.topk
    T.cast = manipulation.cast
    T.astype = manipulation.cast
    T.concat = staticmethod(manipulation.concat)


_patch_tensor()
