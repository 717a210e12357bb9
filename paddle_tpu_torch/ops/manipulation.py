"""Shape and layout manipulation ops (``paddle_tpu/ops/manipulation.py``).

Index semantics follow the JAX ops, and no index out of range ever
reaches a torch kernel (on CUDA that is a device-side assert, which
poisons the context):

- ``gather``, ``index_select`` and ``take_along_axis``/``index_sample``
  (``jnp.take``'s mode ``fill``): an index in ``[-n, n)`` wraps, any
  other gives the fill value (NaN for floats, the least value of a
  signed integer type, the largest of an unsigned one, True for bool).
- ``gather_nd`` and integer-array indexing (``x[idx]``): an index is
  wrapped once if negative, then clamped into range.
- ``scatter``, ``scatter_nd_add``, ``put_along_axis``, ``index_put``
  (``.at[]``, mode ``drop``): an out-of-range update is dropped.

``sort``/``argsort``/``topk``/``kthvalue`` sort stably, as ``jnp.sort``
does: ``topk`` gives the lower index first among ties (as
``lax.top_k``); a descending ``argsort`` is the ascending one reversed.
``unique`` and ``unique_consecutive`` run on the host with numpy, as the
JAX package's do.
"""
from __future__ import annotations

import builtins
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as TF

from .. import dtypes
from ..autograd.engine import apply_op
from ..tensor import Tensor
from ._apply import as_value, ensure_tensor, unary

__all__ = [
    "reshape", "transpose", "concat", "split", "chunk", "stack", "unstack",
    "squeeze", "unsqueeze", "expand", "broadcast_to", "expand_as", "tile",
    "flatten", "flip", "rot90", "roll", "gather", "gather_nd", "take_along_axis",
    "put_along_axis", "index_select", "index_sample", "masked_select", "where",
    "scatter", "scatter_nd_add", "slice", "strided_slice", "cast", "pad",
    "topk", "sort", "argsort", "unique", "unique_consecutive", "searchsorted",
    "nonzero", "repeat_interleave", "unbind", "numel", "shard_index",
    "moveaxis", "swapaxes", "as_real", "as_complex", "view", "view_as",
    "crop", "tensordot", "bucketize", "masked_fill", "index_put", "diagonal",
]

_wrap = Tensor._wrap


# ------------------------------------------------------------ index modes
def fill_value(dtype: torch.dtype):
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def wrap_negative(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(idx < 0, idx + n, idx)


def clip_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Wrapped once if negative, then clamped into ``[0, n)``."""
    return wrap_negative(idx.long(), n).clamp(0, builtins.max(n - 1, 0))


def checked_index(idx: torch.Tensor, n: int):
    """``(safe index, in range)``: an index in ``[-n, n)`` wrapped, any
    other replaced by 0 and marked."""
    idx = wrap_negative(idx.long(), n)
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, idx, 0), ok


def take_fill(a: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.take(a, idx, axis)`` in mode ``fill``."""
    axis %= a.dim()
    safe, ok = checked_index(idx, a.shape[axis])
    out = torch.index_select(a, axis, safe.reshape(-1))
    out = out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])
    ok = ok.reshape((1,) * axis + idx.shape + (1,) * (a.dim() - axis - 1))
    return torch.where(ok, out, torch.full((), fill_value(a.dtype),
                                           dtype=a.dtype, device=a.device))


def take_along_fill(a, idx, axis):
    """``jnp.take_along_axis`` in mode ``fill``."""
    axis %= a.dim()
    safe, ok = checked_index(idx, a.shape[axis])
    out = torch.take_along_dim(a, safe, axis)
    return torch.where(ok, out, torch.full((), fill_value(a.dtype),
                                           dtype=a.dtype, device=a.device))


def _drop_pad(a, axis):
    """``a`` with one spare slot at the end of ``axis``: dropped updates
    land there and are sliced off."""
    shape = list(a.shape)
    shape[axis] = 1
    return torch.cat([a, a.new_zeros(shape)], axis)


# ------------------------------------------------------------- reshaping
def reshape(x, shape, name=None):
    if isinstance(shape, Tensor):
        shape = tuple(int(s) for s in shape.numpy().reshape(-1))
    else:
        shape = tuple(int(s._value) if isinstance(s, Tensor) else int(s)
                      for s in shape)
    return unary(lambda a: torch.reshape(a, shape), x, name="reshape")


view = reshape


def view_as(x, other, name=None):
    return reshape(x, ensure_tensor(other).shape)


def transpose(x, perm, name=None):
    perm = tuple(int(p) for p in perm)
    return unary(lambda a: a.permute(perm), x, name="transpose")


def moveaxis(x, source, destination, name=None):
    return unary(lambda a: torch.movedim(a, source, destination), x,
                 name="moveaxis")


def swapaxes(x, axis0, axis1, name=None):
    return unary(lambda a: torch.swapaxes(a, axis0, axis1), x,
                 name="swapaxes")


def _tensors(xs):
    xs = list(xs)
    ref = next((t for t in xs if isinstance(t, Tensor)), None)
    return [ensure_tensor(t, ref) for t in xs]


def concat(x: Sequence, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply_op(lambda *vs: torch.cat(vs, axis), _tensors(x),
                    name="concat")


def stack(x: Sequence, axis=0, name=None):
    return apply_op(lambda *vs: torch.stack(vs, axis), _tensors(x),
                    name="stack")


def unstack(x, axis=0, num=None, name=None):
    return list(apply_op(lambda a: torch.unbind(a, axis), [ensure_tensor(x)],
                         name="unstack"))


def unbind(input, axis=0):
    return unstack(input, axis=axis)


def split(x, num_or_sections, axis=0, name=None):
    x = ensure_tensor(x)
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"paddle.split: axis {axis} size {dim} is not divisible by num "
                f"{num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in num_or_sections]
        if builtins.any(s < 0 for s in sizes):
            rest = dim - builtins.sum(s for s in sizes if s >= 0)
            sizes = [rest if s < 0 else s for s in sizes]
    return list(apply_op(lambda a: torch.split(a, sizes, axis), [x],
                         name="split"))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def squeeze(x, axis=None, name=None):
    x = ensure_tensor(x)
    if axis is None:
        return unary(torch.squeeze, x, name="squeeze")
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    ax = tuple(int(a) for a in axes if x.shape[int(a)] == 1)
    return unary(lambda a: torch.squeeze(a, ax) if ax else a, x,
                 name="squeeze")


def unsqueeze(x, axis, name=None):
    if isinstance(axis, Tensor):
        axis = [int(a) for a in axis.numpy().reshape(-1)]
    axes = list(axis) if isinstance(axis, (list, tuple)) else [int(axis)]

    def fn(a):
        nd = a.dim() + len(axes)
        for ax in sorted(int(v) % nd for v in axes):
            a = a.unsqueeze(ax)
        return a

    return unary(fn, x, name="unsqueeze")


def expand(x, shape, name=None):
    x = ensure_tensor(x)
    if isinstance(shape, Tensor):
        shape = [int(s) for s in shape.numpy().reshape(-1)]
    shape = [int(s._value) if isinstance(s, Tensor) else int(s) for s in shape]
    nd_in, nd_out = x.ndim, len(shape)
    full_shape = []
    for i, s in enumerate(shape):
        in_dim = x.shape[i - (nd_out - nd_in)] if i >= nd_out - nd_in else None
        full_shape.append(in_dim if s == -1 else s)
    return unary(lambda a: torch.broadcast_to(a, full_shape), x,
                 name="expand")


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return expand(x, ensure_tensor(y).shape)


def tile(x, repeat_times, name=None):
    if isinstance(repeat_times, Tensor):
        repeat_times = [int(r) for r in repeat_times.numpy().reshape(-1)]
    reps = tuple(int(r.item()) if isinstance(r, Tensor) else int(r)
                 for r in repeat_times)
    return unary(lambda a: torch.tile(a, reps), x, name="tile")


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = ensure_tensor(x)
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    new_shape = x.shape[:s] + [-1] + x.shape[e + 1:]
    return unary(lambda a: torch.reshape(a, new_shape), x, name="flatten")


def flip(x, axis, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)
    return unary(lambda a: torch.flip(a, ax), x, name="flip")


def rot90(x, k=1, axes=(0, 1), name=None):
    return unary(lambda a: torch.rot90(a, k, list(axes)), x, name="rot90")


def roll(x, shifts, axis=None, name=None):
    return unary(lambda a: torch.roll(a, shifts, axis), x, name="roll")


# ---------------------------------------------------------- gather/scatter
def gather(x, index, axis=0, name=None):
    """Rows of ``axis`` by index (``jnp.take``, mode ``fill``)."""
    x = ensure_tensor(x)
    idx = as_value(index, x)
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    idx = idx.reshape(-1) if idx.dim() > 1 else idx
    return unary(lambda a: take_fill(a, idx, axis), x, name="gather")


def gather_nd(x, index, name=None):
    x = ensure_tensor(x)
    idx = as_value(index, x)

    def fn(a):
        return a[tuple(clip_index(idx[..., i], a.shape[i])
                       for i in range(idx.shape[-1]))]

    return unary(fn, x, name="gather_nd")


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr = ensure_tensor(arr)
    idx = as_value(indices, arr)
    return unary(lambda a: take_along_fill(a, idx, axis), arr,
                 name="take_along_axis")


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    arr = ensure_tensor(arr)
    idx = as_value(indices, arr)
    vt = ensure_tensor(values, arr)
    if reduce not in ("assign", "add", "mul", "multiply"):
        raise ValueError(f"unsupported reduce: {reduce}")

    def fn(a, v):
        ax = axis % a.dim()
        n = a.shape[ax]
        safe, ok = checked_index(idx, n)
        safe = torch.where(ok, safe, n)  # dropped: the spare slot
        v = torch.broadcast_to(v, idx.shape).to(a.dtype)
        padded = _drop_pad(a, ax)
        if reduce == "assign":
            out = padded.scatter(ax, safe, v)
        elif reduce == "add":
            out = padded.scatter_add(ax, safe, v)
        else:
            out = padded.scatter_reduce(ax, safe, v, "prod")
        return torch.narrow(out, ax, 0, n)

    return apply_op(fn, [arr, vt], name="put_along_axis")


def index_select(x, index, axis=0, name=None):
    x = ensure_tensor(x)
    idx = as_value(index, x).reshape(-1)
    return unary(lambda a: take_fill(a, idx, axis), x, name="index_select")


def index_sample(x, index):
    x = ensure_tensor(x)
    idx = as_value(index, x)
    return unary(lambda a: take_along_fill(a, idx, 1), x, name="index_sample")


def masked_select(x, mask, name=None):
    x = ensure_tensor(x)
    m = as_value(mask, x).to(torch.bool)
    return unary(lambda a: torch.masked_select(a, m), x, name="masked_select")


def masked_fill(x, mask, value, name=None):
    x = ensure_tensor(x)
    m = as_value(mask, x).to(torch.bool)
    v = value.item() if isinstance(value, Tensor) and value.size == 1 \
        else value
    if isinstance(v, Tensor):
        return apply_op(lambda a, val: torch.where(m, val.to(a.dtype), a),
                        [x, v], name="masked_fill")
    return unary(lambda a: torch.where(
        m, torch.full((), v, dtype=a.dtype, device=a.device), a), x,
        name="masked_fill")


def where(condition, x=None, y=None, name=None):
    cond = as_value(condition)
    if x is None and y is None:
        return nonzero(_wrap(cond), as_tuple=True)
    ref = x if isinstance(x, Tensor) else y if isinstance(y, Tensor) else None
    xt = x if isinstance(x, Tensor) else _on(x, ref)
    yt = y if isinstance(y, Tensor) else _on(y, ref)
    dt = torch.promote_types(xt._value.dtype, yt._value.dtype)
    return apply_op(lambda a, b: torch.where(cond.to(a.device), a.to(dt),
                                             b.to(dt)), [xt, yt],
                    name="where")


def _on(v, ref):
    """A non-tensor operand as a tensor of its own numpy dtype, on
    ``ref``'s device."""
    t = ensure_tensor(v)
    if ref is not None and t._value.device != ref._value.device:
        t = _wrap(t._value.to(ref._value.device))
    return t


def nonzero(x, as_tuple=False):
    a = ensure_tensor(x)._value
    nz = torch.nonzero(a)
    if as_tuple:
        return tuple(_wrap(nz[:, i:i + 1]) for i in range(a.dim()))
    return _wrap(nz)


def scatter(x, index, updates, overwrite=True, name=None):
    """Write ``updates`` rows at ``index`` along axis 0 (``overwrite``),
    or sum them into zeroed rows."""
    x = ensure_tensor(x)
    idx = as_value(index, x).reshape(-1)
    upd = ensure_tensor(updates, x)

    def fn(a, u):
        n = a.shape[0]
        safe, ok = checked_index(idx, n)
        safe = torch.where(ok, safe, n)
        padded = _drop_pad(a, 0)
        u = u.to(a.dtype)
        if overwrite:
            out = padded.index_put((safe,), u)
        else:
            out = padded.index_put((safe,), torch.zeros_like(u)).index_put(
                (safe,), u, accumulate=True)
        return out[:n]

    return apply_op(fn, [x, upd], name="scatter")


def _nd_index(idx, shape):
    """``idx[..., k]`` indexing the first k dims of ``shape``: the safe
    index tuple and where every component is in range."""
    ok = torch.ones(idx.shape[:-1], dtype=torch.bool, device=idx.device)
    parts = []
    for i in range(idx.shape[-1]):
        safe, good = checked_index(idx[..., i], shape[i])
        parts.append(safe)
        ok = ok & good
    return tuple(parts), ok


def scatter_nd_add(x, index, updates, name=None):
    x = ensure_tensor(x)
    idx = as_value(index, x)
    upd = ensure_tensor(updates, x)

    def fn(a, u):
        parts, ok = _nd_index(idx, a.shape)
        u = u.to(a.dtype)
        ok = ok.reshape(ok.shape + (1,) * (u.dim() - ok.dim()))
        return a.index_put(parts, torch.where(ok, u, torch.zeros_like(u)),
                           accumulate=True)

    return apply_op(fn, [x, upd], name="scatter_nd_add")


def index_put(x, indices, value, accumulate=False, name=None):
    """``x`` with ``value`` written (or, ``accumulate``, added) at the
    integer index tensors ``indices`` (``.at[indices]``); an out-of-range
    entry is dropped: its axis-0 index goes to a spare row."""
    x = ensure_tensor(x)
    idx = [as_value(i, x) for i in indices]
    v = ensure_tensor(value, x)

    def fn(a, val):
        checked = [checked_index(i, a.shape[d]) for d, i in enumerate(idx)]
        ok = checked[0][1]
        for _, good in checked[1:]:
            ok = ok & good
        n = a.shape[0]
        parts = (torch.where(ok, checked[0][0], n),) + tuple(
            safe for safe, _ in checked[1:])
        out = _drop_pad(a, 0).index_put(parts, val.to(a.dtype),
                                        accumulate=accumulate)
        return out[:n]

    return apply_op(fn, [x, v], name="index_put")


def slice(input, axes, starts, ends, name=None):
    x = ensure_tensor(input)

    def _v(v):
        return int(v.item()) if isinstance(v, Tensor) else int(v)

    def fn(a):
        sl = [builtins.slice(None)] * a.dim()
        for ax, s, e in zip(axes, starts, ends):
            sl[ax] = builtins.slice(_v(s), builtins.min(_v(e), a.shape[ax]))
        return a[tuple(sl)]

    return unary(fn, x, name="slice")


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = ensure_tensor(x)

    def fn(a):
        sl = [builtins.slice(None)] * a.dim()
        for ax, s, e, st in zip(axes, starts, ends, strides):
            if int(st) < 0:  # torch slices take no negative step
                a = torch.flip(a, (ax,))
                n = a.shape[ax]
                sl[ax] = builtins.slice(n - 1 - int(s), n - 1 - int(e),
                                        -int(st))
            else:
                sl[ax] = builtins.slice(int(s), int(e), int(st))
        return a[tuple(sl)]

    return unary(fn, x, name="strided_slice")


def crop(x, shape=None, offsets=None, name=None):
    x = ensure_tensor(x)
    offs = [0] * x.ndim if offsets is None else [int(o) for o in offsets]
    shp = [int(s) if int(s) != -1 else x.shape[i] - offs[i]
           for i, s in enumerate(shape)]

    def fn(a):
        for d, (o, n) in enumerate(zip(offs, shp)):
            o = builtins.min(builtins.max(o, 0), a.shape[d] - n)  # as lax
            a = torch.narrow(a, d, o, n)
        return a

    return unary(fn, x, name="crop")


def cast(x, dtype):
    """``phi`` CastKernel: float to float casts carry the gradient; any
    other cast does not."""
    x = ensure_tensor(x)
    dt = dtypes.convert_dtype(dtype)
    diff = dt.is_floating_point and x._value.is_floating_point()
    return unary(lambda a: a.to(dt), x, differentiable=diff, name="cast")


def _pad_index(n: int, lo: int, hi: int, mode: str, device):
    """The source index of every output position along one padded axis
    (``reflect``: numpy's, edge not repeated; ``edge``; ``wrap``)."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return pos.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(pos, n)
    period = 2 * (n - 1)
    if period == 0:
        return torch.zeros_like(pos)
    r = torch.remainder(pos, period)
    return torch.where(r < n, r, period - r)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    x = ensure_tensor(x)
    if isinstance(pad, Tensor):
        pad = [int(p) for p in pad.numpy().reshape(-1)]
    pad = [int(p) for p in pad]
    nd = x.ndim
    if len(pad) == 2 * nd:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # paddle's NC* convention: the pairs pad the spatial dims in order
        n_spatial = len(pad) // 2
        pairs = [(0, 0)] * nd
        first = 2 if data_format.startswith("NC") else 1
        for i in range(n_spatial):
            pairs[first + i] = (pad[2 * i], pad[2 * i + 1])
    jmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]

    def fn(a):
        if jmode == "constant":
            flat = [p for lo_hi in reversed(pairs) for p in lo_hi]
            return TF.pad(a, flat, value=value)
        for d, (lo, hi) in enumerate(pairs):
            if lo or hi:
                a = torch.index_select(
                    a, d, _pad_index(a.shape[d], lo, hi, jmode, a.device))
        return a

    return unary(fn, x, name="pad")


# ------------------------------------------------------------- sort family
def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    x = ensure_tensor(x)
    if isinstance(k, Tensor):
        k = int(k.item())
    ax = -1 if axis is None else int(axis)

    def fn(a):
        vals, idx = torch.sort(a, dim=ax, descending=largest, stable=True)
        return (torch.narrow(vals, ax, 0, k),
                torch.narrow(idx, ax, 0, k).to(torch.int64))

    vals, idx = apply_op(fn, [x], name="topk")
    return vals, idx


def sort(x, axis=-1, descending=False, name=None):
    return unary(lambda a: torch.sort(a, dim=axis, descending=descending,
                                      stable=True).values, x, name="sort")


def argsort(x, axis=-1, descending=False, name=None):
    def fn(a):
        idx = torch.argsort(a, dim=axis, stable=True)
        return torch.flip(idx, (axis,)) if descending else idx

    return unary(fn, x, differentiable=False, name="argsort")


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    v = ensure_tensor(values)
    seq = as_value(sorted_sequence, v)

    def fn(a):
        dt = torch.promote_types(seq.dtype, a.dtype)
        return torch.searchsorted(seq.to(dt), a.to(dt), right=right,
                                  out_int32=out_int32)

    return unary(fn, v, differentiable=False, name="searchsorted")


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def _from_host(arr: np.ndarray, like: torch.Tensor) -> Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)
    return _wrap(t)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Sorted unique values (and first indices, inverse, counts), on the
    host with ``np.unique``."""
    v = ensure_tensor(x)._value
    res = np.unique(_wrap(v).numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _wrap(_from_host(res, v)._value.to(v.dtype))
    np_dt = dtypes.to_numpy_dtype(dtype)
    outs = [_wrap(_from_host(res[0], v)._value.to(v.dtype))]
    outs += [_from_host(r.astype(np_dt), v) for r in res[1:]]
    return tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    v = ensure_tensor(x)._value
    arr = _wrap(v).numpy()
    if axis is not None:
        raise NotImplementedError(
            "unique_consecutive with axis is not supported yet")
    arr = arr.reshape(-1)
    change = np.concatenate([[True], arr[1:] != arr[:-1]])
    rets = [_wrap(_from_host(arr[change], v)._value.to(v.dtype))]
    if return_inverse:
        rets.append(_from_host((np.cumsum(change) - 1).astype(np.int64), v))
    if return_counts:
        starts = np.nonzero(change)[0]
        counts = np.diff(np.concatenate([starts, [arr.size]]))
        rets.append(_from_host(counts.astype(np.int64), v))
    return rets[0] if len(rets) == 1 else tuple(rets)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = ensure_tensor(x)
    if isinstance(repeats, Tensor):
        repeats = repeats._value
    return unary(lambda a: torch.repeat_interleave(a, repeats, axis), x,
                 name="repeat_interleave")


def numel(x, name=None):
    v = ensure_tensor(x)._value
    return _wrap(torch.tensor(v.numel(), dtype=torch.int64, device=v.device))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    x = ensure_tensor(input)
    shard_size = (index_num + nshards - 1) // nshards

    def fn(a):
        in_shard = torch.div(a, shard_size, rounding_mode="floor") == shard_id
        return torch.where(in_shard, torch.remainder(a, shard_size),
                           torch.full((), ignore_value, dtype=a.dtype,
                                      device=a.device))

    return unary(fn, x, differentiable=False, name="shard_index")


def as_complex(x, name=None):
    return unary(lambda a: torch.complex(a[..., 0], a[..., 1]), x,
                 name="as_complex")


def as_real(x, name=None):
    return unary(lambda a: torch.stack([a.real, a.imag], -1), x,
                 name="as_real")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return unary(lambda a: torch.diagonal(a, offset, axis1, axis2), x,
                 name="diagonal")


def tensordot(x, y, axes=2, name=None):
    xt = ensure_tensor(x)
    yt = ensure_tensor(y, xt)
    return apply_op(lambda a, b: torch.tensordot(a, b, dims=axes), [xt, yt],
                    name="tensordot")
