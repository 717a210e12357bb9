"""Statistics ops (``paddle_tpu/ops/stat.py``). ``median`` of an even
count averages the two middle values (as ``jnp.median``; ``torch.median``
would take the lower), through ``torch.quantile``; ``kthvalue`` and
``mode`` break ties by a stable sort, as the JAX ops do: ``kthvalue``'s
index is the stable argsort's, ``mode`` takes the smallest of the most
frequent values and the first index where it occurs."""
from __future__ import annotations

import torch

from ..autograd.engine import apply_op
from ._apply import ensure_tensor, inexact, unary

__all__ = ["std", "var", "median", "nanmedian", "quantile", "nanquantile",
           "kthvalue", "mode"]


def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _var(a, ax, ddof, keepdim, fn):
    a = inexact(a)
    if ax is None and not keepdim:
        return fn(a, correction=ddof)
    return fn(a, dim=tuple(range(a.dim())) if ax is None else ax,
              correction=ddof, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return unary(lambda a: _var(a, ax, 1 if unbiased else 0, keepdim,
                                torch.var), x, name="var")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return unary(lambda a: _var(a, ax, 1 if unbiased else 0, keepdim,
                                torch.std), x, name="std")


def _quantile(a, q, ax, keepdim, method, fn):
    """``fn`` (``torch.quantile`` or ``nanquantile``) over the axes
    ``ax`` (None: all): several axes are moved last and merged."""
    a = inexact(a)
    if not isinstance(q, float):
        q = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    if ax is None:
        out = fn(a.reshape(-1), q, dim=0, interpolation=method)
        if keepdim:
            out = out.reshape(out.shape + (1,) * a.dim())
        return out
    axes = (ax,) if isinstance(ax, int) else ax
    axes = sorted(d % a.dim() for d in axes)
    rest = [d for d in range(a.dim()) if d not in axes]
    moved = a.permute(rest + axes).reshape(
        [a.shape[d] for d in rest] + [-1])
    out = fn(moved, q, dim=-1, interpolation=method)
    if keepdim:
        lead = out.shape[:out.dim() - len(rest)]
        full = list(lead) + [1 if d in axes else a.shape[d]
                             for d in range(a.dim())]
        out = out.reshape(full)
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = _norm_axis(axis)
    method = "linear" if mode == "avg" else "lower"
    return unary(lambda a: _quantile(a, 0.5, ax, keepdim, method,
                                     torch.quantile), x, name="median")


def nanmedian(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return unary(lambda a: _quantile(a, 0.5, ax, keepdim, "linear",
                                     torch.nanquantile), x, name="nanmedian")


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    ax = _norm_axis(axis)
    return unary(lambda a: _quantile(a, q, ax, keepdim, interpolation,
                                     torch.quantile), x, name="quantile")


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    ax = _norm_axis(axis)
    return unary(lambda a: _quantile(a, q, ax, keepdim, interpolation,
                                     torch.nanquantile), x,
                 name="nanquantile")


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def fn(a):
        s, i = torch.sort(a, dim=axis, stable=True)
        vals, idx = s.select(axis, k - 1), i.select(axis, k - 1)
        if keepdim:
            vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
        return vals, idx.to(torch.int64)

    out = apply_op(fn, [ensure_tensor(x)], name="kthvalue")
    return out[0], out[1]


def mode(x, axis=-1, keepdim=False, name=None):
    def fn(a):
        moved = torch.sort(a, dim=axis).values.movedim(axis, -1)
        counts = (moved[..., :, None] == moved[..., None, :]).sum(-1)
        best = torch.argmax(counts, dim=-1)
        vals = torch.take_along_dim(moved, best[..., None], -1)[..., 0]
        orig = a.movedim(axis, -1)
        idx = torch.argmax((orig == vals[..., None]).to(torch.uint8), dim=-1)
        if keepdim:
            vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
        return vals, idx.to(torch.int64)

    out = apply_op(fn, [ensure_tensor(x)], name="mode")
    return out[0], out[1]
