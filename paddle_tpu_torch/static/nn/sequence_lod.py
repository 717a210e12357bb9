"""Sequence (legacy LoD) ops (``paddle_tpu/static/nn/sequence_lod.py``).

The reference works on LoD (ragged) tensors whose row offsets live on the
host. The JAX package uses the padded-dense convention instead, and the
port keeps it (a CUDA graph, like an XLA program, wants static shapes): a
sequence batch is ``[B, T, ...]`` with time on axis 1, per-row
``length`` tensors where the reference read LoD offsets, and masks in
place of ragged storage. Each function names the reference op it covers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...ops._apply import apply_op, ensure_tensor
from ...nn.initializer import Constant, XavierNormal
from ...tensor import Tensor
from ..legacy import create_parameter

__all__ = [
    "sequence_conv", "sequence_softmax", "sequence_pool", "sequence_concat",
    "sequence_first_step", "sequence_last_step", "sequence_slice",
    "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_reshape", "sequence_scatter",
    "sequence_enumerate", "sequence_reverse",
]


def sequence_conv(input, num_filters: int, filter_size: int = 3,
                  filter_stride: int = 1, padding: bool = True,
                  padding_start: Optional[int] = None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    """reference: sequence_lod.py sequence_conv — context-window conv over
    time: im2col the window, then one product."""
    x = ensure_tensor(input)
    D = x.shape[-1]
    k = int(filter_size)
    start = -((k - 1) // 2) if padding_start is None else int(padding_start)
    w = create_parameter([k * D, num_filters], x.dtype, attr=param_attr,
                         default_initializer=XavierNormal())
    b = None if bias_attr is False else create_parameter(
        [num_filters], x.dtype, attr=bias_attr, is_bias=True,
        default_initializer=Constant(0.0))
    ins = [x, w] + ([b] if b is not None else [])

    def sc(v, wv, *rest):
        # window for output t is input rows {t+start, ..., t+start+k-1};
        # pad both ends so every tap indexes in-bounds, then slice with the
        # start offset folded in
        T = v.shape[1]
        lo, hi = max(0, -start), max(0, start + k - 1)
        vp = torch.nn.functional.pad(v, (0, 0, lo, hi))
        cols = torch.cat(
            [vp[:, lo + start + i:lo + start + i + T] for i in range(k)],
            dim=-1)  # [B, T, k*D]
        out = cols @ wv
        return out + rest[0] if rest else out

    out = apply_op(sc, ins, name="sequence_conv")
    if act is not None:
        from ...nn import functional as F
        out = getattr(F, act)(out)
    return out


def sequence_softmax(input, use_cudnn: bool = False, name=None):
    """reference: sequence_lod.py sequence_softmax — softmax within each
    sequence (dense: over the time axis)."""
    from ...nn import functional as F

    x = ensure_tensor(input)
    return F.softmax(x, axis=1 if x.ndim > 1 else 0)


def sequence_pool(input, pool_type: str, is_test: bool = False,
                  pad_value: float = 0.0):
    """reference: sequence_lod.py sequence_pool — average/sum/sqrt/max/
    last/first over each sequence's time steps."""
    x = ensure_tensor(input)
    pt = pool_type.lower()

    def pool(v):
        if pt == "average":
            return torch.mean(v, dim=1)
        if pt == "sum":
            return torch.sum(v, dim=1)
        if pt == "sqrt":
            return torch.sum(v, dim=1) / np.sqrt(v.shape[1])
        if pt == "max":
            return torch.amax(v, dim=1)
        if pt == "last":
            return v[:, -1]
        if pt == "first":
            return v[:, 0]
        raise ValueError(f"sequence_pool: bad pool_type {pool_type!r}")

    return apply_op(pool, [x], name=f"sequence_pool_{pt}")


def sequence_concat(input, name=None):
    """reference: sequence_lod.py sequence_concat — joins sequences
    time-wise (dense: concat on axis 1)."""
    xs = [ensure_tensor(v) for v in input]
    return apply_op(lambda *vs: torch.cat(vs, dim=1), xs,
                    name="sequence_concat")


def sequence_first_step(input):
    """reference: sequence_lod.py sequence_first_step."""
    return apply_op(lambda v: v[:, 0], [ensure_tensor(input)],
                    name="sequence_first_step")


def sequence_last_step(input):
    """reference: sequence_lod.py sequence_last_step."""
    return apply_op(lambda v: v[:, -1], [ensure_tensor(input)],
                    name="sequence_last_step")


def sequence_slice(input, offset, length, name=None):
    """reference: sequence_lod.py sequence_slice — per-sequence sub-span.
    Dense: one shared (offset, length) span along time; scalar or
    per-row-equal tensors (a ragged span has no dense shape)."""
    x = ensure_tensor(input)
    off = int(ensure_tensor(offset).numpy().reshape(-1)[0])
    ln = int(ensure_tensor(length).numpy().reshape(-1)[0])
    return apply_op(lambda v: v[:, off:off + ln], [x],
                    name="sequence_slice")


def sequence_expand(x, y, ref_level: int = -1, name=None):
    """reference: sequence_lod.py sequence_expand — repeat x's rows per y's
    LoD. Dense: broadcast x's time axis to y's time length."""
    xt, yt = ensure_tensor(x), ensure_tensor(y)

    def exp(xv, yv):
        T = yv.shape[1]
        if xv.ndim == 2:
            xv = xv[:, None, :]
        if T % xv.shape[1]:
            raise ValueError(
                f"sequence_expand: y's time length {T} is not a multiple of "
                f"x's {xv.shape[1]} — a silent truncation here surfaces as a "
                "shape error far downstream")
        reps = [1] * xv.ndim
        reps[1] = T // xv.shape[1]
        return xv.repeat(*reps)

    return apply_op(exp, [xt, yt], name="sequence_expand")


def sequence_expand_as(x, y, name=None):
    """reference: sequence_lod.py sequence_expand_as."""
    return sequence_expand(x, y, name=name)


def sequence_pad(x, pad_value, maxlen: Optional[int] = None, name=None):
    """reference: sequence_lod.py sequence_pad — returns (padded, lengths).
    Dense input is already rectangular; pads time to ``maxlen``."""
    xt = ensure_tensor(x)
    pv = ensure_tensor(pad_value)
    T = xt.shape[1]
    target = int(maxlen) if maxlen is not None else T

    def pad(v, p):
        if target <= T:
            return v[:, :target]
        fill = p.reshape(()).to(v.dtype).expand(
            (v.shape[0], target - T) + tuple(v.shape[2:]))
        return torch.cat([v, fill], dim=1)

    padded = apply_op(pad, [xt, pv], name="sequence_pad")
    lengths = Tensor(torch.full((xt.shape[0],), min(T, target),
                                dtype=torch.int64,
                                device=xt._value.device))
    return padded, lengths


def sequence_unpad(x, length, name=None):
    """reference: sequence_lod.py sequence_unpad — zero out positions past
    each row's length and trim to the longest row."""
    from ...ops import graph_cond as _gc

    xt, lt = ensure_tensor(x), ensure_tensor(length)
    # under a capture the lengths are not on the host: keep every step
    max_len = xt.shape[1] if _gc.capturing(lt._value) \
        else int(lt.numpy().max())

    def unpad(v, ln):
        pos = torch.arange(v.shape[1], device=v.device)
        mask = pos[None, :] < ln.reshape(-1, 1)
        mask = mask.reshape(mask.shape + (1,) * (v.ndim - 2))
        return torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                                device=v.device))[:, :max_len]

    return apply_op(unpad, [xt, lt], name="sequence_unpad")


def sequence_reshape(input, new_dim: int, name=None):
    """reference: sequence_lod.py sequence_reshape — refold time×feature
    so the feature width becomes ``new_dim``."""
    x = ensure_tensor(input)
    return apply_op(lambda v: v.reshape(v.shape[0], -1, new_dim), [x],
                    name="sequence_reshape")


def sequence_scatter(input, index, updates, name=None):
    """reference: sequence_lod.py sequence_scatter — adds updates at the
    given time positions per row."""
    x, idx, upd = (ensure_tensor(input), ensure_tensor(index),
                   ensure_tensor(updates))

    def scat(v, iv, uv):
        iv = iv.reshape(v.shape[0], -1).to(torch.int64)
        uv = uv.reshape(tuple(iv.shape) + tuple(v.shape[2:]))
        rows = torch.arange(v.shape[0], device=v.device)[:, None].expand(
            -1, iv.shape[1])
        return v.index_put((rows, iv), uv.to(v.dtype), accumulate=True)

    return apply_op(scat, [x, idx, upd], name="sequence_scatter")


def sequence_enumerate(input, win_size: int, pad_value: int = 0, name=None):
    """reference: sequence_lod.py sequence_enumerate — all length-
    ``win_size`` subsequences, padded at the tail."""
    x = ensure_tensor(input)

    def enum(v):
        T = v.shape[1]
        vp = torch.nn.functional.pad(v, (0, win_size - 1), value=pad_value)
        return torch.stack([vp[:, i:i + T] for i in range(win_size)], dim=-1)

    return apply_op(enum, [x], name="sequence_enumerate")


def sequence_reverse(x, name=None):
    """reference: sequence_lod.py sequence_reverse — flip time."""
    return apply_op(lambda v: torch.flip(v, dims=(1,)), [ensure_tensor(x)],
                    name="sequence_reverse")
