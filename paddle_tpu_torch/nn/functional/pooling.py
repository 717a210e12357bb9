"""Pooling functionals (``paddle_tpu/nn/functional/pooling.py``).

Each takes the JAX package's signature, facade or torch tensors
(``tensor.facade_io``), and casts its input by the amp rule under the
JAX package's op name (``max_pool2d``, ``avg_pool2d``,
``adaptive_avg_pool2d``, ...). The reference reduces windows with
``lax.reduce_window``; torch's pools differ from it at the edges, so
the windows are built here as the reference builds them and torch's
pools run only over inputs already padded to them:

- ``ceil_mode`` widens the right pad by ``stride - rem`` (the reference
  keeps a last window that starts in the right padding, torch drops it);
- a max pool pads with ``-inf`` (torch's own padding when the pads are
  equal and within half the window, else an explicit ``F.pad``); its
  gradient goes to the first maximum of each window in row-major order,
  as the VJP of ``reduce_window`` max does, summed over overlapping
  windows;
- an average sums the zero-padded window and divides by ``prod(ksize)``
  (torch would clip the window to the padded input), by the count of
  real elements when ``exclusive``, or by ``divisor_override``;
- ``"SAME"``/``"VALID"`` are XLA's (``ceil(in / stride)`` windows, the
  odd pad at the end); ``exclusive`` and ``ceil_mode`` do not apply to
  them, as in the reference;
- ``return_mask`` is the flat, unpadded spatial index of each window's
  first maximum (int32), and raises for a channel-last layout or string
  padding; ``max_unpool`` scatters by it;
- adaptive windows run from ``floor(i * in / out)`` to
  ``ceil((i + 1) * in / out)``, pooled one axis after the other as the
  reference does (an adaptive max's gradient is shared among tied
  values, axis by axis, as ``jnp.max``'s is); ``None`` keeps a size.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ...amp import cast_inputs
from ...tensor import facade_io
from .common import as_torch
from .conv import _tuplize, same_pads, torch_pad

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool1d", "max_pool2d", "max_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "max_unpool1d", "max_unpool2d", "max_unpool3d",
]

_CHANNEL_LAST = ("NHWC", "NWC", "NLC", "NDHWC")
_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_ADAPTIVE_MAX = {1: tF.adaptive_max_pool1d, 2: tF.adaptive_max_pool2d,
                 3: tF.adaptive_max_pool3d}


def _pool_pad(padding, n):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad pool padding {padding}")


def _window_pads(pad, in_sp, ksize, stride, ceil_mode):
    """The ``(lo, hi)`` pads of each spatial dim, as the reference gives
    ``reduce_window``: a string is XLA's, and ``ceil_mode`` widens the
    high side by ``stride - rem``."""
    if pad == "VALID":
        return [(0, 0)] * len(in_sp)
    if pad == "SAME":
        return same_pads(in_sp, ksize, stride)
    if isinstance(pad, str):
        raise ValueError(f"unknown padding {pad}")
    pads = [list(p) for p in pad]
    if ceil_mode:
        for i, size in enumerate(in_sp):
            rem = (size + pads[i][0] + pads[i][1] - ksize[i]) % stride[i]
            if rem:
                pads[i][1] += stride[i] - rem
    return [tuple(p) for p in pads]


def _setup(x, kernel_size, stride, padding, ceil_mode, n, data_format, name):
    channel_last = data_format in _CHANNEL_LAST
    ksize = _tuplize(kernel_size, n)
    stride = _tuplize(stride if stride is not None else kernel_size, n)
    pad = _pool_pad(padding, n)
    (a,) = cast_inputs(name, as_torch(x))
    if channel_last:
        a = a.movedim(-1, 1)
    pads = _window_pads(pad, a.shape[2:], ksize, stride, ceil_mode)
    return a, channel_last, ksize, stride, pad, pads


def _padded_max(a, ksize, stride, pads, n, with_indices=False):
    """torch's max pool over ``a`` padded with -inf by ``pads``: its own
    padding where that is the same window, else an explicit pad. With
    ``with_indices``, also the flat unpadded spatial index of each
    window's first maximum (int32)."""
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ksize)):
        res = _MAX[n](a, ksize, stride, [lo for lo, _ in pads],
                      return_indices=with_indices)
        return (res[0], res[1].to(torch.int32)) if with_indices else res
    neg = (-torch.inf if a.is_floating_point()
           else torch.iinfo(a.dtype).min)
    ap = tF.pad(a, torch_pad(pads), value=neg)
    res = _MAX[n](ap, ksize, stride, 0, return_indices=with_indices)
    if not with_indices:
        return res
    return res[0], _unpadded_index(res[1], ap.shape[2:], pads, a.shape[2:])


def _unpadded_index(idx, padded_sp, pads, in_sp):
    """Flat indices into the padded spatial dims as flat indices into
    the unpadded ones (int32, the reference's mask dtype)."""
    flat = torch.zeros_like(idx)
    rem = idx
    mult = 1
    for i in reversed(range(len(in_sp))):
        coord = rem % padded_sp[i] - pads[i][0]
        rem = rem // padded_sp[i]
        flat = flat + coord * mult
        mult *= in_sp[i]
    return flat.to(torch.int32)


def _max_pool(x, kernel_size, stride, padding, ceil_mode, n, data_format,
              return_mask=False):
    a, channel_last, ksize, stride, pad, pads = _setup(
        x, kernel_size, stride, padding, ceil_mode, n, data_format,
        f"max_pool{n}d")
    if not return_mask:
        out = _padded_max(a, ksize, stride, pads, n)
        return out.movedim(1, -1) if channel_last else out
    if channel_last or isinstance(pad, str):
        raise NotImplementedError(
            "return_mask needs NC-first layout and explicit padding")
    # torch's first maximum of each window is the reference's argmax over
    # the window's offsets in row-major order
    return _padded_max(a, ksize, stride, pads, n, True)


def _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, n, data_format):
    a, channel_last, ksize, stride, pad, pads = _setup(
        x, kernel_size, stride, padding, ceil_mode, n, data_format,
        f"avg_pool{n}d")
    padded = tF.pad(a, torch_pad(pads)) if any(map(any, pads)) else a
    summed = _window_sum(padded, ksize, stride, n)
    if divisor_override:
        out = summed / divisor_override
    elif exclusive and not isinstance(pad, str):
        ones = torch.ones((1, 1) + tuple(a.shape[2:]), dtype=a.dtype,
                          device=a.device)
        counts = _window_sum(tF.pad(ones, torch_pad(pads)), ksize, stride, n)
        out = summed / torch.clamp(counts, min=1.0)
    else:
        out = summed / float(np.prod(ksize))
    return out.movedim(1, -1) if channel_last else out


def _window_sum(ap, ksize, stride, n):
    """The sum of every window of the padded ``ap`` (torch's average
    with a divisor of 1; a 1-D pool as a 2-D one of height 1)."""
    if n == 1:
        return tF.avg_pool2d(ap.unsqueeze(-2), (1, ksize[0]), (1, stride[0]),
                             divisor_override=1).squeeze(-2)
    pool = tF.avg_pool2d if n == 2 else tF.avg_pool3d
    return pool(ap, ksize, stride, divisor_override=1)


@facade_io
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, ceil_mode, 1,
                     data_format, return_mask)


@facade_io
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, ceil_mode, 2,
                     data_format, return_mask)


@facade_io
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, ceil_mode, 3,
                     data_format, return_mask)


@facade_io
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     None, 1, data_format)


@facade_io
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, 2, data_format)


@facade_io
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, 3, data_format)


def _adaptive_windows(in_size, out_size):
    """Per-output ``[start, end)`` windows (Paddle's adaptive pooling)."""
    starts = [(i * in_size) // out_size for i in range(out_size)]
    ends = [-(-((i + 1) * in_size) // out_size) for i in range(out_size)]
    return starts, ends


def _out_sizes(a_shape, output_size, n, channel_last):
    """The output's spatial sizes; ``None`` (the whole size or one
    entry) keeps the input's."""
    if output_size is None or isinstance(output_size, int):
        output_size = (output_size,) * n
    return tuple((a_shape[1 + i] if channel_last else a_shape[2 + i])
                 if o is None else int(o) for i, o in enumerate(output_size))


def _adaptive_pool(x, output_size, n, data_format, op):
    channel_last = data_format in _CHANNEL_LAST
    (a,) = cast_inputs(f"adaptive_{op}_pool{n}d", as_torch(x))
    out_sp = _out_sizes(a.shape, output_size, n, channel_last)
    axes = range(1, 1 + n) if channel_last else range(2, 2 + n)
    reduce = ((lambda w, ax: w.mean(ax, keepdim=True)) if op == "avg"
              else (lambda w, ax: w.amax(ax, keepdim=True)))
    out = a
    for i, ax in enumerate(axes):
        size = out.shape[ax]
        if out_sp[i] == size:
            continue  # every window one element: the identity
        if out_sp[i] == 1:
            out = reduce(out, ax)
            continue
        starts, ends = _adaptive_windows(size, out_sp[i])
        out = torch.cat([reduce(out.narrow(ax, s, e - s), ax)
                         for s, e in zip(starts, ends)], dim=ax)
    return out


@facade_io
def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "NCW", "avg")


@facade_io
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format, "avg")


@facade_io
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format, "avg")


def _adaptive_max_mask(x, output_size, n):
    """The flat spatial index of each adaptive window's first maximum
    (int32): torch's adaptive max pool has the reference's windows and
    picks the first maximum in row-major order, as its argmax does."""
    (a,) = cast_inputs("adaptive_max_mask", as_torch(x).detach())
    out_sp = _out_sizes(a.shape, output_size, n, False)
    return _ADAPTIVE_MAX[n](a, out_sp, return_indices=True)[1].to(
        torch.int32)


@facade_io
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 1, "NCW", "max")
    return (out, _adaptive_max_mask(x, output_size, 1)) if return_mask \
        else out


@facade_io
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 2, "NCHW", "max")
    return (out, _adaptive_max_mask(x, output_size, 2)) if return_mask \
        else out


@facade_io
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 3, "NCDHW", "max")
    return (out, _adaptive_max_mask(x, output_size, 3)) if return_mask \
        else out


def _max_unpool(x, indices, kernel_size, stride, padding, output_size, n):
    x = as_torch(x)
    idx = as_torch(indices, x)
    ksize = _tuplize(kernel_size, n)
    stride_ = _tuplize(stride if stride is not None else kernel_size, n)
    if output_size is None:
        pad = _tuplize(padding, n)
        out_sp = tuple((x.shape[2 + i] - 1) * stride_[i] + ksize[i]
                       - 2 * pad[i] for i in range(n))
    else:
        out_sp = tuple(int(s) for s in output_size)[-n:]
    (a,) = cast_inputs(f"max_unpool{n}d", x)
    nb, c = a.shape[0], a.shape[1]
    out = a.new_zeros((nb, c, int(np.prod(out_sp))))
    out = out.scatter(2, idx.reshape(nb, c, -1).to(torch.int64),
                      a.reshape(nb, c, -1))
    return out.reshape((nb, c) + out_sp)


@facade_io
def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, output_size,
                       1)


@facade_io
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, output_size,
                       2)


@facade_io
def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, output_size,
                       3)
