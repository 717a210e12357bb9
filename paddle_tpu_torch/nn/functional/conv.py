"""Convolution functionals (``paddle_tpu/nn/functional/conv.py``).

Each takes the JAX package's signature, facade or torch tensors
(``tensor.facade_io``), and casts its inputs by the amp rule under the
JAX package's op name (every ``conv*`` is on the white list: bf16 under
``auto_cast``). The weight is Paddle's: ``[out, in / groups, *k]`` for
a convolution and ``[in, out / groups, *k]`` for a transpose, whatever
``data_format`` says; both are torch's own layouts, so the product is
``torch.nn.functional.conv{1,2,3}d`` / ``conv_transpose{1,2,3}d``
(cuDNN on the card) on channels-first values. A channels-last input
(``NLC``, ``NHWC``, ``NDHWC``) is moved to channels first and back.

Padding takes every form the reference takes: an int, ``n`` values,
``2n`` values in Paddle's ``[lo0, hi0, lo1, hi1, ...]`` order,
``[[lo, hi], ...]`` with or without the batch and channel pairs,
``"VALID"`` and ``"SAME"``. ``"SAME"`` is XLA's: ``ceil(in / stride)``
outputs, the odd pad at the end, over the dilated kernel. torch's
``padding="same"`` refuses a stride above 1, so the pads are computed
here; unequal pads go through an explicit ``F.pad`` before the product.
(The reference reads ``[[lo, hi]] * (n + 2)`` at n = 2 as ``2n`` flat
values and raises ``TypeError``; the port takes it, ROADMAP Queue 3.)

The bias is added after the product, in the output's dtype, as the
reference adds it. A transposed convolution is torch's over its full
output, ``(in - 1) * stride + dilation * (k - 1) + 1`` long, then cut
by the low and high pads and extended on the high side, with zeros
(plus the bias), by ``output_padding`` and by what ``output_size`` asks
beyond the natural size: the reference's input-dilated convolution
computes exactly those rows.
"""
from __future__ import annotations

import torch.nn.functional as tF

from ...amp import cast_inputs
from ...tensor import facade_io
from .common import as_torch, promoted

__all__ = [
    "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
]

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")
_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


def _tuplize(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def norm_padding(padding, n):
    """Paddle's padding spec as ``[(lo, hi)] * n``, or ``"SAME"``."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * n
        if p == "SAME":
            return "SAME"
        raise ValueError(f"unknown padding {padding}")
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    nested = bool(padding) and isinstance(padding[0], (list, tuple))
    if nested and len(padding) == n + 2:
        # [[0, 0], [0, 0], [lo, hi], ...]: batch and channel pairs first
        padding = padding[2:]
    if len(padding) == n:
        if nested:
            return [(int(p[0]), int(p[1])) for p in padding]
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n and not nested:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding spec {padding}")


def same_pads(in_sp, k, stride, dilation=None):
    """XLA's ``SAME``: ``ceil(in / stride)`` outputs, the pad split with
    the odd one at the end, over the (dilated) window."""
    pads = []
    for i, size in enumerate(in_sp):
        k_eff = (k[i] - 1) * (dilation[i] if dilation else 1) + 1
        out = -(-size // stride[i])
        total = max((out - 1) * stride[i] + k_eff - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def torch_pad(pads):
    """``[(lo, hi)]`` over the leading spatial dims as ``F.pad``'s list
    (the last dim first)."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _bias(out, b, n):
    return out + b.reshape((1, -1) + (1,) * n)


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format, n,
          name):
    channel_last = data_format in _CHANNEL_LAST
    stride, dilation = _tuplize(stride, n), _tuplize(dilation, n)
    x, weight = as_torch(x), as_torch(weight)
    b = None if bias is None else as_torch(bias, x)
    x, weight, b = cast_inputs(name, x, weight, b)
    x, weight, b = promoted(x, weight, b)
    a = x.movedim(-1, 1) if channel_last else x
    pads = norm_padding(padding, n)
    if pads == "SAME":
        pads = same_pads(a.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        out = _CONV[n](a, weight, None, stride, [lo for lo, _ in pads],
                       dilation, groups)
    else:
        out = _CONV[n](tF.pad(a, torch_pad(pads)), weight, None, stride, 0,
                       dilation, groups)
    if b is not None:
        out = _bias(out, b, n)
    return out.movedim(1, -1) if channel_last else out


@facade_io
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format: str = "NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 1, "conv1d")


@facade_io
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format: str = "NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2, "conv2d")


@facade_io
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format: str = "NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding, groups,
                    dilation, data_format, output_size, n, name):
    channel_last = data_format in _CHANNEL_LAST
    stride, dilation = _tuplize(stride, n), _tuplize(dilation, n)
    opad = _tuplize(output_padding, n)
    x, weight = as_torch(x), as_torch(weight)
    b = None if bias is None else as_torch(bias, x)
    x, weight, b = cast_inputs(name, x, weight, b)
    x, weight, b = promoted(x, weight, b)
    a = x.movedim(-1, 1) if channel_last else x
    in_sp = a.shape[2:]
    ksize = weight.shape[2:]
    k_eff = [dilation[i] * (ksize[i] - 1) + 1 for i in range(n)]
    pads = norm_padding(padding, n)
    if pads == "SAME":
        tot = [max(k_eff[i] - stride[i], 0) for i in range(n)]
        pads = [(t // 2, t - t // 2) for t in tot]
    extra = [0] * n
    if output_size is not None:
        target = [int(s) for s in (
            output_size if isinstance(output_size, (list, tuple))
            else [output_size] * n)]
        for i in range(n):
            natural = ((in_sp[i] - 1) * stride[i] + k_eff[i]
                       - pads[i][0] - pads[i][1] + opad[i])
            extra[i] = target[i] - natural
            if extra[i] < 0 or extra[i] >= stride[i] + dilation[i]:
                raise ValueError(
                    f"invalid output_size {target[i]} for dim {i}: natural "
                    f"size is {natural}")
    full = _CONV_T[n](a, weight, None, stride, 0, 0, groups, dilation)
    # cut the pads off (a negative F.pad crops), extend the high side
    cut = [(-lo, -hi + opad[i] + extra[i]) for i, (lo, hi) in enumerate(pads)]
    out = full if not any(lo or hi for lo, hi in cut) else \
        tF.pad(full, torch_pad(cut))
    if b is not None:
        out = _bias(out, b, n)
    return out.movedim(1, -1) if channel_last else out


@facade_io
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format: str = "NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, data_format, output_size, 1,
                           "conv1d_transpose")


@facade_io
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format: str = "NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, data_format, output_size, 2,
                           "conv2d_transpose")


@facade_io
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format: str = "NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, data_format, output_size, 3,
                           "conv3d_transpose")
