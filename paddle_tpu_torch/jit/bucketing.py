"""Shape bucketing (``paddle_tpu/jit/bucketing.py``): a bounded number of
captured programs under dynamic batch, sequence or image shapes.

:class:`StaticFunction` captures one CUDA graph per input signature, so
inputs whose shapes vary freely would capture without bound. Every
dynamic dim is padded up to a boundary of a fixed ladder before the
signature is formed: the programs are then at most the product of the
ladders' lengths, and the padding is bounded by the ladder's step ratio.
Masking the padded tail (attention masks, ignore labels, a box mask) is
the model's contract.

Padding runs on the tensor's own device, one ``torch.nn.functional.pad``
per argument, with no host round trip; a facade ``Tensor`` comes back as
a facade ``Tensor``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..tensor import Tensor

__all__ = ["pow2_buckets", "bucket_for", "pad_to_bucket", "BucketedFunction"]


def pow2_buckets(lo: int, hi: int) -> list:
    """Power-of-two ladder covering [lo, hi], e.g. (24, 100) -> [32, 64,
    128]."""
    out = []
    b = 1 << max(0, math.ceil(math.log2(max(1, lo))))
    while b < hi:
        out.append(b)
        b *= 2
    out.append(b)
    return out


def bucket_for(size: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= size; raises past the ladder (an unbounded dim is
    a configuration error, not something to hide with a giant capture)."""
    for b in sorted(buckets):
        if size <= b:
            return int(b)
    raise ValueError(f"size {size} exceeds the largest bucket "
                     f"{max(buckets)}; extend the ladder explicitly")


def _pad_multi(x, dims: Dict[int, Sequence[int]], pad_value=0):
    """Pad several dims of ``x`` (a Tensor, a torch tensor or an array) to
    their buckets in one pad on its device. Returns ``(padded, sizes)``:
    a Tensor for a Tensor, else a torch tensor."""
    is_tensor = isinstance(x, Tensor)
    if is_tensor:
        arr = x._value
    elif isinstance(x, torch.Tensor):
        arr = x
    else:
        arr = torch.from_numpy(np.ascontiguousarray(x))
    pads = [0] * (2 * arr.ndim)
    sizes = {}
    changed = False
    for axis, buckets in dims.items():
        axis = axis % arr.ndim
        size = arr.shape[axis]
        target = bucket_for(size, buckets)
        sizes[axis] = size
        if target != size:
            # F.pad lists (left, right) pairs from the last dim backwards
            pads[2 * (arr.ndim - 1 - axis) + 1] = target - size
            changed = True
    if changed:
        arr = torch.nn.functional.pad(arr, pads, value=pad_value)
    if is_tensor:
        return (Tensor._wrap(arr) if changed else x), sizes
    return arr, sizes


def pad_to_bucket(x, axis: int, buckets: Sequence[int], pad_value=0):
    """Pad ``x`` along ``axis`` up to its bucket. Returns ``(padded,
    original_size)``."""
    padded, sizes = _pad_multi(x, {axis: buckets}, pad_value)
    return padded, sizes[axis % len(padded.shape)]


class BucketedFunction:
    """A step function whose dynamic input dims are bucket-padded before
    :class:`StaticFunction` forms its signature.

    ``axes`` maps a positional argument's index to ``{dim: ladder}``;
    ``pad_values`` maps the same index to the fill value (an ignore
    label, a zero box mask)::

        step = BucketedFunction(train_fn, axes={0: {0: [8, 16], 1: [128, 256]},
                                                1: {0: [8, 16], 1: [128, 256]}},
                                pad_values={1: -100})

    ``compile_count`` is the number of signatures in the wrapped
    ``StaticFunction``'s cache (one CUDA graph each on the card);
    ``jit=False`` calls ``fn`` itself on the padded arguments.
    """

    def __init__(self, fn, axes: Dict[int, Dict[int, Sequence[int]]],
                 pad_values: Optional[Dict[int, object]] = None,
                 observe: Sequence = (), jit: bool = True):
        from .static_function import StaticFunction

        self._axes = {int(k): {int(d): list(b) for d, b in v.items()}
                      for k, v in axes.items()}
        self._pad_values = dict(pad_values or {})
        self._fn = StaticFunction(fn, observe=list(observe),
                                  warmup=False) if jit else fn

    def _padded(self, *args) -> list:
        """The arguments as the wrapped function receives them."""
        padded = list(args)
        for i, dims in self._axes.items():
            padded[i], _ = _pad_multi(padded[i], dims,
                                      self._pad_values.get(i, 0))
        return padded

    def __call__(self, *args):
        return self._fn(*self._padded(*args))

    @property
    def compile_count(self) -> int:
        cache = getattr(self._fn, "_cache", None)
        return len(cache) if cache is not None else 0

    def max_programs(self) -> int:
        """Upper bound on captured programs from the bucket ladders
        alone."""
        n = 1
        for dims in self._axes.values():
            for ladder in dims.values():
                n *= len(ladder)
        return n
