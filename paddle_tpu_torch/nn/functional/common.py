"""Common functionals (``paddle_tpu/nn/functional/common.py``): linear,
dropout, embedding, padding, interpolation, folding.

Each takes the JAX package's signature and Paddle's layouts (a
``linear`` weight is ``[in, out]``), facade tensors or torch tensors
(``tensor.facade_io``: facade in, facade out), and casts its inputs by
the amp rule under the JAX package's op name (``amp.cast_inputs``).

Dropout's keep bits are the flash kernels' hash
(``ops.flash_attention.keep_mask``) of a seed and each element's (row,
column) over the mask viewed as ``[numel / last, last]``. The seed is
data, a 0-d int32 tensor on x's device, the global generator's next
(``generator.next_seed``), which a captured step carries as a slot of
its seed buffer, so a replay drops what the eager call would. The bits
are not the JAX package's (its threefry stream differs); the keep rate,
the scaling and the modes are.
"""
from __future__ import annotations

import math
import numbers
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as tF

from ...amp import cast_inputs
from ...generator import device_generator, next_seed
from ...ops.flash_attention import keep_mask
from ...tensor import _as_torch, facade_io

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "pad", "zeropad2d", "interpolate", "upsample",
    "bilinear", "cosine_similarity", "pixel_shuffle", "pixel_unshuffle",
    "channel_shuffle", "unfold", "fold", "label_smooth",
    "class_center_sample", "normalize",
]


def as_torch(x, ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` as a torch tensor (an array, a list or a scalar goes to
    ``ref``'s device; a float64 array meeting a floating ``ref`` takes
    its dtype, as the JAX package's ``ensure_tensor``)."""
    if isinstance(x, torch.Tensor):
        return x
    x = getattr(x, "_value", x)
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    dev = ref.device if ref is not None else "cpu"
    dt = None
    if (ref is not None and ref.is_floating_point()
            and arr.dtype in (np.float64, np.int64)):
        dt = ref.dtype
    return _as_torch(arr, dt, dev)


def promoted(*ts):
    """``ts`` in their common dtype (``jnp`` promotes mixed operands;
    torch's matmul refuses them). ``None`` entries pass through."""
    dt = None
    for t in ts:
        if t is not None:
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) if t is not None and t.dtype != dt else t
                 for t in ts)


@facade_io
def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight: the
    product reads the weight through a transposed view (no copy)."""
    x, weight, bias = cast_inputs("linear", as_torch(x), as_torch(weight),
                                  None if bias is None else as_torch(bias))
    x, weight, bias = promoted(x, weight, bias)
    return tF.linear(x, weight.t(), bias)


def _keep(x: torch.Tensor, p: float, mask_shape) -> torch.Tensor:
    """Keep bits of shape ``mask_shape`` (broadcastable to x) from the
    next dropout seed (module docstring)."""
    seed = next_seed(x.device)
    n = int(np.prod(mask_shape)) if len(mask_shape) else 1
    last = mask_shape[-1] if len(mask_shape) else 1
    rows = torch.arange(n // max(last, 1), dtype=torch.int32,
                        device=x.device)[:, None]
    cols = torch.arange(last, dtype=torch.int32, device=x.device)[None, :]
    return keep_mask(seed, 0, rows, cols, p).view(tuple(mask_shape))


@facade_io
def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None):
    """Paddle's dropout: in training each element (or, with ``axis``,
    each slice along the axes kept) survives with probability ``1 - p``,
    divided by it in ``upscale_in_train`` and not in
    ``downscale_in_infer``, whose inference instead scales by ``1 - p``."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}")
    p = float(getattr(p, "_value", p))
    x = as_torch(x)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            (x,) = cast_inputs("dropout_infer", x)
            return x * (1.0 - p)
        return x
    (x,) = cast_inputs("dropout", x)
    if p == 1.0:
        return torch.zeros_like(x)
    if axis is None:
        shape = tuple(x.shape)
    else:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = tuple(x.shape[i] if i in axes else 1 for i in range(x.dim()))
    keep = _keep(x, p, shape)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


@facade_io
def alpha_dropout(x, p: float = 0.5, training: bool = True, name=None):
    """SELU-preserving dropout: dropped elements take SELU's negative
    saturation, then an affine map keeps mean and variance."""
    x = as_torch(x)
    if not training or p == 0.0:
        return x
    (x,) = cast_inputs("alpha_dropout", x)
    alpha = 1.6732632423543772848170429916717
    scale = 1.0507009873554804934193349852946
    alpha_p = -alpha * scale
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    keep = _keep(x, p, tuple(x.shape))
    return (a * torch.where(keep, x, alpha_p) + b).to(x.dtype)


@facade_io
def embedding(x, weight, padding_idx: Optional[int] = None,
              sparse: bool = False, name=None):
    """Rows of ``weight`` by id. With ``padding_idx`` that row reads as
    zeros and gets no gradient (the table is zeroed there inside the
    differentiated function, as in the JAX package). ``sparse`` is taken
    and ignored: grads are dense."""
    del sparse
    weight = as_torch(weight)
    ids = as_torch(x, weight).to(torch.int64)
    (weight,) = cast_inputs("embedding", weight)
    if padding_idx is not None:
        pidx = padding_idx if padding_idx >= 0 else \
            weight.shape[0] + padding_idx
        weight = weight.index_fill(0, torch.tensor([pidx],
                                                   device=weight.device), 0.0)
    return tF.embedding(ids, weight)


@facade_io
def one_hot(x, num_classes: int, name=None):
    """f32 one-hot rows of integer ids."""
    ids = as_torch(x).to(torch.int64)
    return tF.one_hot(ids, num_classes).to(torch.float32)


def _pad_config(pad, ndim, data_format):
    """Paddle's pad list as per-axis (low, high): ``2 * ndim`` entries
    pad every axis from the first; fewer pad the spatial axes from the
    innermost outward."""
    pad = [int(v) for v in (pad.tolist() if hasattr(pad, "tolist")
                            else pad)]
    if len(pad) == 2 * ndim:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(ndim)]
    cfg = [(0, 0)] * ndim
    spatial = (list(range(2, ndim)) if data_format.startswith("NC")
               else list(range(1, ndim - 1)))
    for i, ax in enumerate(spatial[::-1][:len(pad) // 2]):
        cfg[ax] = (pad[2 * i], pad[2 * i + 1])
    return cfg


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source index of each padded position along one axis (numpy's
    ``reflect``, ``edge`` and ``wrap``)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    period = 2 * (n - 1)
    if period == 0:
        return torch.zeros_like(i)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


@facade_io
def pad(x, pad, mode: str = "constant", value: float = 0.0,
        data_format: str = "NCHW", name=None):
    """Paddle's ``pad`` (``constant``, ``reflect``, ``replicate``,
    ``circular``); the pad list as :func:`_pad_config` reads it."""
    x = as_torch(x)
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad mode {mode!r}")
    (x,) = cast_inputs("pad", x)
    cfg = _pad_config(pad, x.dim(), data_format)
    if mode == "constant":
        flat = [v for lo_hi in reversed(cfg) for v in lo_hi]
        return tF.pad(x, flat, value=value)
    for ax, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                              x.device))
    return x


def zeropad2d(x, padding, data_format: str = "NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


_LINEAR_BY_RANK = {3: "linear", 4: "bilinear", 5: "trilinear"}


@facade_io
def interpolate(x, size=None, scale_factor=None, mode: str = "nearest",
                align_corners: bool = False, align_mode: int = 0,
                data_format: str = "NCHW", name=None):
    """Resize the spatial axes. ``nearest`` samples ``floor(i * in /
    out)`` on 4-d inputs (Paddle's rule) and at half-pixel centres
    otherwise; ``linear``/``bilinear``/``trilinear`` (and ``area``, which
    the JAX package resizes linearly too) use half-pixel centres, or the
    corner-aligned grid with ``align_corners``, and anti-alias a
    down-sample as ``jax.image.resize`` does. ``bicubic`` is torch's
    (Keys a = -0.75; ``jax.image.resize`` uses a = -0.5)."""
    x = as_torch(x)
    channel_last = not data_format.startswith("NC")
    if channel_last:
        x = x.movedim(-1, 1)
    spatial = list(x.shape[2:])
    if size is not None:
        size = size.tolist() if hasattr(size, "tolist") else size
        out = [int(getattr(s, "item", lambda: s)()) for s in
               (size if isinstance(size, (list, tuple)) else [size])]
    else:
        if isinstance(scale_factor, numbers.Number):
            scale_factor = [scale_factor] * len(spatial)
        out = [int(math.floor(s * f)) for s, f in zip(spatial, scale_factor)]
    (x,) = cast_inputs(f"interp_{mode}", x)
    if mode == "nearest":
        tmode = "nearest" if x.dim() == 4 and not align_corners \
            else "nearest-exact"
        y = tF.interpolate(x, size=out, mode=tmode)
    else:
        tmode = ("bicubic" if mode == "bicubic"
                 else _LINEAR_BY_RANK[x.dim()])
        down = any(o < s for o, s in zip(out, spatial))
        aa = down and tmode in ("bilinear", "bicubic")
        y = tF.interpolate(x, size=out, mode=tmode,
                           align_corners=bool(align_corners), antialias=aa)
    return y.movedim(1, -1) if channel_last else y


def upsample(x, size=None, scale_factor=None, mode: str = "nearest",
             align_corners: bool = False, align_mode: int = 0,
             data_format: str = "NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


@facade_io
def bilinear(x1, x2, weight, bias=None, name=None):
    """``y[b, o] = x1[b] @ weight[o] @ x2[b] + bias``."""
    x1, x2, weight = as_torch(x1), as_torch(x2), as_torch(weight)
    bias = None if bias is None else as_torch(bias)
    x1, x2, weight, bias = cast_inputs("bilinear", x1, x2, weight, bias)
    y = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return y if bias is None else y + bias


@facade_io
def cosine_similarity(x1, x2, axis: int = 1, eps: float = 1e-8, name=None):
    a, b = cast_inputs("cosine_similarity", as_torch(x1), as_torch(x2))
    dot = (a * b).sum(axis)
    na = (a * a).sum(axis).sqrt()
    nb = (b * b).sum(axis).sqrt()
    return dot / torch.clamp_min(na * nb, eps)


@facade_io
def normalize(x, p: float = 2, axis: int = 1, epsilon: float = 1e-12,
              name=None):
    (a,) = cast_inputs("normalize", as_torch(x))
    n = a.abs().pow(p).sum(axis, keepdim=True).pow(1.0 / p)
    return a / torch.clamp_min(n, epsilon)


@facade_io
def pixel_shuffle(x, upscale_factor: int, data_format: str = "NCHW",
                  name=None):
    r = upscale_factor
    (a,) = cast_inputs("pixel_shuffle", as_torch(x))
    if data_format == "NCHW":
        n, c, h, w = a.shape
        a = a.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return a.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = a.shape
    a = a.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(n, h * r, w * r, c // (r * r))


@facade_io
def pixel_unshuffle(x, downscale_factor: int, data_format: str = "NCHW",
                    name=None):
    r = downscale_factor
    (a,) = cast_inputs("pixel_unshuffle", as_torch(x))
    if data_format == "NCHW":
        n, c, h, w = a.shape
        a = a.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return a.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = a.shape
    a = a.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(n, h // r, w // r, c * r * r)


@facade_io
def channel_shuffle(x, groups: int, data_format: str = "NCHW", name=None):
    (a,) = cast_inputs("channel_shuffle", as_torch(x))
    if data_format == "NCHW":
        n, c, h, w = a.shape
        return a.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, c = a.shape
    return a.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(n, h, w, c)


def _pair(v):
    return [v] * 2 if isinstance(v, int) else list(v)


def _paddings(p):
    """``[top, left, bottom, right]`` from an int, a pair or four."""
    if isinstance(p, int):
        return [p] * 4
    p = list(p)
    return [p[0], p[1], p[0], p[1]] if len(p) == 2 else p


@facade_io
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` to ``[N, C * kh * kw, L]``, the kernel
    offset inner to the channel."""
    ks, st, dl = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    pd = _paddings(paddings)
    (a,) = cast_inputs("unfold", as_torch(x))
    n, c = a.shape[:2]
    a = tF.pad(a, [pd[1], pd[3], pd[0], pd[2]])
    oh = (a.shape[2] - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    ow = (a.shape[3] - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    patches = [a[:, :, i * dl[0]: i * dl[0] + oh * st[0]: st[0],
                 j * dl[1]: j * dl[1] + ow * st[1]: st[1]]
               for i in range(ks[0]) for j in range(ks[1])]
    return torch.stack(patches, dim=2).reshape(n, c * ks[0] * ks[1], oh * ow)


@facade_io
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of :func:`unfold` (overlaps add)."""
    os_, ks = _pair(output_sizes), _pair(kernel_sizes)
    st, dl, pd = _pair(strides), _pair(dilations), _paddings(paddings)
    (a,) = cast_inputs("fold", as_torch(x))
    n, ckk, _ = a.shape
    c = ckk // (ks[0] * ks[1])
    ph, pw = os_[0] + pd[0] + pd[2], os_[1] + pd[1] + pd[3]
    oh = (ph - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    ow = (pw - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    cols = a.reshape(n, c, ks[0], ks[1], oh, ow)
    out = a.new_zeros((n, c, ph, pw))
    for i in range(ks[0]):
        for j in range(ks[1]):
            out[:, :, i * dl[0]: i * dl[0] + oh * st[0]: st[0],
                j * dl[1]: j * dl[1] + ow * st[1]: st[1]] += cols[:, :, i, j]
    return out[:, :, pd[0]: ph - pd[2], pd[1]: pw - pd[3]]


@facade_io
def label_smooth(label, prior_dist=None, epsilon: float = 0.1, name=None):
    lbl = as_torch(label)
    if prior_dist is None:
        (lbl,) = cast_inputs("label_smooth", lbl)
        return (1 - epsilon) * lbl + epsilon / lbl.shape[-1]
    lbl, prior = cast_inputs("label_smooth", lbl, as_torch(prior_dist, lbl))
    return (1 - epsilon) * lbl + epsilon * prior.reshape(
        (1,) * (lbl.dim() - 1) + (-1,))


@facade_io
def class_center_sample(label, num_classes: int, num_samples: int,
                        group=None):
    """PartialFC's sampling: every positive class of ``label``, then
    negatives drawn at random up to ``num_samples``; returns the labels
    remapped into the sorted sample, and the sample."""
    lbl = as_torch(label)
    pos = torch.unique(lbl)
    pos = pos[pos >= 0]
    if pos.numel() >= num_samples:
        sampled = pos[:num_samples]
    else:
        mask = torch.ones(num_classes, dtype=torch.bool, device=lbl.device)
        mask[pos] = False
        neg = torch.arange(num_classes, device=lbl.device)[mask]
        perm = torch.randperm(neg.numel(), device=lbl.device,
                              generator=device_generator(lbl.device))
        sampled = torch.cat([pos, neg[perm[:num_samples - pos.numel()]]])
    sampled = torch.sort(sampled).values
    return torch.searchsorted(sampled, lbl), sampled

