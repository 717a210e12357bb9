"""The functional tail (``paddle_tpu/nn/functional/extended.py``):
distances, masks, the vision warps, beam-search backtracking and the
losses of the reference's remaining ``nn.functional`` names.

Each takes the JAX package's signature and facade or torch tensors
(``tensor.facade_io``), casts its float inputs by the amp rule under the
JAX package's op name, and computes the JAX package's formula in torch
ops (so torch autograd gives the grads its VJP gives):

- ``affine_grid`` and ``grid_sample`` are the reference's formulas, not
  torch's functions of those names: the reference's ``"reflection"``
  padding folds coordinates its own way, and its bilinear samples clip
  each corner and mask it (zeros) or keep it (border, reflection);
- ``rnnt_loss`` is the reference's forward recursion in log space, a
  loop over time and label positions (no warp-transducer library);
- ``sparse_attention`` materializes the CSR pattern as a dense mask and
  ignores ``key_padding_mask`` and ``attn_mask``, as the reference does;
- ``sequence_mask`` without ``maxlen`` and ``hsigmoid_loss`` with a
  ``path_table`` read those tensors on the host, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ... import dtypes
from ...tensor import facade_io
from .activation import _in_place, elu
from .common import as_torch
from .loss import _ins

__all__ = [
    "pairwise_distance", "elu_", "diag_embed", "sequence_mask",
    "hsigmoid_loss", "margin_cross_entropy", "rnnt_loss", "affine_grid",
    "grid_sample", "gather_tree", "temporal_shift", "sparse_attention",
    "multi_margin_loss",
]


def _reduce(val, reduction):
    """The reference's reductions here: ``"mean"``, ``"sum"``, anything
    else none."""
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


@facade_io
def pairwise_distance(x, y, p: float = 2.0, epsilon: float = 1e-6,
                      keepdim: bool = False, name=None):
    """The ``p``-norm of ``x - y + epsilon`` over the last dim."""
    a, b = _ins("pairwise_distance", x, y)
    return torch.linalg.vector_norm(a - b + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


def elu_(x, alpha: float = 1.0, name=None):
    return _in_place(elu, x, alpha)


@facade_io
def diag_embed(input, offset: int = 0, dim1: int = -2, dim2: int = -1,
               name=None):
    """Each last-dim vector placed on the ``offset`` diagonal of a new
    square matrix, whose row axis goes to the smaller of ``dim1``/``dim2``
    and column axis to the larger (the reference's placement)."""
    (v,) = _ins("diag_embed", input)
    n = v.shape[-1] + abs(offset)
    out = v.new_zeros(v.shape[:-1] + (n, n))
    idx = torch.arange(v.shape[-1], device=v.device)
    out[..., idx + max(-offset, 0), idx + max(offset, 0)] = v
    nd = out.dim()
    lo, hi = sorted((dim1 % nd, dim2 % nd))
    rest = iter(range(nd - 2))
    perm = [nd - 2 if i == lo else nd - 1 if i == hi else next(rest)
            for i in range(nd)]
    return out.permute(perm)


@facade_io
def sequence_mask(x, maxlen: Optional[int] = None, dtype="int64",
                  name=None):
    """Lengths -> a ``[*, maxlen]`` 0/1 mask of ``dtype``; without
    ``maxlen`` the longest length, read on the host."""
    lens = as_torch(x)
    if maxlen is None:
        maxlen = int(lens.max())
    pos = torch.arange(int(maxlen), device=lens.device)
    return (pos < lens[..., None].to(torch.int64)).to(
        dtypes.convert_dtype(dtype))


# ------------------------------------------------------------ losses


def _hsigmoid_paths(num_classes: int):
    """The default complete binary tree: per class its internal nodes
    (heap-numbered from the root, 0-based), left/right codes and path
    length (host side, static given ``num_classes``)."""
    depth = max(1, math.ceil(math.log2(max(num_classes, 2))))
    paths = np.zeros((num_classes, depth), np.int64)
    codes = np.zeros((num_classes, depth), np.float32)
    lengths = np.zeros((num_classes,), np.int64)
    for c in range(num_classes):
        node, path, code = c + num_classes, [], []
        while node > 1:
            path.append(node // 2 - 1)
            code.append(float(node % 2))  # right child -> 1
            node //= 2
        lengths[c] = len(path)
        paths[c, :len(path)] = path[::-1]
        codes[c, :len(code)] = code[::-1]
    return paths, codes, lengths


@facade_io
def hsigmoid_loss(input, label, num_classes: int, weight, bias=None,
                  path_table=None, path_code=None, is_sparse: bool = False,
                  name=None):
    """Hierarchical sigmoid: per row the sum over the nodes of its
    label's path of ``softplus(logit) - code * logit``; ``[B, 1]``."""
    x, w, b = _ins("hsigmoid_loss", input, weight, bias)
    y = as_torch(label, x)
    if path_table is None:
        paths, codes, lens = _hsigmoid_paths(num_classes)
    else:
        paths = as_torch(path_table).cpu().numpy()
        codes = as_torch(path_code).cpu().numpy()
        lens = (paths >= 0).sum(axis=-1)
    dev = x.device
    yl = y.reshape(-1).to(torch.int64)
    p = torch.as_tensor(paths, device=dev)[yl]
    c = torch.as_tensor(codes, device=dev).to(x.dtype)[yl]
    ln = torch.as_tensor(lens, device=dev)[yl]
    valid = torch.arange(p.shape[1], device=dev)[None, :] < ln[:, None]
    logits = torch.einsum("bdf,bf->bd", w[p], x)
    if b is not None:
        logits = logits + b.reshape(-1)[p]
    per_node = torch.logaddexp(logits, torch.zeros_like(logits)) \
        - c * logits
    return torch.where(valid, per_node, 0.0).sum(dim=1)[:, None]


@facade_io
def margin_cross_entropy(logits, label, margin1: float = 1.0,
                         margin2: float = 0.5, margin3: float = 0.0,
                         scale: float = 64.0, group=None,
                         return_softmax: bool = False,
                         reduction: Optional[str] = None, name=None):
    """The ArcFace-family margin softmax: the target logit ``cos t``
    becomes ``cos(m1 t + m2) - m3``, then a cross entropy over the
    logits times ``scale`` (``[N, 1]``, or reduced)."""
    (lv,) = _ins("margin_cross_entropy", logits)
    yl = as_torch(label, lv).reshape(-1).to(torch.int64)
    cos_t = torch.clamp(lv.gather(1, yl[:, None]), -1.0, 1.0)
    adjusted = torch.cos(margin1 * torch.arccos(cos_t) + margin2) - margin3
    one_hot = torch.nn.functional.one_hot(yl, lv.shape[-1]).to(lv.dtype)
    out = (lv * (1 - one_hot) + adjusted * one_hot) * scale
    logp = torch.log_softmax(out, dim=-1)
    loss = _reduce(-logp.gather(1, yl[:, None]), reduction)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


@facade_io
def multi_margin_loss(input, label, p: int = 1, margin: float = 1.0,
                      weight=None, reduction: str = "mean", name=None):
    """The multiclass hinge ``max(0, margin - x[y] + x[i]) ** p`` over the
    classes ``i != y``, divided by the class count."""
    x, w = _ins("multi_margin_loss", input, weight)
    yl = as_torch(label, x).reshape(-1).to(torch.int64)
    target = x.gather(1, yl[:, None])
    hinge = torch.maximum(torch.zeros_like(x), margin - target + x) ** p
    if w is not None:
        hinge = hinge * w.reshape(-1)[yl][:, None]
    one_hot = torch.nn.functional.one_hot(yl, x.shape[-1]).to(x.dtype)
    return _reduce((hinge * (1 - one_hot)).sum(dim=1) / x.shape[-1],
                   reduction)


@facade_io
def rnnt_loss(input, label, input_lengths, label_lengths, blank: int = 0,
              fastemit_lambda: float = 0.0, reduction: str = "mean",
              name=None):
    """The RNN-Transducer negative log likelihood of ``label`` ``[B, U]``
    under ``input`` ``[B, T, U + 1, V]`` (logits, log-softmaxed here in
    f32): ``alpha[t, u] = logaddexp(alpha[t-1, u] + blank(t-1, u),
    alpha[t, u-1] + emit(t, u-1))``, ending at each row's lengths.
    ``fastemit_lambda`` other than 0 raises ``NotImplementedError``, as
    in the reference."""
    if fastemit_lambda:
        raise NotImplementedError(
            "fastemit_lambda != 0 is not implemented; the plain transducer "
            "NLL is (use fastemit_lambda=0)")
    (acts,) = _ins("rnnt_loss", input)
    a = torch.log_softmax(acts.to(torch.float32), dim=-1)
    B, T, U1, _V = a.shape
    U = U1 - 1
    lab = as_torch(label, a).to(torch.int64)
    blank_lp = a[..., blank]                                  # [B, T, U+1]
    emit_lp = a[:, :, :U, :].gather(
        3, lab[:, None, :, None].expand(B, T, U, 1))[..., 0]  # [B, T, U]
    row = [torch.zeros(B, dtype=torch.float32, device=a.device)]
    for u in range(1, U1):  # t = 0: emits only
        row.append(row[-1] + emit_lp[:, 0, u - 1])
    alphas = [torch.stack(row, dim=1)]
    for t in range(1, T):
        from_blank = alphas[-1] + blank_lp[:, t - 1, :]
        row = [from_blank[:, 0]]
        for u in range(1, U1):
            row.append(torch.logaddexp(from_blank[:, u],
                                       row[-1] + emit_lp[:, t, u - 1]))
        alphas.append(torch.stack(row, dim=1))
    alphas = torch.stack(alphas, dim=1)                       # [B, T, U+1]
    t_idx = as_torch(input_lengths, a).reshape(-1).to(torch.int64) - 1
    u_idx = as_torch(label_lengths, a).reshape(-1).to(torch.int64)
    rows = torch.arange(B, device=a.device)
    nll = -(alphas[rows, t_idx, u_idx] + blank_lp[rows, t_idx, u_idx])
    return _reduce(nll, reduction)


# ------------------------------------------------------- vision warping


@facade_io
def affine_grid(theta, out_shape, align_corners: bool = True, name=None):
    """Sampling grid ``[N, H, W, 2]`` of batched affine matrices ``theta``
    ``[N, 2, 3]`` over ``out_shape`` ``(N, C, H, W)``, in float64 as the
    reference's (its base grid is float64 under its x64 setting)."""
    (th,) = _ins("affine_grid", theta)
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _n, _c, H, W = [int(s) for s in out_shape]
    dev = th.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, W, dtype=torch.float64, device=dev)
        ys = torch.linspace(-1.0, 1.0, H, dtype=torch.float64, device=dev)
    else:
        xs = (torch.arange(W, device=dev) * 2 + 1) / W - 1.0
        ys = (torch.arange(H, device=dev) * 2 + 1) / H - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    # the reference's base grid is float64 (x64 on), and so its output
    base = base.to(torch.float64)
    out = torch.einsum("nij,pj->npi", th.to(torch.float32).to(base.dtype),
                       base)
    return out.reshape(th.shape[0], H, W, 2)


@facade_io
def grid_sample(x, grid, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = True,
                name=None):
    """NCHW ``x`` sampled at the normalized ``grid`` ``[N, Hg, Wg, 2]``
    locations (module docstring); ``[N, C, Hg, Wg]``."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError("mode must be 'bilinear' or 'nearest'")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError("bad padding_mode")
    xv, gv = _ins("grid_sample", x, grid)
    N, _C, H, W = xv.shape
    gx, gy = gv[..., 0], gv[..., 1]
    if align_corners:
        fx = (gx + 1) * (W - 1) / 2
        fy = (gy + 1) * (H - 1) / 2
    else:
        fx = ((gx + 1) * W - 1) / 2
        fy = ((gy + 1) * H - 1) / 2
    n_idx = torch.arange(N, device=xv.device)[:, None, None]

    def sample(ix, iy):
        inb = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        if padding_mode == "reflection":
            sx, sy = max(W - 1, 1), max(H - 1, 1)
            ix = torch.abs(torch.remainder(ix + sx * 2, sx * 2) - sx)
            iy = torch.abs(torch.remainder(iy + sy * 2, sy * 2) - sy)
        ixc = torch.clamp(ix, 0, W - 1).to(torch.int64)
        iyc = torch.clamp(iy, 0, H - 1).to(torch.int64)
        vals = xv[n_idx, :, iyc, ixc]                    # [N, Hg, Wg, C]
        if padding_mode != "zeros":
            return vals
        return vals * inb[..., None].to(xv.dtype)

    if mode == "nearest":
        out = sample(torch.round(fx), torch.round(fy))
    else:
        x0, y0 = torch.floor(fx), torch.floor(fy)
        x1, y1 = x0 + 1, y0 + 1
        out = (sample(x0, y0) * ((x1 - fx) * (y1 - fy))[..., None]
               + sample(x0, y1) * ((x1 - fx) * (fy - y0))[..., None]
               + sample(x1, y0) * ((fx - x0) * (y1 - fy))[..., None]
               + sample(x1, y1) * ((fx - x0) * (fy - y0))[..., None])
    return out.movedim(-1, 1)


@facade_io
def temporal_shift(x, seg_num: int, shift_ratio: float = 0.25,
                   data_format: str = "NCHW", name=None):
    """TSM: the first ``shift_ratio`` of the channels shifted one segment
    back in time, the next as many one forward, zeros shifted in."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError("bad data_format")
    (v,) = _ins("temporal_shift", x)
    if data_format == "NHWC":
        v = v.movedim(-1, 1)
    NT, C, H, W = v.shape
    fold = int(C * shift_ratio)
    r = v.reshape(NT // seg_num, seg_num, C, H, W)
    back = torch.cat([r[:, 1:, :fold], torch.zeros_like(r[:, :1, :fold])],
                     dim=1)
    fwd = torch.cat([torch.zeros_like(r[:, :1, fold:2 * fold]),
                     r[:, :-1, fold:2 * fold]], dim=1)
    out = torch.cat([back, fwd, r[:, :, 2 * fold:]], dim=2).reshape(
        NT, C, H, W)
    return out.movedim(1, -1) if data_format == "NHWC" else out


@facade_io
def gather_tree(ids, parents, name=None):
    """Beam-search backtrace over ``[T, B, W]`` step ids and parent beams:
    from the last step back, each beam's token and then its parent's."""
    idv = as_torch(ids)
    pv = as_torch(parents, idv)
    beam = torch.arange(idv.shape[-1], device=idv.device).expand(
        idv.shape[1:])
    toks = []
    for t in range(idv.shape[0] - 1, -1, -1):
        toks.append(idv[t].gather(-1, beam))
        beam = pv[t].gather(-1, beam).to(torch.int64)
    return torch.stack(toks[::-1])


@facade_io
def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention of ``[B, H, S, D]`` inputs over the CSR pattern
    (``sparse_csr_offset`` ``[B, H, S + 1]``, ``sparse_csr_columns``
    ``[B, H, nnz]``) as a dense mask; masked scores are -1e30."""
    q, k, v = _ins("sparse_attention", query, key, value)
    off = as_torch(sparse_csr_offset, q).to(torch.int64)
    cols = as_torch(sparse_csr_columns, q).to(torch.int64)
    B, H, S, D = q.shape
    scores = torch.einsum("bhsd,bhtd->bhst", q, k) / math.sqrt(D)
    pos = torch.arange(cols.shape[-1], device=q.device).expand(B, H, -1)
    rows = torch.searchsorted(off.contiguous(), pos.contiguous(),
                              right=True) - 1
    # entries past the last row's end are dropped (JAX's scatter drops
    # out-of-bounds updates)
    keep = rows < S
    hits = torch.zeros((B, H, S * S), dtype=torch.int32, device=q.device)
    hits.scatter_add_(2, torch.where(keep, rows * S + cols, 0),
                      keep.to(torch.int32))
    scores = scores.masked_fill(hits.view(B, H, S, S) == 0, -1e30)
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(scores, dim=-1), v)
