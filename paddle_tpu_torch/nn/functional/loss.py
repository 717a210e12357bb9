"""Loss functionals (``paddle_tpu/nn/functional/loss.py``).

Each takes the JAX package's signature, facade or torch tensors
(``tensor.facade_io``), and casts by the amp rule under the JAX
package's op name (``cross_entropy``, ``nll_loss``, ``mse_loss``, ... are
on the black list: f32 under ``auto_cast``). Integer labels carry no
gradient. ``reduction`` is ``"mean"``, ``"sum"`` or ``"none"`` (and
``"batchmean"`` for ``kl_div``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...amp import cast_inputs
from ...ops.math import abs_tensor, clip_tensor
from ...tensor import facade_io
from .activation import softmax
from .common import as_torch

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "mse_loss", "l1_loss",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "ctc_loss", "log_loss",
    "square_error_cost", "sigmoid_focal_loss", "dice_loss", "npair_loss",
    "triplet_margin_loss", "triplet_margin_with_distance_loss",
    "multi_label_soft_margin_loss", "soft_margin_loss", "poisson_nll_loss",
    "gaussian_nll_loss",
]


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    if reduction == "none":
        return val
    raise ValueError(f"reduction {reduction!r}")


def _ins(name, *xs):
    """The inputs as torch tensors on the first one's device, amp-cast
    under ``name`` (``None`` passes through)."""
    first = as_torch(xs[0])
    ts = [first] + [None if x is None else as_torch(x, first)
                    for x in xs[1:]]
    return cast_inputs(name, *ts)


def _softplus0(z):
    """``log(1 + exp(z))``, stable (``jnp.logaddexp(0, z)``)."""
    return torch.logaddexp(z, torch.zeros((), dtype=z.dtype,
                                          device=z.device))


@facade_io
def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    """Softmax cross entropy over ``axis``. Hard labels (integers, a
    trailing 1 axis allowed): a label equal to ``ignore_index`` gives 0
    and is left out of the mean's count (at least 1); a class ``weight``
    scales each row and the mean divides by the weights' sum. Soft
    labels: ``-sum(label * log p)``, weighted by ``sum(label * weight)``.
    ``label_smoothing`` mixes in the uniform distribution;
    ``use_softmax=False`` takes ``input`` as probabilities."""
    logits, wt = _ins("cross_entropy", input, weight)
    lbl = as_torch(label, logits)
    if soft_label:
        (lbl,) = cast_inputs("cross_entropy", lbl)
    ax = axis % logits.dim()
    logp = (torch.log_softmax(logits, ax) if use_softmax
            else torch.log(logits.clamp_min(1e-12)))
    nclass = logits.shape[ax]
    if soft_label:
        soft = lbl
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / nclass
        loss = -(soft * logp).sum(ax)
        if wt is not None:
            loss = loss * (soft * wt).sum(ax)
        return _reduce(loss, reduction)
    idx = lbl.to(torch.int64)
    if idx.dim() == logits.dim():
        idx = idx.squeeze(ax)
    valid = idx != ignore_index
    safe = torch.where(valid, idx, 0)
    picked = logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0:
        loss = (-(1 - label_smoothing) * picked
                - label_smoothing * logp.mean(ax))
    else:
        loss = -picked
    loss = torch.where(valid, loss, 0.0)
    if wt is not None:
        w_per = torch.where(valid, wt[safe], 0.0)
        loss = loss * w_per
        if reduction == "mean":
            return loss.sum() / w_per.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.to(loss.dtype).sum().clamp_min(1.0)
    return _reduce(loss, reduction)


@facade_io
def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    """The per-row loss, with a trailing 1 axis for hard labels; with
    ``return_softmax`` also the softmax."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if not soft_label:
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


@facade_io
def binary_cross_entropy(input, label, weight=None, reduction: str = "mean",
                         name=None):
    p, y, w = _ins("bce", input, label, weight)
    p = clip_tensor(p, 1e-12, 1.0 - 1e-7)
    loss = -(y * torch.log(p) + (1 - y) * torch.log1p(-p))
    return _reduce(loss if w is None else loss * w, reduction)


@facade_io
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None, name=None):
    z, y, w, pw = _ins("bce_with_logits", logit, label, weight, pos_weight)
    if pw is not None:
        log_w = (pw - 1) * y + 1
        loss = (1 - y) * z + log_w * (_softplus0(-abs_tensor(z))
                                      + clip_tensor(-z, 0.0))
    else:
        loss = clip_tensor(z, 0.0) - z * y + _softplus0(-abs_tensor(z))
    return _reduce(loss if w is None else loss * w, reduction)


@facade_io
def nll_loss(input, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean", name=None):
    """Negative log-likelihood of log-probabilities ``[N, C, d...]``."""
    logp, wt = _ins("nll_loss", input, weight)
    idx = as_torch(label, logp).to(torch.int64)
    valid = idx != ignore_index
    safe = torch.where(valid, idx, 0)
    lp = logp.movedim(1, -1) if logp.dim() > 2 else logp
    picked = lp.gather(-1, safe[..., None]).squeeze(-1)
    loss = -torch.where(valid, picked, 0.0)
    if wt is not None:
        w_per = torch.where(valid, wt[safe], 0.0)
        loss = loss * w_per
        if reduction == "mean":
            return loss.sum() / w_per.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.to(loss.dtype).sum().clamp_min(1.0)
    return _reduce(loss, reduction)


@facade_io
def mse_loss(input, label, reduction: str = "mean", name=None):
    a, b = _ins("mse_loss", input, label)
    return _reduce((a - b) ** 2, reduction)


def square_error_cost(input, label):
    return mse_loss(input, label, reduction="none")


@facade_io
def l1_loss(input, label, reduction: str = "mean", name=None):
    a, b = _ins("l1_loss", input, label)
    return _reduce(abs_tensor(a - b), reduction)


@facade_io
def smooth_l1_loss(input, label, reduction: str = "mean", delta: float = 1.0,
                   name=None):
    a, b = _ins("smooth_l1_loss", input, label)
    d = a - b
    ad = d.abs()
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


@facade_io
def kl_div(input, label, reduction: str = "mean", name=None):
    logp, y = _ins("kl_div", input, label)
    loss = torch.where(y > 0, y * (torch.log(y.clamp_min(1e-12)) - logp),
                       0.0)
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


@facade_io
def margin_ranking_loss(input, other, label, margin: float = 0.0,
                        reduction: str = "mean", name=None):
    a, b, y = _ins("margin_ranking_loss", input, other, label)
    return _reduce(torch.clamp_min(-y * (a - b) + margin, 0.0), reduction)


@facade_io
def hinge_embedding_loss(input, label, margin: float = 1.0,
                         reduction: str = "mean", name=None):
    a, y = _ins("hinge_embedding_loss", input, label)
    return _reduce(torch.where(y == 1, a, torch.clamp_min(margin - a, 0.0)),
                   reduction)


@facade_io
def cosine_embedding_loss(input1, input2, label, margin: float = 0.0,
                          reduction: str = "mean", name=None):
    a, b, y = _ins("cosine_embedding_loss", input1, input2, label)
    cos = (a * b).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), 1e-12)
    return _reduce(torch.where(y == 1, 1 - cos,
                               torch.clamp_min(cos - margin, 0.0)),
                   reduction)


@facade_io
def log_loss(input, label, epsilon: float = 1e-4, name=None):
    p, y = _ins("log_loss", input, label)
    return -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon)


@facade_io
def sigmoid_focal_loss(logit, label, normalizer=None, alpha: float = 0.25,
                       gamma: float = 2.0, reduction: str = "sum",
                       name=None):
    z, y, nrm = _ins("sigmoid_focal_loss", logit, label, normalizer)
    p = torch.sigmoid(z)
    ce = clip_tensor(z, 0.0) - z * y + _softplus0(-abs_tensor(z))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * (1 - p_t) ** gamma * ce
    return _reduce(loss if nrm is None else loss / nrm, reduction)


@facade_io
def dice_loss(input, label, epsilon: float = 1e-5, name=None):
    (p,) = _ins("dice_loss", input)
    y = as_torch(label, p).squeeze(-1).to(torch.int64)
    y1 = tF.one_hot(y, p.shape[-1]).to(p.dtype)
    red = tuple(range(1, p.dim()))
    inter = (p * y1).sum(red)
    union = p.sum(red) + y1.sum(red)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


@facade_io
def npair_loss(anchor, positive, labels, l2_reg: float = 0.002):
    a, p = _ins("npair_loss", anchor, positive)
    y = as_torch(labels, a).reshape(-1)
    batch = a.shape[0]
    tgt = (y[:, None] == y[None, :]).to(a.dtype)
    tgt = tgt / tgt.sum(1, keepdim=True)
    xent = -(tgt * torch.log_softmax(a @ p.T, 1)).sum(1).mean()
    return xent + l2_reg * ((a * a).sum() + (p * p).sum()) / (2 * batch)


@facade_io
def triplet_margin_loss(input, positive, negative, margin: float = 1.0,
                        p: float = 2.0, epsilon: float = 1e-6,
                        swap: bool = False, reduction: str = "mean",
                        name=None):
    a, pos, neg = _ins("triplet_margin_loss", input, positive, negative)

    def dist(u, v):
        return ((u - v).abs() ** p + epsilon).sum(-1) ** (1 / p)

    dp, dn = dist(a, pos), dist(a, neg)
    if swap:
        dn = torch.minimum(dn, dist(pos, neg))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


@facade_io
def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None,
                                      margin: float = 1.0, swap: bool = False,
                                      reduction: str = "mean", name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    dp = as_torch(distance_function(input, positive))
    dn = as_torch(distance_function(input, negative))
    if swap:
        dn = torch.minimum(dn, as_torch(distance_function(positive,
                                                          negative)))
    dp, dn = cast_inputs("triplet_margin_with_distance_loss", dp, dn)
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


@facade_io
def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction: str = "mean", name=None):
    z, y, w = _ins("multi_label_soft_margin_loss", input, label, weight)
    loss = -(y * tF.logsigmoid(z) + (1 - y) * tF.logsigmoid(-z))
    if w is not None:
        loss = loss * w
    return _reduce(loss.mean(-1), reduction)


@facade_io
def soft_margin_loss(input, label, reduction: str = "mean", name=None):
    z, y = _ins("soft_margin_loss", input, label)
    return _reduce(torch.log1p(torch.exp(-y * z)), reduction)


@facade_io
def poisson_nll_loss(input, label, log_input: bool = True,
                     full: bool = False, epsilon: float = 1e-8,
                     reduction: str = "mean", name=None):
    z, y = _ins("poisson_nll_loss", input, label)
    loss = (torch.exp(z) - y * z if log_input
            else z - y * torch.log(z + epsilon))
    if full:
        stirling = (y * torch.log(y + epsilon) - y
                    + 0.5 * torch.log(2 * math.pi * (y + epsilon)))
        loss = loss + torch.where(y > 1, stirling, 0.0)
    return _reduce(loss, reduction)


@facade_io
def gaussian_nll_loss(input, label, variance, full: bool = False,
                      epsilon: float = 1e-6, reduction: str = "mean",
                      name=None):
    mu, y, var = _ins("gaussian_nll_loss", input, label, variance)
    var = var.clamp_min(epsilon)
    loss = 0.5 * (torch.log(var) + (y - mu) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


@facade_io
def ctc_loss(log_probs, labels, input_lengths, label_lengths,
             blank: int = 0, reduction: str = "mean",
             norm_by_times: bool = False):
    """CTC by the alpha recursion in log space over ``[T, N, C]`` logits
    (log-softmaxed here) and ``[N, S]`` padded labels; ``"mean"`` divides
    each sequence's loss by its label length first."""
    (lp,) = cast_inputs("ctc_loss", as_torch(log_probs))
    lp = torch.log_softmax(lp, -1)
    dev = lp.device
    lbl = as_torch(labels, lp).to(torch.int64)
    in_len = as_torch(input_lengths, lp).to(torch.int64).to(dev)
    lbl_len = as_torch(label_lengths, lp).to(torch.int64).to(dev)
    T, N, C = lp.shape
    S = lbl.shape[1]
    L = 2 * S + 1
    ext = torch.full((N, L), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lbl
    # every frame's log-prob of each extended label, as one product with
    # the labels' one-hot rows: its backward sums in a fixed order, where
    # a gather's scatter-add over repeated labels (the blanks) adds in the
    # order its atomics land, so a captured step and its eager twin differ
    onehot = (ext[..., None] == torch.arange(C, device=dev)).to(lp.dtype)
    lp_ext = torch.einsum("tnc,nlc->tnl", lp, onehot)
    neg = torch.full((), -1e30, dtype=lp.dtype, device=dev)
    alpha = torch.full((N, L), -1e30, dtype=lp.dtype, device=dev)
    alpha = torch.cat([lp_ext[0, :, :2], alpha[:, 2:]], 1)
    same2 = torch.cat([torch.ones((N, 2), dtype=torch.bool, device=dev),
                       ext[:, 2:] == ext[:, :-2]], 1)
    for t in range(1, T):
        s1 = torch.cat([neg.expand(N, 1), alpha[:, :-1]], 1)
        s2 = torch.cat([neg.expand(N, 2), alpha[:, :-2]], 1)
        s2 = torch.where(same2, neg, s2)
        new = torch.logaddexp(torch.logaddexp(alpha, s1), s2) + lp_ext[t]
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    last = 2 * lbl_len
    a_n = alpha.gather(1, last[:, None]).squeeze(1)
    a_n1 = alpha.gather(1, (last - 1).clamp_min(0)[:, None]).squeeze(1)
    loss = -torch.logaddexp(a_n, torch.where(lbl_len > 0, a_n1, neg))
    if reduction == "mean":
        return (loss / lbl_len.to(loss.dtype).clamp_min(1.0)).mean()
    return _reduce(loss, reduction)
