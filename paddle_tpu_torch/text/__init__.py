"""``paddle.text`` (``paddle_tpu/text/__init__.py``): ``viterbi_decode``,
``ViterbiDecoder`` and the ``datasets``, which download their corpora and
so raise without a network.

The JAX package's forward pass is a ``lax.scan`` over time and its walk
back a reverse scan; the port runs both as torch loops over ``T`` on the
device (no host reads), one op of the tape. Past each sequence's length
the scores are frozen and the back pointers are the identity, and the
path there takes the last valid tag.
"""
from __future__ import annotations

import torch

from ..autograd.engine import apply_op
from ..nn.layer_base import Layer
from ..ops._apply import ensure_tensor

__all__ = ["viterbi_decode", "ViterbiDecoder", "datasets",
           "Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
           "WMT14", "WMT16"]


def _viterbi(p, tr, ln, include_bos_eos_tag: bool):
    """(scores [B], paths [B, T]) of emissions ``p`` [B, T, N] under
    transitions ``tr`` [N, N] for lengths ``ln`` [B]."""
    B, T, N = p.shape
    bos, eos = N - 2, N - 1
    alpha = p[:, 0, :]
    if include_bos_eos_tag:
        alpha = alpha + tr[bos][None, :]
    ident = torch.arange(N, device=p.device)[None, :].expand(B, N)
    backptrs = []
    for t in range(1, T):
        # scores[b, prev, cur] = alpha[b, prev] + tr[prev, cur] + emit
        scores = alpha[:, :, None] + tr[None, :, :]
        best_prev = torch.argmax(scores, dim=1)  # [B, N]
        best = torch.amax(scores, dim=1) + p[:, t, :]
        active = (t < ln)[:, None]  # frozen past each sequence's end
        alpha = torch.where(active, best, alpha)
        backptrs.append(torch.where(active, best_prev, ident))
    if include_bos_eos_tag:
        alpha = alpha + tr[:, eos][None, :]
    tag = torch.argmax(alpha, dim=-1)  # [B]
    scores = torch.amax(alpha, dim=-1)
    tags = [tag]
    for bp in reversed(backptrs):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    paths = torch.stack(tags[::-1], dim=1)  # [B, T]
    idx = torch.arange(T, device=p.device)[None, :]
    last = torch.gather(paths, 1, torch.clamp(ln - 1, min=0)[:, None])
    return scores, torch.where(idx < ln[:, None], paths, last)


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag: bool = True, name=None):
    """``paddle.text.viterbi_decode``: ``potentials`` [B, T, N] emissions,
    ``transition_params`` [N, N] (BOS = N-2 and EOS = N-1 rows when
    ``include_bos_eos_tag``), ``lengths`` [B]; returns (scores [B], paths
    [B, T])."""
    pot = ensure_tensor(potentials)
    trans = ensure_tensor(transition_params)
    lens = ensure_tensor(lengths)
    ln = lens._value.to(device=pot._value.device, dtype=torch.int64)
    return apply_op(lambda pv, tv: _viterbi(pv, tv.to(pv.device), ln,
                                            include_bos_eos_tag),
                    [pot, trans], name="viterbi_decode")


class ViterbiDecoder(Layer):
    """``paddle.text.ViterbiDecoder``: :func:`viterbi_decode` with the
    transitions it holds."""

    def __init__(self, transitions, include_bos_eos_tag: bool = True,
                 name=None):
        super().__init__()
        self.transitions = ensure_tensor(transitions)
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


class _ZeroEgressDataset:
    def __init__(self, *a, **k):
        raise RuntimeError(
            f"{type(self).__name__} downloads its corpus from the network; "
            "this environment is zero-egress. Provide the files locally and "
            "use paddle_tpu_torch.io.Dataset to wrap them.")


class datasets:
    class Imdb(_ZeroEgressDataset):
        pass

    class Imikolov(_ZeroEgressDataset):
        pass

    class Movielens(_ZeroEgressDataset):
        pass

    class UCIHousing(_ZeroEgressDataset):
        pass

    class WMT14(_ZeroEgressDataset):
        pass

    class WMT16(_ZeroEgressDataset):
        pass

    class Conll05st(_ZeroEgressDataset):
        pass


# reference exports the dataset classes at paddle.text top level too
Imdb = datasets.Imdb
Imikolov = datasets.Imikolov
Movielens = datasets.Movielens
UCIHousing = datasets.UCIHousing
WMT14 = datasets.WMT14
WMT16 = datasets.WMT16
Conll05st = datasets.Conll05st
