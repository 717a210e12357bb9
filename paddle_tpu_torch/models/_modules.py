"""The ``torch.nn`` layers that the port's GPT and Llama models are built
from, ``rms_norm`` (the JAX package's ``nn.RMSNorm`` formula, not a
Paddle functional) and ``cached_attention`` (the KV-cache attention of
both models).

These are not Paddle's API: the models are ``torch.nn.Module``s whose
``Linear`` weight is ``[out, in]`` (``torch.nn.Linear``'s storage; the
JAX package's is ``[in, out]``, which ``models/convert.py`` transposes
on the way in). Each forward goes through the amp cast rule under the
JAX package's op name (:func:`..amp.cast_inputs`), as the Paddle
functionals of ``nn.functional`` do. ``paddle.nn`` holds the Paddle
layers (``nn.Layer`` over facade Parameters, ``[in, out]`` weights).
"""
from __future__ import annotations

import torch
from torch import nn

from ..amp import cast_inputs
from ..distributed import topology
from ..distributed.fleet import mp_layers
from ..nn import functional as F

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "rms_norm",
           "cached_attention", "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "mp_size"]


def rms_norm(x, weight, epsilon: float = 1e-6):
    """``x * (1 / sqrt(mean(x.f32 ** 2) + eps)).to(x.dtype) * weight`` over
    the last dim, the JAX package's ``nn.RMSNorm`` formula. ``rms_norm``
    is on the amp black list, so under ``auto_cast`` a bf16 input and its
    f32 weight compute in f32 and give f32; outside it mixed dtypes
    promote (a bf16 input over f32 weights gives f32)."""
    x, weight = cast_inputs("rms_norm", x, weight)
    var = x.to(torch.float32).pow(2).mean(dim=-1, keepdim=True)
    return x * (1.0 / torch.sqrt(var + epsilon)).to(x.dtype) * weight


def cached_attention(q, k, v, pos, L: int, scale: float):
    """The KV-cache attention of both models: ``q`` ``[B, S, H, D]`` over
    the whole buffers ``k``/``v`` ``[B, L, H, D]`` (cast to q's dtype),
    keys past each query's position ``pos`` masked with -1e30, softmax in
    q's dtype. Returns ``[B, S, H, D]``."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k.to(q.dtype),
                                               v.to(q.dtype)))
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    cols = torch.arange(L, device=q.device)
    s = s.masked_fill(cols[None, :] > pos[:, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vt).transpose(1, 2)


class Linear(nn.Linear):
    """``torch.nn.Linear``'s ``[out, in]`` weight, read by Paddle's
    ``F.linear`` through its transpose (a view: the product is
    ``torch``'s ``x @ weight.T + bias``, promoted and amp-cast as
    ``linear``)."""

    def forward(self, x):
        return F.linear(x, self.weight.t(), self.bias)


class Embedding(nn.Embedding):
    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LayerNorm(nn.LayerNorm):
    """Its class name keeps its parameters in f32 under
    ``amp.decorate(level="O2")``."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.eps)


class RMSNorm(nn.Module):
    """RMS norm over the last dim with a unit-initialised weight
    (:func:`rms_norm`)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.epsilon = epsilon

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


# ----------------------------------------------- tensor-parallel layers
# Megatron-style shards of the layers above, over the current mesh's
# ``mp`` group (``distributed/fleet/mp_layers.py``). Each carries
# ``shard_dim`` (the dim of its torch-layout weight split over the
# ranks) and ``shard_pieces`` (a fused weight's pieces, split each on
# its own: GPT's QKV is 3), which ``models/convert.py`` reads to carry a
# whole weight into this rank's shard and to gather it back.


def mp_size() -> int:
    """The current mesh's ``mp`` degree (1 without a mesh)."""
    return topology.axis_size("mp")


class ColumnParallelLinear(Linear):
    """This rank's ``[out/mp, in]`` rows of a ``Linear`` (``pieces``
    blocks of ``out / pieces`` each split alike) and its bias block; the
    output is this rank's block of the last dim."""

    shard_dim = 0

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, pieces: int = 1):
        self.group = mp_layers.get_mp_group()
        n = self.group.nranks
        if out_features % (n * pieces):
            raise ValueError(f"out_features {out_features} not divisible by "
                             f"mp degree {n} x {pieces}")
        super().__init__(in_features, out_features // n, bias=bias)
        self.shard_pieces = pieces

    def forward(self, x):
        return super().forward(mp_layers.c_identity(x, self.group))


class RowParallelLinear(Linear):
    """This rank's ``[out, in/mp]`` columns of a ``Linear``; the input is
    this rank's block of the last dim, the partial products are
    all-reduced and the whole bias added."""

    shard_dim = 1
    shard_pieces = 1

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        self.group = mp_layers.get_mp_group()
        super().__init__(mp_layers._mp_size_check(in_features, "in_features",
                                                  self.group),
                         out_features, bias=bias)

    def forward(self, x):
        y = mp_layers.mp_allreduce(F.linear(x, self.weight.t()), self.group)
        if self.bias is None:
            return y
        (y, b) = cast_inputs("add", y, self.bias)
        return y + b


class VocabParallelEmbedding(Embedding):
    """This rank's ``[V/mp, H]`` rows of the vocabulary
    (``mp_layers.vocab_parallel_embedding``)."""

    shard_dim = 0
    shard_pieces = 1

    def __init__(self, num_embeddings: int, embedding_dim: int):
        self.group = mp_layers.get_mp_group()
        v_local = mp_layers._mp_size_check(num_embeddings, "vocab size",
                                           self.group)
        super().__init__(v_local, embedding_dim)
        self.vocab_start_index = self.group.rank * v_local

    def forward(self, ids):
        return mp_layers.vocab_parallel_embedding(ids, self.weight,
                                                  self.group)
