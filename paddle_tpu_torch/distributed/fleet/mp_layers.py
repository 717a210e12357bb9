"""Tensor-parallel (model-parallel) layers
(``paddle_tpu/distributed/fleet/mp_layers.py``).

The JAX layers hold the whole weight under a GSPMD sharding over the
``mp`` mesh axis and let XLA insert the collectives. The port's are
written Megatron-style, one process per rank: each rank holds its shard
of the weight, and the communication is ``torch.autograd.Function``s
over the mesh's ``mp`` group:

- ``c_identity``: identity forward, all-reduce of the gradient backward
  (the input of a column-parallel layer);
- ``mp_allreduce``: all-reduce forward, identity backward (the output of
  a row-parallel layer, of the vocab-parallel lookup);
- ``c_concat``/``c_split``: gather the last dim forward and take this
  rank's block of the gradient backward, and the reverse.

``VocabParallelEmbedding`` holds rows ``[r V/mp, (r+1) V/mp)``, masks the
ids outside them and all-reduces the lookups; ``ParallelCrossEntropy``
takes class-sharded logits and all-reduces their max, their sum of
exponentials and the target logit over ``mp``, in f32, with the softmax
minus the one-hot as its gradient.

The Paddle layers here (weights ``[in, out]``, Paddle's layout) are
built on the same functions as the ``torch.nn`` ones the port's GPT and
Llama use (``models/_modules.py``).
"""
from __future__ import annotations

import torch

from ...nn import functional as F
from ...nn.layer_base import Layer
from ...tensor import facade_io
from .. import collective, topology

__all__ = [
    "VocabParallelEmbedding", "ColumnParallelLinear", "RowParallelLinear",
    "ParallelCrossEntropy", "c_identity", "mp_allreduce", "c_concat",
    "c_split", "vocab_parallel_embedding", "parallel_cross_entropy",
    "get_mp_group",
]


def get_mp_group():
    """This rank's ``mp`` group of the current mesh (this rank alone when
    the mesh has no ``mp`` axis)."""
    m = topology.get_mesh()
    if m is None:
        raise RuntimeError("tensor-parallel layers need a mesh: fleet.init first")
    if "mp" not in m.axis_names:
        return topology.Group([topology._this_rank()], None, axis="mp")
    return m.group("mp")


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    collective.all_reduce(out, group=group)
    return out


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    parts = []
    collective.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _my_block(x: torch.Tensor, group) -> torch.Tensor:
    n = x.shape[-1] // group.nranks
    return x.narrow(-1, group.rank * n, n).contiguous()


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _MpAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _my_block(g, ctx.group), None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _my_block(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def c_identity(x, group):
    return x if group.nranks == 1 else _CIdentity.apply(x, group)


def mp_allreduce(x, group):
    return x if group.nranks == 1 else _MpAllReduce.apply(x, group)


def c_concat(x, group):
    return x if group.nranks == 1 else _CConcat.apply(x, group)


def c_split(x, group):
    return x if group.nranks == 1 else _CSplit.apply(x, group)


def vocab_parallel_embedding(ids, weight, group):
    """Rows of this rank's vocab shard ``weight`` ``[V/mp, H]``, zeros for
    ids outside it, all-reduced over ``group``."""
    if group.nranks == 1:
        return F.embedding(ids, weight)
    v_local = weight.shape[0]
    start = group.rank * v_local
    local = ids.to(torch.int64) - start
    outside = (local < 0) | (local >= v_local)
    out = F.embedding(local.masked_fill(outside, 0), weight)
    out = out.masked_fill(outside.unsqueeze(-1), 0.0)
    return mp_allreduce(out, group)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group, ignore_index):
        x = logits.float()
        v_local = x.shape[-1]
        start = group.rank * v_local
        lab = labels.to(torch.int64)
        m = x.max(dim=-1).values
        collective.all_reduce(m, op=collective.ReduceOp.MAX, group=group)
        x = x - m.unsqueeze(-1)
        local = lab - start
        outside = (local < 0) | (local >= v_local)
        safe = local.masked_fill(outside, 0)
        picked = x.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
        picked = picked.masked_fill(outside, 0.0)
        collective.all_reduce(picked, group=group)
        e = x.exp()
        sumexp = e.sum(dim=-1)
        collective.all_reduce(sumexp, group=group)
        loss = torch.log(sumexp) - picked
        ignored = lab == ignore_index
        loss = loss.masked_fill(ignored, 0.0)
        ctx.save_for_backward(e, sumexp, safe, outside, ignored)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, sumexp, safe, outside, ignored = ctx.saved_tensors
        grad = e / sumexp.unsqueeze(-1)
        hit = (~outside).to(grad.dtype).unsqueeze(-1)
        grad.scatter_add_(-1, safe.unsqueeze(-1), -hit)
        scale = g.float().masked_fill(ignored, 0.0).unsqueeze(-1)
        return (grad * scale).to(ctx.dtype), None, None, None


def parallel_cross_entropy(logits, labels, group, ignore_index: int = -100):
    """Per-row cross entropy (f32) of class-sharded ``logits``
    ``[..., V/mp]`` against global ``labels`` ``[...]``; rows whose label
    is ``ignore_index`` give 0."""
    return _VocabParallelCE.apply(logits, labels, group, ignore_index)


def _mp_size_check(n: int, what: str, group) -> int:
    if n % group.nranks:
        raise ValueError(f"{what} {n} not divisible by mp degree "
                         f"{group.nranks}")
    return n // group.nranks


class VocabParallelEmbedding(Layer):
    """reference: mp_layers.py:35. This rank's rows ``[V/mp, H]`` of the
    vocabulary (module docstring)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None):
        super().__init__()
        from ...nn import initializer as I

        self._group = mp_group or get_mp_group()
        v_local = _mp_size_check(num_embeddings, "vocab size", self._group)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.vocab_start_index = self._group.rank * v_local
        self.weight = self.create_parameter(
            [v_local, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal())

    @facade_io
    def _lookup(self, ids, w):
        return vocab_parallel_embedding(ids, w, self._group)

    def forward(self, x):
        return self._lookup(x, self.weight)


class ColumnParallelLinear(Layer):
    """reference: mp_layers.py:173. This rank's output columns ``[in,
    out/mp]`` (and bias ``[out/mp]``); ``gather_output`` concatenates the
    blocks, else the output stays this rank's block for a following
    ``RowParallelLinear``."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None):
        super().__init__()
        self._group = mp_group or get_mp_group()
        out_local = _mp_size_check(out_features, "out_features", self._group)
        self._in_features, self._out_features = in_features, out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter([in_features, out_local],
                                            attr=weight_attr)
        self.bias = (self.create_parameter([out_local], is_bias=True)
                     if has_bias else None)

    @facade_io
    def _apply(self, x, w, b):
        y = F.linear(c_identity(x, self._group), w, b)
        return c_concat(y, self._group) if self.gather_output else y

    def forward(self, x):
        return self._apply(x, self.weight, self.bias)


class RowParallelLinear(Layer):
    """reference: mp_layers.py:343. This rank's input rows ``[in/mp,
    out]``, the bias whole; ``input_is_parallel`` takes ``x`` as this
    rank's block of the last dim already (a non-gathering
    ``ColumnParallelLinear``'s output), else it is split here. The
    partial products are all-reduced, then the bias is added."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None):
        super().__init__()
        self._group = mp_group or get_mp_group()
        in_local = _mp_size_check(in_features, "in_features", self._group)
        self._in_features, self._out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter([in_local, out_features],
                                            attr=weight_attr)
        self.bias = (self.create_parameter([out_features], is_bias=True)
                     if has_bias else None)

    @facade_io
    def _apply(self, x, w, b):
        if not self.input_is_parallel:
            x = c_split(x, self._group)
        y = mp_allreduce(F.linear(x, w), self._group)
        return y if b is None else y + b

    def forward(self, x):
        return self._apply(x, self.weight, self.bias)


class ParallelCrossEntropy(Layer):
    """reference: mp_layers.py:524: softmax cross entropy over
    class-sharded logits (:func:`parallel_cross_entropy`), one loss per
    row with a trailing dim of 1, as the JAX layer gives."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self._group = mp_group or get_mp_group()
        self._ignore_index = ignore_index

    @facade_io
    def _apply(self, logits, label):
        lab = label[..., 0] if label.dim() == logits.dim() else label
        return parallel_cross_entropy(logits, lab, self._group,
                                      self._ignore_index).unsqueeze(-1)

    def forward(self, input, label):
        return self._apply(input, label)
