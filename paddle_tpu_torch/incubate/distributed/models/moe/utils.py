"""MoE routing utilities
(``paddle_tpu/incubate/distributed/models/moe/utils.py``).

The JAX package computes them as static-shape programs: an entry's
position in its expert is a one-hot cumsum over the flattened top-k
indices (token-major), and entries at or past the capacity are marked
-1. Its single program sees every token. The port's ranks of an
expert-parallel group each see their own tokens, which are, in rank
order, the JAX program's token order; so with ``group`` (more than one
rank) an entry's position also counts the entries of the lower ranks
for its expert (the exclusive prefix of the all-gathered per-expert
counts), and capacity limits the global arrival order, as the JAX
package's gate does on the whole batch. Without a group the functions
are the JAX package's.

Expert-parallel collectives in the MoE code follow the data-parallel
reducer's convention (each rank's loss is its own, the replicated
weights' gradients averaged): ``all_reduce_autograd``'s backward is the
same reduction of the gradient.
"""
from __future__ import annotations

import torch

from .....distributed import collective
from .....tensor import Tensor, facade_io

__all__ = ["limit_by_capacity", "count_by_gate", "_random_routing",
           "all_reduce_autograd"]


def _positions_in_expert(flat: torch.Tensor, tot_expert: int, group=None):
    """``flat`` ``[N]`` int (-1 = dropped) -> ``(pos [N], one_hot [N, E]
    int64)``: each entry's 0-based arrival order in its expert, counting
    the lower ranks' entries of ``group`` first."""
    valid = flat >= 0
    safe = flat.clamp(0, tot_expert - 1)
    oh = torch.where(valid[:, None],
                     torch.nn.functional.one_hot(safe, tot_expert), 0)
    cum = oh.cumsum(0) + _lower_ranks(oh.sum(0), group)[None, :]
    pos = cum.gather(1, safe[:, None])[:, 0] - 1
    return torch.where(valid, pos, -1), oh


def _lower_ranks(counts: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``counts`` over the ranks of ``group`` before this one
    (zeros without a group of several ranks)."""
    if group is None or group.nranks <= 1:
        return torch.zeros_like(counts)
    every = collective.all_gather(None, counts, group=group)
    return every[:group.rank].sum(0)


def _summed(counts: torch.Tensor, group) -> torch.Tensor:
    if group is None or group.nranks <= 1:
        return counts
    counts = counts.clone()
    collective.all_reduce(counts, group=group)
    return counts


@facade_io
def limit_by_capacity(topk_idx, num_expert, world_size, capacity,
                      group=None):
    """reference: moe/utils.py:74: the entries routed beyond each expert's
    ``capacity`` marked -1. Returns ``(local_expert_count,
    global_expert_count, new_topk_idx)``: the kept entries per expert on
    this rank and over ``group`` (the same without one, as the JAX
    package's single program returns them)."""
    tot = num_expert * world_size
    idx = topk_idx.detach()
    flat = idx.reshape(-1).to(torch.int64)
    pos, oh = _positions_in_expert(flat, tot, group)
    keep = (flat >= 0) & (pos < capacity)
    new = torch.where(keep, flat, -1).to(idx.dtype).reshape(idx.shape)
    counts = torch.where(keep[:, None], oh, 0).sum(0)
    return counts, _summed(counts, group), new


@facade_io
def count_by_gate(gate_idx, num_expert, world_size, require_pos=True,
                  group=None):
    """reference: moe/utils.py count_by_gate: each entry's position in its
    expert and the counts per expert (this rank's and over ``group``)."""
    tot = num_expert * world_size
    flat = gate_idx.detach().reshape(-1).to(torch.int64)
    pos, oh = _positions_in_expert(flat, tot, group)
    counts = oh.sum(0)
    return pos, counts, _summed(counts, group)


@facade_io
def _random_routing(topk_idx, topk_value, prob, topk=2):
    """reference: distributed/models/moe/utils.py:109: the second expert
    dropped (-1) where ``2 * value_2 < prob``."""
    if topk != 2:
        raise RuntimeError("only topk=2 is supported now")
    idx = topk_idx.detach()
    drop = (2.0 * topk_value.detach()[:, 1]) < prob.detach()
    second = torch.where(drop, torch.full_like(idx[:, 1], -1), idx[:, 1])
    return torch.stack([idx[:, 0], second], dim=1)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group):
        ctx.args = (op, group)
        out = x.contiguous().clone()
        collective.all_reduce(out, op=op, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        op, group = ctx.args
        g = g.contiguous().clone()
        collective.all_reduce(g, op=op, group=group)
        return g, None, None


def all_reduce_autograd(x, group, op: str = "sum"):
    """``x`` all-reduced (SUM or AVG) over ``group``, its gradient reduced
    the same way (module docstring); ``x`` itself without a group of
    several ranks. Takes and returns a facade Tensor or a torch one."""
    if group is None or group.nranks <= 1:
        return x
    v = _AllReduce.apply(getattr(x, "_value", x), op, group)
    return Tensor._wrap(v) if isinstance(x, Tensor) else v
