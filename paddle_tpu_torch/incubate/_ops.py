"""``paddle.incubate``'s top-level ops (``paddle_tpu/incubate/_ops.py``):
the masked softmaxes, ``identity_loss``, and the graph and segment ops,
which forward to :mod:`..geometric`, as in the JAX package.

The softmaxes are plain torch (the JAX package's are ``jnp``
expressions, no Pallas kernel): the logits in f32, the result in the
input's dtype. ``graph_khop_sampler`` expands hop by hop on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..autograd.engine import apply_op
from ..ops._apply import ensure_tensor
from ..tensor import Tensor

__all__ = [
    "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
    "graph_send_recv", "graph_khop_sampler", "graph_sample_neighbors",
    "graph_reindex", "segment_sum", "segment_mean", "segment_max",
    "segment_min", "identity_loss",
]


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis."""
    return apply_op(
        lambda v, m: torch.softmax(v.float() + m.float(), dim=-1).to(v.dtype),
        [ensure_tensor(x), ensure_tensor(mask)], name="softmax_mask_fuse")


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Softmax with the entries above the diagonal masked out (-1e30)."""
    def fn(v):
        causal = torch.ones((v.shape[-2], v.shape[-1]), dtype=torch.bool,
                            device=v.device).tril()
        logits = torch.where(causal, v.float(), -1e30)
        return torch.softmax(logits, dim=-1).to(v.dtype)

    return apply_op(fn, [ensure_tensor(x)],
                    name="softmax_mask_fuse_upper_triangle")


def identity_loss(x, reduction="none"):
    """A tensor marked as a loss: its sum (0, "sum"), mean (1, "mean") or
    itself (2, "none")."""
    t = ensure_tensor(x)
    if reduction in (0, "sum"):
        return t.sum()
    if reduction in (1, "mean"):
        return t.mean()
    if reduction in (2, "none"):
        return t
    raise ValueError(f"bad reduction {reduction!r}")


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    from ..geometric import send_u_recv

    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)


def graph_reindex(x, neighbors, count, value_buffer=None, index_buffer=None,
                  flag_buffer_hashtable=False, name=None):
    from ..geometric import reindex_graph

    return reindex_graph(x, neighbors, count, value_buffer, index_buffer)


def graph_sample_neighbors(row, colptr, input_nodes, eids=None,
                           perm_buffer=None, sample_size=-1,
                           return_eids=False, flag_perm_buffer=False,
                           name=None):
    from ..geometric import sample_neighbors

    return sample_neighbors(row, colptr, input_nodes,
                            sample_size=sample_size, eids=eids,
                            return_eids=return_eids)


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """Multi-hop neighbour sampling (reference:
    incubate/operators/graph_khop_sampler.py:109): ``(edge_src, edge_dst,
    sample_index, reindex_nodes)``, the sampled edges in local ids, the
    unique original ids (input nodes first) and the input nodes' local
    positions. Each hop expands from the nodes new to it."""
    from ..geometric import sample_neighbors

    if return_eids:
        raise NotImplementedError(
            "graph_khop_sampler(return_eids=True): edge-id tracking is not "
            "implemented; sample without eids")
    dev = ensure_tensor(row)._value.device

    def host(t):
        return np.asarray(ensure_tensor(t).numpy()).astype(np.int64)

    nodes = host(input_nodes)
    srcs, dsts = [], []
    frontier = nodes
    for size in sample_sizes:
        neigh_t, counts_t = sample_neighbors(
            row, colptr, Tensor(torch.from_numpy(frontier)), sample_size=size)
        neigh, counts = host(neigh_t), host(counts_t)
        srcs.append(neigh)
        dsts.append(np.repeat(frontier, counts))
        frontier = np.setdiff1d(np.unique(neigh),
                                np.concatenate([nodes, *srcs[:-1]])
                                if srcs[:-1] else nodes)
        if frontier.size == 0:
            break
    edge_src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    edge_dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    rest = np.setdiff1d(np.unique(np.concatenate([edge_src, edge_dst]))
                        if edge_src.size else nodes, nodes)
    sample_index = np.concatenate([nodes, rest])
    lookup = {int(g): i for i, g in enumerate(sample_index)}
    edge_src_l = np.asarray([lookup[int(g)] for g in edge_src], np.int64)
    edge_dst_l = np.asarray([lookup[int(g)] for g in edge_dst], np.int64)
    return tuple(Tensor(torch.from_numpy(a).to(dev)) for a in (
        edge_src_l, edge_dst_l, sample_index,
        np.arange(nodes.size, dtype=np.int64)))


def segment_sum(data, segment_ids, name=None):
    from ..geometric import segment_sum as _f

    return _f(data, segment_ids)


def segment_mean(data, segment_ids, name=None):
    from ..geometric import segment_mean as _f

    return _f(data, segment_ids)


def segment_max(data, segment_ids, name=None):
    from ..geometric import segment_max as _f

    return _f(data, segment_ids)


def segment_min(data, segment_ids, name=None):
    from ..geometric import segment_min as _f

    return _f(data, segment_ids)
