"""``paddle.geometric`` of the port (``paddle_tpu/geometric/__init__.py``):
graph message passing and segment math.

- ``segment_sum/mean/min/max`` reduce rows into ``max(segment_ids) + 1``
  segments (read on the host, as the JAX package reads it); an empty
  segment gives 0, as the reference kernels do. Sums are ``index_add``
  (atomic on the card, so their order is not fixed there); min and max
  are ``scatter_reduce`` from the reduction's identity, whose gradient
  is split evenly among tied rows, as ``jax.ops.segment_max``'s is.
- ``send_u_recv``/``send_ue_recv`` gather ``x[src]`` (combined with edge
  features), then reduce into ``out_size`` destination rows (default
  ``x``'s rows); an edge whose destination lies past ``out_size`` is
  dropped, as JAX's scatter drops it. ``send_uv`` combines ``x[src]``
  and ``y[dst]`` per edge, with no reduction.
- ``reindex_graph``/``reindex_heter_graph`` and the samplers run on the
  host (numpy), as there. The samplers draw their numpy stream's seed
  from the port's global generator (``generator.next_seed``), so a draw
  is the same under the same ``paddle.seed`` but is not the JAX
  package's draw; ``sample_size=-1`` (every neighbour) is. Their
  outputs lie on the input's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..autograd.engine import apply_op
from ..generator import next_seed
from ..ops._apply import ensure_tensor
from ..tensor import Tensor

__all__ = [
    "send_u_recv", "send_ue_recv", "send_uv",
    "segment_sum", "segment_mean", "segment_min", "segment_max",
    "reindex_graph", "sample_neighbors",
    "weighted_sample_neighbors", "reindex_heter_graph",
]

_COMBINE = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
            "div": torch.div}


def _segment(kind: str, d: torch.Tensor, seg: torch.Tensor,
             n: int) -> torch.Tensor:
    """Rows of ``d`` reduced by ``seg`` (int64, every id in [0, n)) into
    ``n`` segments; empty segments 0."""
    out = d.new_zeros((n,) + tuple(d.shape[1:]))
    if kind in ("sum", "mean"):
        s = out.index_add(0, seg, d)
        if kind == "sum":
            return s
        cnt = d.new_zeros((n,)).index_add(
            0, seg, torch.ones(seg.shape, dtype=d.dtype, device=d.device))
        return s / torch.clamp_min(cnt, 1).reshape((n,) + (1,) * (d.dim() - 1))
    if kind not in ("min", "max"):
        raise ValueError(f"reduce op {kind!r} (sum, mean, min or max)")
    # start from the reduction's identity, not 0: torch's backward counts
    # a start value equal to the result as a tie even without
    # include_self, which would halve a gradient at a result of 0
    if d.is_floating_point():
        start = float("-inf") if kind == "max" else float("inf")
    else:
        info = torch.iinfo(d.dtype)
        start = info.min if kind == "max" else info.max
    index = seg.reshape((-1,) + (1,) * (d.dim() - 1)).expand(d.shape)
    red = out.fill_(start).scatter_reduce(
        0, index, d, "amax" if kind == "max" else "amin", include_self=False)
    cnt = torch.zeros((n,), dtype=torch.int64, device=d.device).index_add(
        0, seg, torch.ones_like(seg))
    seen = (cnt > 0).reshape((n,) + (1,) * (d.dim() - 1))
    return torch.where(seen, red, torch.zeros((), dtype=d.dtype,
                                              device=d.device))


def _ids(t) -> torch.Tensor:
    return ensure_tensor(t)._value.detach().to(torch.int64)


def _segment_entry(kind, data, segment_ids):
    d = ensure_tensor(data)
    seg = _ids(segment_ids).to(d._value.device)
    n = int(seg.max()) + 1 if seg.numel() else 0
    return apply_op(lambda v: _segment(kind, v, seg, n), [d],
                    name=f"segment_{kind}")


def segment_sum(data, segment_ids, name=None):
    """reference: geometric/math.py:23."""
    return _segment_entry("sum", data, segment_ids)


def segment_mean(data, segment_ids, name=None):
    return _segment_entry("mean", data, segment_ids)


def segment_min(data, segment_ids, name=None):
    return _segment_entry("min", data, segment_ids)


def segment_max(data, segment_ids, name=None):
    return _segment_entry("max", data, segment_ids)


def _edges(src_index, dst_index, n: int, device):
    """Source and destination ids on ``device`` without the edges whose
    destination lies past ``n``, and the keep mask (None when every edge
    stays)."""
    src, dst = _ids(src_index).to(device), _ids(dst_index).to(device)
    keep = dst < n
    if bool(keep.all()):
        return src, dst, None
    return src[keep], dst[keep], keep


def send_u_recv(x, src_index, dst_index, reduce_op="sum",
                out_size: Optional[int] = None, name=None):
    """reference: send_recv.py:35 -- gather x[src], reduce into dst rows."""
    xt = ensure_tensor(x)
    n = int(out_size) if out_size is not None else int(xt.shape[0])
    src, dst, _ = _edges(src_index, dst_index, n, xt._value.device)
    return apply_op(lambda v: _segment(reduce_op, v[src], dst, n), [xt],
                    name=f"send_u_recv_{reduce_op}")


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size: Optional[int] = None, name=None):
    """reference: send_recv.py:178 -- combine x[src] with the edge
    features y (add, sub, mul, div), reduce into dst rows."""
    xt, yt = ensure_tensor(x), ensure_tensor(y)
    n = int(out_size) if out_size is not None else int(xt.shape[0])
    src, dst, keep = _edges(src_index, dst_index, n, xt._value.device)
    combine = _COMBINE[message_op]

    def fn(xv, yv):
        if keep is not None and yv.dim() and yv.shape[0] == keep.numel():
            yv = yv[keep.to(yv.device)]
        return _segment(reduce_op, combine(xv[src], yv), dst, n)

    return apply_op(fn, [xt, yt], name=f"send_ue_recv_{message_op}")


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """reference: send_recv.py send_uv -- combine(x[src], y[dst]) per
    edge, with no reduction."""
    xt, yt = ensure_tensor(x), ensure_tensor(y)
    src = _ids(src_index).to(xt._value.device)
    dst = _ids(dst_index).to(yt._value.device)
    combine = _COMBINE[message_op]
    return apply_op(lambda xv, yv: combine(xv[src], yv[dst]), [xt, yt],
                    name=f"send_uv_{message_op}")


def _host(t) -> np.ndarray:
    return np.asarray(ensure_tensor(t).numpy()).astype("int64")


def _out(arr, device, dtype="int64") -> Tensor:
    return Tensor(torch.from_numpy(np.ascontiguousarray(
        np.asarray(arr, dtype))).to(device))


def _device(t):
    return ensure_tensor(t)._value.device


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """reference: reindex.py reindex_graph -- global ids to local ones:
    the centre nodes ``x`` first, then the neighbours in first-seen
    order. Returns ``(reindexed neighbours, reindexed dst, out_nodes)``."""
    dev = _device(x)
    xv, nb = _host(x), _host(neighbors)
    cnt = _host(count)
    mapping = {int(v): i for i, v in enumerate(xv)}
    out_nodes = list(xv)
    reindexed = np.empty_like(nb)
    for i, v in enumerate(nb):
        key = int(v)
        if key not in mapping:
            mapping[key] = len(out_nodes)
            out_nodes.append(key)
        reindexed[i] = mapping[key]
    dst = np.repeat(np.arange(len(xv), dtype="int64"), cnt)
    return _out(reindexed, dev), _out(dst, dev), _out(out_nodes, dev)


def _sample(rowv, ptr, nodes, sample_size, eidv, return_eids, weights=None):
    rng = np.random.default_rng(next_seed())
    out_neighbors, out_count, out_eids = [], [], []
    for nd in nodes:
        pos = np.arange(int(ptr[nd]), int(ptr[nd + 1]))
        if sample_size > 0 and len(pos) > sample_size:
            if weights is None:
                pos = rng.choice(pos, size=sample_size, replace=False)
            else:
                w = np.maximum(weights[pos], 1e-12)
                pos = rng.choice(pos, size=sample_size, replace=False,
                                 p=w / w.sum())
        out_neighbors.append(rowv[pos])
        out_count.append(len(pos))
        if return_eids:
            out_eids.append(eidv[pos])
    flat = (np.concatenate(out_neighbors) if out_neighbors
            else np.empty((0,), "int64"))
    eids_flat = ((np.concatenate(out_eids) if out_eids
                  else np.empty((0,), "int64")) if return_eids else None)
    return flat, np.asarray(out_count), eids_flat


def sample_neighbors(row, colptr, input_nodes, sample_size: int = -1,
                     eids=None, return_eids: bool = False, perm_buffer=None,
                     name=None):
    """reference: sampling/neighbors.py sample_neighbors -- over a CSC
    graph ``(row, colptr)``, up to ``sample_size`` neighbours of each
    input node without replacement (all of them at -1); with
    ``return_eids`` also the sampled edges' ids. Counts are int32."""
    if return_eids and eids is None:
        raise ValueError("return_eids=True requires eids")
    dev = _device(row)
    flat, cnt, fe = _sample(_host(row), _host(colptr), _host(input_nodes),
                            sample_size,
                            None if eids is None else _host(eids),
                            return_eids)
    result = (_out(flat, dev), _out(cnt, dev, "int32"))
    return result + (_out(fe, dev),) if return_eids else result


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size: int = -1, eids=None,
                              return_eids: bool = False, name=None):
    """reference: sampling/neighbors.py weighted_sample_neighbors --
    neighbours drawn without replacement with probability proportional
    to the edge weight. Counts are int64."""
    if return_eids and eids is None:
        raise ValueError("return_eids=True requires eids")
    dev = _device(row)
    weights = np.asarray(ensure_tensor(edge_weight).numpy()).astype(
        "float64")
    flat, cnt, fe = _sample(_host(row), _host(colptr), _host(input_nodes),
                            sample_size,
                            None if eids is None else _host(eids),
                            return_eids, weights)
    outs = (_out(flat, dev), _out(cnt, dev))
    return outs + (_out(fe, dev),) if return_eids else outs


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """reference: reindex.py reindex_heter_graph -- :func:`reindex_graph`
    over per-edge-type neighbour and count lists sharing one id space.
    Returns ``(per-type reindexed neighbours, per-type dst, out_nodes)``."""
    dev = _device(x)
    xv = _host(x)
    mapping = {int(v): i for i, v in enumerate(xv)}
    out_nodes = list(xv)
    srcs = []
    for nb in neighbors:
        nbv = _host(nb)
        local = np.empty(len(nbv), "int64")
        for i, g in enumerate(nbv):
            gi = int(g)
            if gi not in mapping:
                mapping[gi] = len(out_nodes)
                out_nodes.append(gi)
            local[i] = mapping[gi]
        srcs.append(_out(local, dev))
    dsts = [_out(np.repeat(np.arange(len(xv), dtype="int64"), _host(c)), dev)
            for c in count]
    return srcs, dsts, _out(out_nodes, dev)
