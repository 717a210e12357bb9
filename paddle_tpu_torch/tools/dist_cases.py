"""The collectives' cases, run on every rank of a job, and their expected
values (numpy only, beside the port).

Each case takes this rank's input (:func:`rank_input`, from a seed per
rank) and returns what the collective left on this rank as numpy;
:func:`expected` works the same value out from every rank's input. The
CPU tests run them on a gloo world and hold them against the JAX
package's collectives in ``shard_map``; the card's two-rank drill
(``tools/dist_drills.py``) runs them on CUDA tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

__all__ = ["CASES", "rank_input", "expected", "run_cases"]

ROWS = 4  # rows a rank, times the world size


def rank_input(case: str, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s ``[ROWS * world, 3]`` f32 input of ``case``."""
    rng = np.random.default_rng(1000 + 17 * rank)
    x = rng.standard_normal((ROWS * world, 3)).astype(np.float32)
    return (1.0 + 0.1 * x).astype(np.float32) if case.endswith("prod") else x


def _t(x, dev):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _np(t):
    v = getattr(t, "_value", t)
    return v.detach().float().cpu().numpy()


def _reduce(op):
    def case(dist, x, rank, world, dev):
        t = _t(x, dev)
        dist.all_reduce(t, op=op)
        return _np(t)
    return case


def _all_reduce_bf16(dist, x, rank, world, dev):
    import torch

    t = _t(x, dev).to(torch.bfloat16)
    dist.all_reduce(t)
    return _np(t)


def _all_gather_list(dist, x, rank, world, dev):
    out = []
    dist.all_gather(out, _t(x, dev))
    return np.stack([_np(o) for o in out])


def _all_gather_axis1(dist, x, rank, world, dev):
    return _np(dist.all_gather(None, _t(x, dev), axis_dim=1))


def _all_gather_object(dist, x, rank, world, dev):
    out = []
    dist.all_gather_object(out, {"rank": rank, "first": float(x[0, 0])})
    return out


def _broadcast(dist, x, rank, world, dev):
    t = _t(x, dev)
    dist.broadcast(t, src=1)
    return _np(t)


def _reduce_dst0(dist, x, rank, world, dev):
    t = _t(x, dev)
    dist.reduce(t, dst=0)
    return _np(t) if rank == 0 else None


def _scatter_list(dist, x, rank, world, dev):
    import torch

    out = torch.zeros((ROWS, 3), device=dev)
    parts = [_t(p, dev) for p in np.split(x, world)] if rank == 0 else None
    dist.scatter(out, parts, src=0)
    return _np(out)


def _alltoall(dist, x, rank, world, dev):
    return _np(dist.alltoall(_t(x, dev)))


def _alltoall_list(dist, x, rank, world, dev):
    out = []
    dist.alltoall([_t(p, dev) for p in np.split(x, world)], out)
    return np.concatenate([_np(o) for o in out])


def _alltoall_single(dist, x, rank, world, dev):
    import torch

    out = torch.zeros((ROWS * world, 3), device=dev)
    dist.alltoall_single(_t(x, dev), out)
    return _np(out)


def _reduce_scatter(op):
    def case(dist, x, rank, world, dev):
        return _np(dist.reduce_scatter(_t(x, dev), op=op))
    return case


def _reduce_scatter_list(dist, x, rank, world, dev):
    import torch

    out = torch.zeros((ROWS, 3), device=dev)
    dist.reduce_scatter(out, [_t(p, dev) for p in np.split(x, world)])
    return _np(out)


def _gather(dist, x, rank, world, dev):
    return _np(dist.gather(_t(x, dev), dst=0))


def _ring_shift(dist, x, rank, world, dev):
    t = _t(x, dev)
    ops = [dist.P2POp(dist.isend, t, 1), dist.P2POp(dist.irecv, t, -1)]
    (out,) = dist.batch_isend_irecv(ops)
    return _np(out)


def _lone_isend(dist, x, rank, world, dev):
    try:
        dist.isend(_t(x, dev), (rank + 1) % world)
    except RuntimeError as e:
        return str(e)
    return None


def _stream_all_reduce(dist, x, rank, world, dev):
    t = _t(x, dev)
    dist.communication.stream.all_reduce(t, use_calc_stream=True)
    return _np(t)


def _broadcast_object_list(dist, x, rank, world, dev):
    objs = [f"from {rank}", rank]
    dist.broadcast_object_list(objs, src=0)
    return objs


def _scatter_object_list(dist, x, rank, world, dev):
    out = []
    dist.scatter_object_list(out, [f"o{i}" for i in range(world)]
                             if rank == 0 else None, src=0)
    return out


def _barrier(dist, x, rank, world, dev):
    dist.barrier()
    return 1


CASES: Dict[str, Callable] = {
    "all_reduce_sum": _reduce("sum"), "all_reduce_max": _reduce("max"),
    "all_reduce_min": _reduce("min"), "all_reduce_prod": _reduce("prod"),
    "all_reduce_avg": _reduce("avg"), "all_reduce_bf16": _all_reduce_bf16,
    "all_gather_list": _all_gather_list,
    "all_gather_axis1": _all_gather_axis1,
    "all_gather_object": _all_gather_object, "broadcast": _broadcast,
    "reduce": _reduce_dst0, "scatter_list": _scatter_list,
    "alltoall": _alltoall,
    "alltoall_list": _alltoall_list, "alltoall_single": _alltoall_single,
    "reduce_scatter_sum": _reduce_scatter("sum"),
    "reduce_scatter_avg": _reduce_scatter("avg"),
    "reduce_scatter_list": _reduce_scatter_list, "gather": _gather,
    "batch_isend_irecv": _ring_shift, "lone_isend": _lone_isend,
    "stream_all_reduce": _stream_all_reduce,
    "broadcast_object_list": _broadcast_object_list,
    "scatter_object_list": _scatter_object_list, "barrier": _barrier,
}


def expected(case: str, xs: List[np.ndarray], rank: int):
    """What ``case`` leaves on ``rank``, from every rank's input ``xs``."""
    world = len(xs)
    a = np.stack(xs)
    blocks = [np.split(x, world) for x in xs]
    if case in ("all_reduce_sum", "stream_all_reduce"):
        return a.sum(0)
    if case == "all_reduce_bf16":
        return a.sum(0)
    if case == "all_reduce_max":
        return a.max(0)
    if case == "all_reduce_min":
        return a.min(0)
    if case == "all_reduce_prod":
        return a.prod(0)
    if case == "all_reduce_avg":
        return a.mean(0)
    if case in ("all_gather_list", "gather"):
        return a
    if case == "all_gather_axis1":
        return np.stack(xs, axis=1)
    if case == "all_gather_object":
        return [{"rank": r, "first": float(x[0, 0])} for r, x in enumerate(xs)]
    if case == "broadcast":
        return xs[1]
    if case == "reduce":
        return a.sum(0) if rank == 0 else None
    if case == "scatter_list":
        return blocks[0][rank]
    if case in ("alltoall", "alltoall_list", "alltoall_single"):
        return np.concatenate([blocks[j][rank] for j in range(world)])
    if case == "reduce_scatter_sum":
        return a.sum(0)[rank * ROWS:(rank + 1) * ROWS]
    if case == "reduce_scatter_avg":
        return a.mean(0)[rank * ROWS:(rank + 1) * ROWS]
    if case == "reduce_scatter_list":
        return a.sum(0)[rank * ROWS:(rank + 1) * ROWS]
    if case == "batch_isend_irecv":
        return xs[(rank - 1) % world]
    if case == "lone_isend":
        return "batch_isend_irecv"  # the message names it
    if case == "broadcast_object_list":
        return ["from 0", 0]
    if case == "scatter_object_list":
        return [f"o{rank}"]
    if case == "barrier":
        return 1
    raise KeyError(case)


def held(case: str, got, want, tol: float = 1e-6) -> bool:
    """Whether ``got`` is ``want`` (bf16 sums at 2e-2)."""
    if want is None:
        return got is None
    if isinstance(want, str):
        return isinstance(got, str) and want in got
    if isinstance(want, (list, int)):
        return got == want
    tol = 2e-2 if case.endswith("bf16") else tol
    return got is not None and np.shape(got) == np.shape(want) and \
        np.allclose(got, want, rtol=tol, atol=tol)


def run_cases(device: str = "cpu", cases=None) -> Dict[str, object]:
    """Every case (or ``cases``) on this rank, after ``init_parallel_env``:
    ``{case: result}``."""
    import paddle_tpu_torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    return {name: CASES[name](dist, rank_input(name, rank, world), rank,
                              world, device)
            for name in (cases or CASES)}
