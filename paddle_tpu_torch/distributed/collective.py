"""Collective communication (``paddle_tpu/distributed/collective.py``).

The JAX package runs one SPMD program over a mesh, so its collectives
lower to ``lax`` collectives inside a ``shard_map`` region and raise
outside one. The port runs one process per rank on ``torch.distributed``:
each collective acts on this rank's tensor, inside
``parallel.shard_map_fn`` or outside it, in place where the reference
writes its argument, on the port's ``Tensor`` and on ``torch.Tensor``
alike. ``group=None`` is every rank of the job.

What stays as in the JAX package: ``reduce_scatter`` takes SUM and AVG
only; ``gather`` gives every rank the stacked result; a lone ``isend``,
``irecv``, ``send`` or ``recv`` raises, and ``batch_isend_irecv`` takes
exactly one isend and one irecv whose peers are offsets along the group
(a permutation, one ``torch.distributed.batch_isend_irecv``).

gloo takes CUDA tensors in every collective here but point-to-point,
whose sends read the device pointer as host memory (torch 2.11: "writev:
Bad address"), so ``batch_isend_irecv`` alone stages a CUDA tensor through
a host copy on gloo. On gloo ``reduce_scatter`` is an ``all_reduce``
followed by this rank's slice; AVG is SUM divided by the group's size on
every backend but NCCL, which has it.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from . import topology
from .topology import Group

__all__ = [
    "ReduceOp", "new_group", "get_group", "all_reduce", "all_gather",
    "all_gather_object", "broadcast", "reduce", "scatter", "alltoall",
    "reduce_scatter", "gather", "P2POp", "batch_isend_irecv", "isend",
    "irecv", "barrier", "send", "recv", "wait", "split_axis",
]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_groups: dict = {}
_next_gid = [0]


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def new_group(ranks=None, backend=None, axis: Optional[str] = None,
              timeout=None) -> Group:
    """reference: paddle.distributed.new_group. ``axis`` names a mesh axis
    (this rank's group along it); ``ranks`` makes a process group over
    those global ranks (every rank must call it, as
    ``torch.distributed.new_group`` requires); with neither, the mesh's
    first axis, or every rank without a mesh. Ids count up from 0 in
    creation order, as the JAX package's do."""
    mesh = topology.get_mesh()
    if ranks is not None and axis is None:
        ranks = sorted(int(r) for r in ranks)
        pg = _dist().new_group(ranks, backend=backend) \
            if _initialized() else None
        g = Group(ranks, pg)
    elif mesh is not None:
        axis = axis or mesh.axis_names[0]
        base = mesh.group(axis)
        g = Group(base.ranks, base.process_group, axis=axis)
    elif axis is not None:
        raise RuntimeError(
            "no device mesh; call fleet.init or init_parallel_env first")
    else:
        g = topology.world_group()
    g.id = _next_gid[0]
    _next_gid[0] += 1
    _groups[g.id] = g
    return g


def get_group(gid: int) -> Optional[Group]:
    return _groups.get(gid)


def _resolve(group):
    """``(process group or None for the default one, size, trivial)``:
    trivial when the group is this rank alone and no process group need
    be asked."""
    world = topology.world_group().nranks
    if group is None:
        return None, world, not _initialized() and world == 1
    if group.process_group is not None:
        return group.process_group, group.nranks, False
    if group.nranks == world and _initialized():
        return None, world, False
    if group.nranks == 1:
        return None, 1, True
    raise RuntimeError(f"{group} has no process group: call "
                       "init_parallel_env (or fleet.init) first")


def _index(group) -> int:
    """This rank's index in ``group``."""
    if group is None:
        return _dist().get_rank() if _initialized() else 0
    return group.rank


def _global(group, index: int) -> int:
    return index if group is None else group.ranks[index]


def _staged(pg, t: torch.Tensor) -> bool:
    """A CUDA tensor sent point-to-point on a gloo group goes through a
    host copy (module docstring)."""
    return t.is_cuda and _dist().get_backend(pg) == "gloo"


def _torch_op(op):
    R = _dist().ReduceOp
    return {"sum": R.SUM, "max": R.MAX, "min": R.MIN, "prod": R.PRODUCT,
            "avg": R.AVG}[op]


def _unwrap(x):
    return getattr(x, "_value", x)


def _like(ref, value):
    """``value`` as a port Tensor when ``ref`` is one."""
    from ..tensor import Tensor

    return Tensor._wrap(value) if isinstance(ref, Tensor) else value


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    with torch.no_grad():
        dst.copy_(src)


def _all_reduce_into(x: torch.Tensor, op, pg, n: int) -> None:
    """All-reduce ``x`` (a detached tensor) in place on ``pg``."""
    dist = _dist()
    if op in (ReduceOp.AVG, "avg") and dist.get_backend(pg) != "nccl":
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=pg)
        x.div_(n)
    else:
        dist.all_reduce(x, op=_torch_op(op), group=pg)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """reference: communication/all_reduce.py. In place on this rank's
    tensor; returns it."""
    pg, n, trivial = _resolve(group)
    if not trivial:
        with torch.no_grad():
            _all_reduce_into(_unwrap(tensor).detach(), op, pg, n)
    return tensor


def _gather_list(x: torch.Tensor, pg, n: int):
    src = x.detach().contiguous()
    outs = [torch.empty_like(src) for _ in range(n)]
    _dist().all_gather(outs, src, group=pg)
    return outs


def all_gather(tensor_list, tensor, group=None, sync_op=True,
               axis_dim: int = 0):
    """reference: communication/all_gather.py. Every rank's tensor in
    rank order: appended to ``tensor_list`` when given (returns None),
    else stacked along a new dim ``axis_dim`` and returned."""
    x = _unwrap(tensor)
    pg, n, trivial = _resolve(group)
    outs = [x.detach().clone()] if trivial else _gather_list(x, pg, n)
    if tensor_list is not None:
        tensor_list.extend(_like(tensor, o) for o in outs)
        return None
    return _like(tensor, torch.stack(outs, dim=axis_dim))


def all_gather_object(object_list, obj, group=None):
    """reference: communication/all_gather.py all_gather_object: every
    rank's object, in rank order, appended to ``object_list``."""
    pg, n, trivial = _resolve(group)
    if trivial:
        object_list.append(obj)
        return None
    out = [None] * n
    _dist().all_gather_object(out, obj, group=pg)
    object_list.extend(out)
    return None


def broadcast(tensor, src: int = 0, group=None, sync_op=True):
    """reference: communication/broadcast.py: rank ``src``'s (a global
    rank) value into every rank's tensor, in place."""
    pg, _, trivial = _resolve(group)
    if trivial:
        return tensor
    with torch.no_grad():
        _dist().broadcast(_unwrap(tensor).detach(), src=int(src), group=pg)
    return tensor


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group=None, sync_op=True):
    """reference: communication/reduce.py: the reduction lands in rank
    ``dst``'s tensor (a global rank); other ranks' tensors are left as
    the backend leaves them."""
    pg, n, trivial = _resolve(group)
    if trivial:
        return tensor
    dist = _dist()
    x = _unwrap(tensor).detach()
    with torch.no_grad():
        avg = op in (ReduceOp.AVG, "avg")
        dist.reduce(x, dst=int(dst), op=dist.ReduceOp.SUM if avg
                    else _torch_op(op), group=pg)
        if avg and dist.get_rank() == int(dst):
            x.div_(n)
    return tensor


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op=True):
    """reference: communication/scatter.py: entry r of ``tensor_list``
    (read on rank ``src``, a global rank; None elsewhere) lands in rank
    r's ``tensor``, in place; returns ``tensor``. (The JAX package's
    form, every rank holding the stacked input and taking its slice, is
    this with ``src`` passing the stack's slices.)"""
    pg, n, trivial = _resolve(group)
    out = _unwrap(tensor).detach()
    is_src = _global(group, _index(group)) == int(src)
    parts = ([_unwrap(t).detach() for t in tensor_list]
             if is_src else None)
    if is_src and len(parts) != n:
        raise ValueError(f"scatter: tensor_list has {len(parts)} entries "
                         f"for a group of {n}")
    if trivial:
        _write(out, parts[0])
        return tensor
    send = [p.contiguous() for p in parts] if is_src else None
    with torch.no_grad():
        _dist().scatter(out, scatter_list=send, src=int(src), group=pg)
    return tensor


def _all_to_all(x: torch.Tensor, pg, n: int) -> torch.Tensor:
    """Equal-split all-to-all along dim 0."""
    src = x.detach().contiguous()
    out = torch.empty_like(src)
    _dist().all_to_all_single(out, src, group=pg)
    return out


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """reference: communication/all_to_all.py. A list of ``n`` tensors:
    entry r goes to rank r, and what rank r sent lands at ``out[r]``
    (``out_tensor_list`` extended, and the list returned). One tensor
    (the JAX package's form): split equally along dim 0, block r to rank
    r, the received blocks concatenated in rank order."""
    pg, n, trivial = _resolve(group)
    if isinstance(in_tensor_list, (list, tuple)):
        parts = [_unwrap(t).detach() for t in in_tensor_list]
        flat = torch.cat([p.reshape(1, -1) for p in parts])
        got = flat if trivial else _all_to_all(flat, pg, n)
        outs = [_like(in_tensor_list[0], g.reshape(parts[0].shape))
                for g in got.unbind(0)]
        if out_tensor_list is not None:
            out_tensor_list.extend(outs)
            return out_tensor_list
        return outs
    x = _unwrap(in_tensor_list)
    out = x.detach().clone() if trivial else _all_to_all(x, pg, n)
    return _like(in_tensor_list, out)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """reference: communication/reduce_scatter.py: reduce across the
    group, each rank keeping its block of dim 0. Paddle's list form
    passes per-destination chunks in ``tensor_list`` and the result
    lands in ``tensor`` (written in place and returned); else ``tensor``
    is the full input and the block is returned. SUM and AVG only."""
    if op not in (ReduceOp.SUM, "sum", ReduceOp.AVG, "avg"):
        raise ValueError("reduce_scatter supports SUM/AVG")
    if tensor_list is not None:
        src = torch.cat([_unwrap(c).detach() for c in tensor_list], dim=0)
    else:
        src = _unwrap(tensor).detach()
    pg, n, trivial = _resolve(group)
    me = _index(group)
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(src.shape)} "
                         f"does not split over {n} ranks")
    m = src.shape[0] // n
    dist = _dist()
    if trivial:
        out = src.clone()
    elif dist.get_backend(pg) == "nccl":
        out = torch.empty((m,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dist.reduce_scatter_tensor(out, src.contiguous(),
                                       op=_torch_op("sum"), group=pg)
    else:  # gloo: the all-reduce, then this rank's block
        full = src.clone()
        _all_reduce_into(full, "sum", pg, n)
        out = full[me * m:(me + 1) * m].clone()
    if op in (ReduceOp.AVG, "avg") and not trivial:
        out = out / n
    if tensor_list is not None:
        _write(_unwrap(tensor), out)
        return tensor
    return _like(tensor, out)


def gather(tensor, gather_list=None, dst: int = 0, group=None, sync_op=True):
    """reference: communication/gather.py. Kept as in the JAX package:
    every rank receives the stacked result (``gather_list`` extended, or
    the stack returned), so ``dst`` changes nothing."""
    out = all_gather(None, tensor, group=group)
    if gather_list is not None:
        gather_list.extend(_like(tensor, o) for o in _unwrap(out).unbind(0))
        return None
    return out


class P2POp:
    """One pending point-to-point op for batch_isend_irecv (reference:
    communication/batch_isend_irecv.py P2POp)."""

    def __init__(self, op, tensor, peer: int, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp op must be distributed.isend or irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """One isend and one irecv per rank, their peers offsets along the
    group (send to ``+k``, receive from ``-k``): a permutation, run as one
    ``torch.distributed.batch_isend_irecv``. The received value is
    written into the irecv's tensor; returns ``[that tensor]``."""
    sends = [o for o in p2p_op_list if o.op is isend]
    recvs = [o for o in p2p_op_list if o.op is irecv]
    if len(sends) != 1 or len(recvs) != 1:
        raise ValueError(
            "batch_isend_irecv executes a permutation: pass exactly one "
            "isend and one irecv per rank")
    send_op, recv_op = sends[0], recvs[0]
    if recv_op.peer != -send_op.peer:
        raise ValueError(
            f"inconsistent p2p batch: isend peer {send_op.peer} requires "
            f"irecv peer {-send_op.peer} (got {recv_op.peer}); every rank "
            "runs the same program, so peers are relative offsets and "
            "must describe one permutation")
    group = send_op.group
    pg, n, trivial = _resolve(group)
    x = _unwrap(send_op.tensor).detach()
    dst_t = _unwrap(recv_op.tensor)
    if trivial or n == 1:
        got = x.clone()
    else:
        dist = _dist()
        me = _index(group)
        to = _global(group, (me + send_op.peer) % n)
        frm = _global(group, (me - send_op.peer) % n)
        staged = _staged(pg, x)
        out = x.cpu() if staged else x.contiguous()
        buf = torch.empty_like(out)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, to, group=pg),
            dist.P2POp(dist.irecv, buf, frm, group=pg)])
        for r in reqs:
            r.wait()
        got = buf
    _write(dst_t, got)
    return [recv_op.tensor]


def isend(tensor, dst: int, group=None):
    raise RuntimeError(
        "isend/irecv only execute batched (batch_isend_irecv, one send and "
        "one recv per rank): lone p2p is not supported, as in the JAX "
        "package")


def irecv(tensor, src: int, group=None):
    raise RuntimeError(
        "isend/irecv only execute batched (batch_isend_irecv, one send and "
        "one recv per rank): lone p2p is not supported, as in the JAX "
        "package")


def send(tensor, dst: int, group=None, sync_op=True):
    raise RuntimeError(
        "point-to-point send/recv is not supported alone; use "
        "batch_isend_irecv (one send + one recv per rank) or pipeline "
        "layers")


recv = send


def barrier(group=None):
    """reference: communication/barrier: every rank of the group waits
    for the others (nothing to wait for in a one-process job)."""
    pg, _, trivial = _resolve(group)
    if not trivial:
        _dist().barrier(group=pg)


def wait(tensor, group=None, use_calc_stream=True):
    """Every collective here has finished when it returns: the tensor as
    it is."""
    return tensor


def split_axis(x, axis_name: str, dim: int = 0):
    """This rank's block of ``x`` along ``dim``, split over the mesh axis
    ``axis_name``."""
    mesh = topology.get_mesh()
    if mesh is None:
        raise RuntimeError("no mesh; fleet.init or init_parallel_env first")
    v = _unwrap(x)
    n = topology.axis_size(axis_name, mesh)
    i = mesh.coordinate()[axis_name]
    size = v.shape[dim] // n
    return _like(x, v.narrow(dim, i * size, size))
