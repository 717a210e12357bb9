"""Process bootstrap, ``DataParallel`` and ``shard_map_fn``
(``paddle_tpu/distributed/parallel.py``).

The JAX package starts the JAX distributed runtime and makes
``DataParallel`` a batch-axis sharding annotation: XLA inserts the
gradient psum, and ``scale_loss`` is the identity because the loss is
already the global batch's mean. The port runs one process per rank:

- :func:`init_parallel_env` starts the default ``torch.distributed``
  process group from the launch contract (``PADDLE_TRAINER_ID``,
  ``PADDLE_TRAINERS_NUM``, ``MASTER_ADDR``/``MASTER_PORT`` or
  ``PADDLE_MASTER_ENDPOINT``), on ``nccl`` when the port's device is the
  card and ``gloo`` when it is the CPU, runs one collective so the
  communicator exists before any CUDA-graph capture, and installs a
  ``dp`` mesh over every rank (``mesh_axes={}``: rendezvous only).
- A rank's loss is the mean over its own rows, so :class:`DataParallel`
  **averages** the gradients across the group, as the reference's
  ``EagerReducer`` does: an update from N equal shards is then the full
  batch's. Gradients are flattened into buckets in the reverse of the
  parameters' order (``comm_buffer_size_MB`` each, the first one formed
  ``last_comm_buffer_size_MB``, one dtype a bucket); when the last
  expected gradient of a backward has accumulated, each bucket in turn
  is all-reduced (SUM), divided by the group's size and copied back into
  the gradients in place. Everything runs on the current stream, so a
  ``jit.StaticFunction`` captures the reduction with the step.
  ``no_sync()`` skips it (the gradients accumulate locally, as the
  reference's do); parameters and buffers are broadcast from the group's
  first rank when the wrapper is built. ``find_unused_parameters`` walks
  the forward's autograd graph for the parameters it reaches, and the
  others take zero gradients into the reduction; without it, a backward
  that leaves a parameter without a gradient is refused at the next
  forward. ``scale_loss`` stays the identity.
- :func:`shard_map_fn` takes tensors every rank holds whole, gives
  ``fn`` this rank's block of each as ``in_specs`` says, and assembles
  the outputs as ``out_specs`` says (gathered along a sharded dim, or as
  they are for ``P()``), so code written for the JAX version runs as it
  is.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import socket
from typing import Dict, List, Optional

import torch

from ..nn.layer_base import Layer
from . import collective, topology
from .sharding_api import PartitionSpec

__all__ = ["init_parallel_env", "DataParallel", "shard_map_fn", "scale_loss"]


def _dist():
    import torch.distributed as dist

    return dist


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _master(world: int):
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    ep = os.environ.get("PADDLE_MASTER_ENDPOINT")
    if (addr is None or port is None) and ep:
        a, p = ep.rsplit(":", 1)
        addr, port = addr or a, port or p
    if port is None:
        if world > 1:
            raise RuntimeError(
                "init_parallel_env: a job of several ranks needs "
                "MASTER_ADDR/MASTER_PORT or PADDLE_MASTER_ENDPOINT "
                "(distributed.launch and distributed.spawn set them)")
        port = _free_port()
    return addr or "127.0.0.1", int(port)


def init_parallel_env(mesh_axes: Optional[dict] = None,
                      backend: Optional[str] = None):
    """reference: parallel.py:934. Starts the default process group once
    (module docstring); ``backend`` overrides the device's choice (two
    ranks sharing one card run on ``gloo``). Then, unless ``mesh_axes ==
    {}``, installs the mesh ``mesh_axes`` (default ``{"dp": world}``)
    when none is set."""
    dist = _dist()
    if not dist.is_initialized():
        from ..device import default_device

        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        addr, port = _master(world)
        dev = default_device()
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if backend == "nccl":
            if dev.type != "cuda":
                raise RuntimeError("init_parallel_env: nccl needs the card")
            local = int(os.environ.get("PADDLE_LOCAL_RANK", rank))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=600))
        # the communicator is made by a group's first collective, which
        # must not fall inside a CUDA-graph capture
        x = torch.ones(1, device=torch.device("cuda") if backend == "nccl"
                       else torch.device("cpu"))
        dist.all_reduce(x)
        if backend == "nccl":
            torch.cuda.synchronize()
    if mesh_axes == {}:
        return None
    if topology.get_mesh() is None:
        axes = mesh_axes if mesh_axes is not None else {
            "dp": dist.get_world_size()}
        topology.set_mesh(topology.create_mesh(axes))
    return None


# ------------------------------------------------------------ reducer
def _buckets(params: List[torch.Tensor], limits_bytes) -> List[List[int]]:
    """Indices of ``params`` grouped in the reverse of their order, one
    dtype and device a bucket, each dtype's first bucket capped at
    ``limits_bytes[0]`` and the later ones at ``limits_bytes[1]``."""
    open_: Dict[tuple, list] = {}
    size: Dict[tuple, int] = {}
    made: Dict[tuple, int] = {}
    done: List[List[int]] = []
    order: List[list] = []
    for i in reversed(range(len(params))):
        p = params[i]
        key = (p.dtype, p.device)
        if key not in open_:
            open_[key] = []
            size[key] = 0
            order.append(open_[key])
        open_[key].append(i)
        size[key] += p.numel() * p.element_size()
        cap = limits_bytes[0] if made.get(key, 0) == 0 else limits_bytes[1]
        if size[key] >= cap:
            made[key] = made.get(key, 0) + 1
            done.append(open_.pop(key))
            size.pop(key)
    for b in order:
        if b not in done and b:
            done.append(b)
    # fixed order on every rank: by each bucket's first parameter
    return sorted(done, key=lambda b: -b[0])


def _reachable(outputs, params: Dict[int, torch.Tensor]) -> set:
    """Ids of the parameters the outputs' autograd graph reaches."""
    roots, used, seen = [], set(), set()

    def go(o):
        o = getattr(o, "_value", o)
        if isinstance(o, torch.Tensor):
            if o.grad_fn is not None:
                roots.append(o.grad_fn)
            elif id(o) in params:
                used.add(id(o))
        elif isinstance(o, (list, tuple)):
            for v in o:
                go(v)
        elif isinstance(o, dict):
            for v in o.values():
                go(v)

    go(outputs)
    while roots:
        fn = roots.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        var = getattr(fn, "variable", None)
        if var is not None and id(var) in params:
            used.add(id(var))
        roots.extend(nxt for nxt, _ in fn.next_functions)
    return used


class _Reducer:
    """The gradient averaging of :class:`DataParallel` (module
    docstring)."""

    def __init__(self, params: List[torch.Tensor], group,
                 bucket_mb: float, last_bucket_mb: float,
                 find_unused: bool):
        self.params = [p for p in params if p.requires_grad]
        self.group = group
        self.find_unused = find_unused
        mb = 1024 * 1024
        self.buckets = _buckets(self.params, (last_bucket_mb * mb,
                                              bucket_mb * mb))
        self.sync = True
        self._ids = {id(p): i for i, p in enumerate(self.params)}
        self._expected = set(self._ids)
        self._ready: set = set()
        # counts of the reductions made (Python-side: a replayed CUDA
        # graph repeats the captured ones without coming back here)
        self.reductions = 0
        self.all_reduces = 0
        self.bytes_reduced = 0
        self._hooks = [p.register_post_accumulate_grad_hook(self._on_ready)
                       for p in self.params]

    def bucket_bytes(self) -> List[int]:
        return [sum(self.params[i].numel() * self.params[i].element_size()
                    for i in b) for b in self.buckets]

    def prepare(self, outputs) -> None:
        """Before a backward: refuse one left unfinished, and under
        ``find_unused`` learn which parameters this forward reaches."""
        if self._ready:
            missing = len(self._expected - self._ready)
            self._ready = set()
            raise RuntimeError(
                f"DataParallel: the last backward left {missing} "
                "parameter(s) without a gradient, so their gradients were "
                "never averaged; pass find_unused_parameters=True if the "
                "model has parameters a forward does not use")
        if self.find_unused:
            self._expected = _reachable(
                outputs, {id(p): p for p in self.params})

    def _on_ready(self, p: torch.Tensor) -> None:
        if not self.sync or id(p) not in self._expected:
            return
        self._ready.add(id(p))
        if len(self._ready) == len(self._expected):
            self._ready = set()
            self.reduce()

    @torch.no_grad()
    def reduce(self) -> None:
        pg, n, trivial = collective._resolve(self.group)
        for bucket in self.buckets:
            grads = []
            for i in bucket:
                p = self.params[i]
                if p.grad is None:  # an unused parameter: zeros
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            flat = torch.cat([g.reshape(-1) for g in grads])
            if not trivial:
                collective._all_reduce_into(flat, "sum", pg, n)
                self.all_reduces += 1
                self.bytes_reduced += flat.numel() * flat.element_size()
            flat.div_(n)
            off = 0
            for g in grads:
                k = g.numel()
                g.copy_(flat[off:off + k].view_as(g))
                off += k
        self.reductions += 1


def _torch_params(layers) -> List[torch.Tensor]:
    if isinstance(layers, Layer):
        return [p._value for p in layers.parameters()]
    return list(layers.parameters())


def _torch_buffers(layers) -> List[torch.Tensor]:
    if isinstance(layers, Layer):
        return [b._value for b in layers.buffers() if b is not None]
    return list(layers.buffers())


class DataParallel(Layer):
    """reference: parallel.py:203 DataParallel: wraps a Paddle ``Layer``
    or a ``torch.nn.Module`` (the port's GPT and Llama) and averages its
    gradients across ``group`` (default: the mesh's ``dp`` axis, else
    every rank) after each backward (module docstring). Starts the
    process group with :func:`init_parallel_env` if none is running."""

    def __init__(self, layers, strategy=None, comm_buffer_size_MB: int = 25,
                 last_comm_buffer_size_MB: int = 1,
                 find_unused_parameters: bool = False, group=None):
        super().__init__()
        if not _dist().is_initialized():
            init_parallel_env()
        if isinstance(layers, Layer):
            self._layers = layers
        else:
            object.__setattr__(self, "_layers", layers)
        if group is None:
            mesh = topology.get_mesh()
            group = (mesh.group("dp") if mesh is not None
                     and "dp" in mesh.axis_names else topology.world_group())
        self._group = group
        self.find_unused_parameters = find_unused_parameters
        src = group.ranks[0]
        for t in _torch_params(layers) + _torch_buffers(layers):
            collective.broadcast(t, src=src, group=group)
        self._reducer = _Reducer(_torch_params(layers), group,
                                 comm_buffer_size_MB,
                                 last_comm_buffer_size_MB,
                                 find_unused_parameters)

    def forward(self, *inputs, **kwargs):
        out = self._layers(*inputs, **kwargs)
        if torch.is_grad_enabled():
            self._reducer.prepare(out)
        return out

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside skip the reduction; their gradients add up
        locally until a backward outside it reduces them all."""
        was = self._reducer.sync
        self._reducer.sync = False
        try:
            yield
        finally:
            self._reducer.sync = was

    def comm_stats(self) -> dict:
        """The buckets (bytes each) and the reductions made so far."""
        r = self._reducer
        return {"buckets": len(r.buckets), "bucket_bytes": r.bucket_bytes(),
                "reductions": r.reductions, "all_reduces": r.all_reduces,
                "bytes_reduced": r.bytes_reduced}

    def __jit_state__(self):
        return [self._layers]

    def parameters(self, include_sublayers: bool = True):
        return list(self._layers.parameters())

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)

    def train(self):
        self._layers.train()
        object.__setattr__(self, "training", True)
        return self

    def eval(self):
        self._layers.eval()
        object.__setattr__(self, "training", False)
        return self

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        if isinstance(self._layers, Layer):
            return self._layers.set_state_dict(*args, **kwargs)
        return self._layers.load_state_dict(*args, **kwargs)

    def scale_loss(self, loss):
        return loss


def scale_loss(loss):
    """reference: parallel.py scale_loss: the identity (DataParallel
    averages the gradients)."""
    return loss


def _spec(s):
    if s is None:
        return None
    return s if isinstance(s, PartitionSpec) else PartitionSpec(*s)


def _specs(specs):
    if isinstance(specs, (list, tuple)) and not isinstance(
            specs, PartitionSpec):
        return tuple(_spec(s) for s in specs)
    return _spec(specs)


def _axes(entry):
    return () if entry is None else (
        tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))


def _block(v: torch.Tensor, spec, mesh) -> torch.Tensor:
    coord = mesh.coordinate()
    for d, entry in enumerate(spec or ()):
        axes = _axes(entry)
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:
            idx = idx * mesh.shape[a] + coord[a]
            n *= mesh.shape[a]
        size = v.shape[d] // n
        v = v.narrow(d, idx * size, size)
    return v


def _assemble(v: torch.Tensor, spec, mesh) -> torch.Tensor:
    for d, entry in enumerate(spec or ()):
        for a in reversed(_axes(entry)):
            parts = collective.all_gather(None, v, group=mesh.group(a))
            v = torch.cat(list(parts.unbind(0)), dim=d)
    return v


def shard_map_fn(fn, mesh=None, in_specs=None, out_specs=None,
                 check_vma: bool = False):
    """Run ``fn`` on this rank's blocks (module docstring); specs are
    ``PartitionSpec`` (or tuples of them), entries naming mesh axes per
    dim. ``check_vma`` is taken for the JAX API."""
    from ..tensor import Tensor

    m = mesh or topology.get_mesh()
    if m is None:
        raise RuntimeError("no mesh; fleet.init or init_parallel_env first")
    ispec, ospec = _specs(in_specs), _specs(out_specs)

    def wrapper(*tensors):
        specs = ispec if isinstance(ispec, tuple) and not isinstance(
            ispec, PartitionSpec) else (ispec,) * len(tensors)
        blocks = [Tensor._wrap(_block(getattr(t, "_value", t), s, m))
                  for t, s in zip(tensors, specs)]
        outs = fn(*blocks)
        single = not isinstance(outs, (list, tuple))
        outs = [outs] if single else list(outs)
        ospecs = ospec if isinstance(ospec, tuple) and not isinstance(
            ospec, PartitionSpec) else (ospec,) * len(outs)
        done = [Tensor._wrap(_assemble(getattr(o, "_value", o), s, m))
                for o, s in zip(outs, ospecs)]
        return done[0] if single else tuple(done)

    return wrapper
