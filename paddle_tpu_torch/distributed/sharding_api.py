"""Tensor sharding API: ``ProcessMesh``, the placements, ``shard_tensor``
and ``reshard`` (``paddle_tpu/distributed/sharding_api.py``).

The JAX package's dist_attr is a ``NamedSharding`` and GSPMD completes
the rest. The port's is a ``torch.distributed.tensor.DTensor`` over the
``DeviceMesh`` of a :class:`ProcessMesh`: ``shard_tensor`` distributes
a tensor every rank holds whole into this rank's shard, ``reshard``
redistributes it (torch issues the all-gathers and slices the JAX
package leaves to XLA), and the returned ``Tensor`` holds the DTensor.
``Partial`` is treated as ``Replicate`` at the API boundary, as the JAX
package does. :class:`PartitionSpec` (tensor dims to mesh axis names)
is what ``shard_map_fn`` and ``constraint`` take.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import topology

__all__ = [
    "ProcessMesh", "Shard", "Replicate", "Partial", "Placement",
    "PartitionSpec", "shard_tensor", "reshard", "shard_layer",
    "dtensor_from_fn", "constraint",
]


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of them, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class ProcessMesh:
    """reference: auto_parallel/process_mesh.py: an N-D array of ranks
    with dim names, over a ``DeviceMesh`` once the job's process group
    runs (``device_mesh``)."""

    def __init__(self, mesh=None, dim_names: Optional[Sequence[str]] = None,
                 process_ids=None, shape=None):
        if isinstance(mesh, topology.Mesh):
            ranks, names = mesh.devices, list(mesh.axis_names)
        else:
            if mesh is not None:
                ranks = np.asarray(mesh)
            else:
                shape = tuple(shape) if shape is not None else (
                    topology.world_group().nranks,)
                ranks = np.asarray(process_ids if process_ids is not None
                                   else range(int(np.prod(shape)))
                                   ).reshape(shape)
            names = list(dim_names) if dim_names is not None else [
                f"d{i}" for i in range(ranks.ndim)]
        self._ranks = np.asarray(ranks, dtype=np.int64)
        self._dim_names = names
        self._device_mesh = getattr(mesh, "device_mesh", None)

    @property
    def shape(self):
        return list(self._ranks.shape)

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return [int(r) for r in self._ranks.reshape(-1)]

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over these ranks (made at first use: a
        collective call on every rank)."""
        if self._device_mesh is None:
            import torch
            import torch.distributed as dist
            from torch.distributed.device_mesh import DeviceMesh

            if not dist.is_initialized():
                raise RuntimeError("ProcessMesh: init_parallel_env first")
            kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self._device_mesh = DeviceMesh(
                kind, torch.as_tensor(self._ranks),
                mesh_dim_names=tuple(self._dim_names))
        return self._device_mesh

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self.dim_names})"


# -------------------------------------------------------------- placements
class Placement:
    pass


class Shard(Placement):
    """Shard the tensor dim ``dim`` over the corresponding mesh dim
    (reference: paddle.distributed.Shard)."""

    def __init__(self, dim: int):
        self.dim = int(dim)

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))


class Replicate(Placement):
    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("Replicate")


class Partial(Placement):
    """Pending-reduction placement, treated as Replicate at the API
    boundary (reference: paddle.distributed.Partial)."""

    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type

    def __repr__(self):
        return f"Partial({self.reduce_type})"


def _process_mesh(mesh) -> ProcessMesh:
    if mesh is None:
        m = topology.get_mesh()
        if m is None:
            raise ValueError("no mesh: pass one or fleet.init/set_mesh first")
        return ProcessMesh(m)
    if isinstance(mesh, ProcessMesh):
        return mesh
    if isinstance(mesh, topology.Mesh):
        return ProcessMesh(mesh)
    raise TypeError(f"expected ProcessMesh/Mesh, got {type(mesh)}")


def _torch_placements(placements, spec, pm: ProcessMesh, ndim: int):
    from torch.distributed.tensor import Replicate as TR, Shard as TS

    out = [TR() for _ in pm.dim_names]
    if placements is not None:
        for i, p in enumerate(placements):
            if isinstance(p, Shard):
                if p.dim >= ndim:
                    raise ValueError(
                        f"Shard(dim={p.dim}) out of range for ndim={ndim}")
                out[i] = TS(p.dim)
    elif spec is not None:
        for d, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                out[pm.dim_names.index(a)] = TS(d)
    return out


def shard_tensor(x, mesh=None, placements: Optional[Sequence[Placement]] = None,
                 spec=None, stop_gradient: Optional[bool] = None):
    """reference: paddle.distributed.shard_tensor: ``x`` (every rank
    holds it whole) as a DTensor on ``mesh`` with ``placements`` (one per
    mesh dim) or ``spec`` (mesh axis names per tensor dim); returns a
    Tensor over the DTensor with ``dist_attr`` set to the placements."""
    from torch.distributed.tensor import distribute_tensor

    from ..tensor import Tensor

    pm = _process_mesh(mesh)
    v = getattr(x, "_value", x)
    if not hasattr(v, "to_local"):
        v = distribute_tensor(v.detach(), pm.device_mesh,
                              _torch_placements(placements, spec, pm, v.ndim))
    else:
        v = v.redistribute(pm.device_mesh,
                           _torch_placements(placements, spec, pm, v.ndim))
    out = Tensor._wrap(v)
    if stop_gradient is False:
        v.requires_grad_(True)
    out.dist_attr = list(placements) if placements is not None else spec
    return out


def reshard(x, mesh=None, placements=None, spec=None):
    """Change a distributed tensor's layout (reference: Resharder,
    auto_parallel/reshard.py:1008): ``DTensor.redistribute``."""
    return shard_tensor(x, mesh=mesh, placements=placements, spec=spec)


def constraint(value, *spec_entries, mesh=None):
    """The JAX package's sharding constraint on a raw value: a DTensor
    is redistributed to ``spec_entries``; a plain tensor is this rank's
    value already and comes back as it is."""
    if hasattr(value, "redistribute"):
        pm = _process_mesh(mesh)
        return value.redistribute(pm.device_mesh, _torch_placements(
            None, PartitionSpec(*spec_entries), pm, value.ndim))
    return value


def shard_layer(layer, mesh=None, shard_fn=None, input_fn=None, output_fn=None):
    """reference: paddle.distributed.shard_layer: ``shard_fn(name,
    sublayer, mesh)`` on every sublayer (default: replicate, which is what
    each rank holds already), and the input/output hooks."""
    pm = _process_mesh(mesh)
    if shard_fn is not None:
        for name, sub in layer.named_sublayers(include_self=True):
            shard_fn(name, sub, pm)
    if input_fn is not None:
        layer.register_forward_pre_hook(lambda l, inp: input_fn(inp, pm))
    if output_fn is not None:
        layer.register_forward_post_hook(lambda l, inp, out: output_fn(out, pm))
    return layer


def dtensor_from_fn(fn, mesh=None, placements=None, *args, **kwargs):
    """reference: paddle.distributed.dtensor_from_fn: build, then shard."""
    return shard_tensor(fn(*args, **kwargs), mesh=mesh, placements=placements)
