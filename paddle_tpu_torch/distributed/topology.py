"""Hybrid-parallel topology: the mesh of ranks and its axis groups
(``paddle_tpu/distributed/topology.py``).

The JAX package's mesh is a ``jax.sharding.Mesh`` over devices, and a
group is a (mesh, axis) handle XLA lowers collectives onto. The port runs
one process per rank, so its :class:`Mesh` is an array of ranks with
named axes, and each axis has real process groups: those of a
``torch.distributed.device_mesh.DeviceMesh`` over the same array, built
when the mesh spans the initialized world. The axis order is the JAX
package's hybrid order ``[dp, pp, sharding, sep, mp]`` with ``mp``
innermost, so the ranks of one ``mp`` group are adjacent.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = [
    "CommunicateTopology", "HybridCommunicateGroup", "Group", "Mesh",
    "get_mesh", "set_mesh", "create_mesh", "axis_size",
]

_HYBRID_ORDER = ("dp", "pp", "sharding", "sep", "mp")


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _this_rank() -> int:
    from .env import get_rank

    return _dist().get_rank() if _initialized() else get_rank()


class Group:
    """A communicator: the global ranks it spans and its
    ``torch.distributed`` process group (None for the default group or
    a one-rank group outside an initialized job). Stands in for the
    reference's ``Group`` and the JAX package's axis handle."""

    def __init__(self, ranks: Sequence[int], process_group=None,
                 axis=None, gid: Optional[int] = None):
        self.ranks = [int(r) for r in ranks]
        self.process_group = process_group
        self.axis = axis
        self.id = gid

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        """This process's index in the group, -1 outside it."""
        me = _this_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    def __repr__(self):
        return (f"Group(id={self.id}, axis={self.axis}, "
                f"ranks={self.ranks})")


def world_group() -> Group:
    """Every rank of the job, on the default process group."""
    from .env import get_world_size

    n = _dist().get_world_size() if _initialized() else get_world_size()
    return Group(range(n), None, axis=None)


class Mesh:
    """Ranks ``devices`` (an int array) with named axes. ``shape`` maps
    each axis to its size, as the JAX mesh's does; :meth:`group` gives
    this rank's group along one axis; ``device_mesh`` is the
    ``DeviceMesh`` whose dimension groups those are (None until the
    mesh spans an initialized world)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} has "
                             f"{len(self.axis_names)} axis names")
        self.shape = collections.OrderedDict(
            zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.device_mesh = None
        self._groups: Dict[str, Group] = {}

    def coordinate(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``rank``'s index along each axis (this process's by default)."""
        rank = _this_rank() if rank is None else int(rank)
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{self.devices.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_ranks(self, axis: str, rank: Optional[int] = None):
        """The ranks of ``rank``'s group along ``axis``, in axis order."""
        coord = self.coordinate(rank)
        dim = self.axis_names.index(axis)
        index = [coord[n] for n in self.axis_names]
        index[dim] = slice(None)
        return [int(r) for r in self.devices[tuple(index)]]

    def _build(self, device_type: str) -> None:
        from torch.distributed.device_mesh import DeviceMesh
        import torch

        self.device_mesh = DeviceMesh(
            device_type, torch.as_tensor(self.devices),
            mesh_dim_names=self.axis_names)

    def group(self, axis: str) -> Group:
        """This rank's group along ``axis``."""
        g = self._groups.get(axis)
        if g is None:
            if axis not in self.axis_names:
                raise ValueError(f"no axis {axis!r} in the mesh "
                                 f"{self.axis_names}")
            pg = None
            if self.device_mesh is not None:
                pg = self.device_mesh.get_group(mesh_dim=axis)
            g = self._groups[axis] = Group(self.axis_ranks(axis), pg,
                                           axis=axis)
        return g

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"


_current_mesh: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]):
    global _current_mesh
    _current_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _current_mesh


def axis_size(name: str, mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or _current_mesh
    if mesh is None or name not in mesh.axis_names:
        return 1
    return int(mesh.shape[name])


def create_mesh(axes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from ``{axis_name: degree}`` over ``devices`` (global ranks;
    default every rank of the job). Degree -1 absorbs the remaining ranks;
    the axes take the hybrid order with ``mp`` innermost, then any other
    names in their given order. When the mesh spans the initialized
    world, its axis groups are made now (a collective call: every rank
    must make the same mesh)."""
    if devices is None:
        devices = list(range(world_group().nranks))
    devices = list(devices)
    n = len(devices)
    names, degrees = [], []
    for name in _HYBRID_ORDER:
        if name in axes:
            names.append(name)
            degrees.append(int(axes[name]))
    for name in axes:
        if name not in names:
            names.append(name)
            degrees.append(int(axes[name]))
    if any(d == -1 for d in degrees):
        known = int(np.prod([d for d in degrees if d != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by fixed degrees {axes}")
        degrees = [n // known if d == -1 else d for d in degrees]
    if int(np.prod(degrees)) != n:
        raise ValueError(
            f"mesh degrees {dict(zip(names, degrees))} need "
            f"{int(np.prod(degrees))} devices, have {n}")
    mesh = Mesh(np.asarray(devices).reshape(degrees), names)
    if _initialized() and n == _dist().get_world_size() and n > 1:
        backend = _dist().get_backend()
        mesh._build("cuda" if backend == "nccl" else "cpu")
    return mesh


class CommunicateTopology:
    """reference: topology.py:54 — named-axis coordinate arithmetic."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = collections.namedtuple("Coordinate", self._parallel_names)
        self._world_size = int(np.prod(self._dims))
        all_coords = [self.coordinate(*c) for c in np.ndindex(*self._dims)]
        self._coord2rank = {c: i for i, c in enumerate(all_coords)}
        self._rank2coord = {i: c for c, i in self._coord2rank.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self):
        return self._world_size

    def get_rank(self, **args):
        return self._coord2rank[self.coordinate(**args)]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return sorted(
            rank for coord, rank in self._coord2rank.items() if coord[axis] == index
        )

    def get_dim_size(self, axis_name):
        return self.get_dim(axis_name)

    def get_comm_list(self, axis_name):
        """All groups along axis_name: list of rank-lists varying only in that
        coordinate."""
        axis = self._parallel_names.index(axis_name)
        groups = collections.defaultdict(list)
        for coord, rank in sorted(self._coord2rank.items(), key=lambda kv: kv[1]):
            key = tuple(v for i, v in enumerate(coord) if i != axis)
            groups[key].append(rank)
        return list(groups.values())


class HybridCommunicateGroup:
    """reference: topology.py:140. Builds THE mesh for 4D(+sep) hybrid
    parallelism over every rank of the job and sets it current; the
    getters return this rank's :class:`Group` along each axis (real
    process groups of the mesh's ``DeviceMesh``) and its index there."""

    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 dp_degree: int = 1, mp_degree: int = 1, pp_degree: int = 1,
                 sharding_degree: int = 1, sep_degree: int = 1,
                 devices: Optional[Sequence] = None):
        if topology is not None:
            name_map = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                        "model": "mp", "sep": "sep"}
            axes = {name_map.get(n, n): topology.get_dim(n)
                    for n in topology.get_hybrid_group_names()}
        else:
            axes = {"dp": dp_degree, "pp": pp_degree, "sharding": sharding_degree,
                    "sep": sep_degree, "mp": mp_degree}
        self._axes = axes
        self.mesh = create_mesh(axes, devices=devices)
        set_mesh(self.mesh)
        self.global_rank = _this_rank()
        self.nranks = self.mesh.size

    def _coord(self, axis: str) -> int:
        if axis not in self.mesh.axis_names:
            return 0
        return self.mesh.coordinate(self.global_rank)[axis]

    def _group(self, axis: str) -> Group:
        if axis not in self.mesh.axis_names:
            return Group([self.global_rank], None, axis=axis)
        return self.mesh.group(axis)

    # degree accessors (reference API)
    def get_data_parallel_world_size(self):
        return axis_size("dp", self.mesh)

    def get_model_parallel_world_size(self):
        return axis_size("mp", self.mesh)

    def get_pipe_parallel_world_size(self):
        return axis_size("pp", self.mesh)

    def get_sharding_parallel_world_size(self):
        return axis_size("sharding", self.mesh)

    def get_sep_parallel_world_size(self):
        return axis_size("sep", self.mesh)

    # group accessors
    def get_data_parallel_group(self):
        return self._group("dp")

    def get_model_parallel_group(self):
        return self._group("mp")

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sep_parallel_group(self):
        return self._group("sep")

    def get_check_parallel_group(self):
        return self._group("mp")

    # this rank's index along each axis
    def get_data_parallel_rank(self):
        return self._coord("dp")

    def get_model_parallel_rank(self):
        return self._coord("mp")

    def get_stage_id(self):
        return self._coord("pp")

    def topology(self):
        return self._axes
