"""Distributed training of the port (``paddle_tpu/distributed``) on
``torch.distributed``, one process per rank.

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``: its
collectives are ``lax`` ops inside ``shard_map``, ``DataParallel`` is a
sharding annotation and the tensor-parallel layers are GSPMD-sharded
weights. The port keeps the names and behaviours on processes: the
launch contract and ``ParallelEnv`` (``env``), ``TCPStore`` (``store``),
the collectives and groups (``collective``, ``communication``),
``init_parallel_env``, ``DataParallel`` with its gradient reducer and
``shard_map_fn`` (``parallel``), the mesh of ranks with real process
groups per axis (``topology``), the placements on DTensor
(``sharding_api``), ``spawn``, ``launch``, ``fleet`` with its Megatron
tensor-parallel layers, and the single-process sharded checkpoint files
(``checkpoint``). Not ported yet: ZeRO sharding
(``group_sharded_parallel``), pipelines, ring attention, the parameter
server, ``rpc`` and ``auto_parallel``.
"""
from . import checkpoint  # noqa: F401
from . import communication  # noqa: F401
from . import fleet  # noqa: F401
from . import launch  # noqa: F401
from ..framework import io  # noqa: F401 - reference exports distributed.io
from .collective import (  # noqa: F401
    P2POp, ReduceOp, all_gather, all_gather_object, all_reduce, alltoall,
    barrier, batch_isend_irecv, broadcast, gather, get_group, irecv, isend,
    new_group, recv, reduce, reduce_scatter, scatter, send, wait,
)
from .env import ParallelEnv, get_rank, get_world_size  # noqa: F401
from .misc import (  # noqa: F401
    CountFilterEntry, InMemoryDataset, ParallelMode, ProbabilityEntry,
    QueueDataset, ShowClickEntry, alltoall_single, broadcast_object_list,
    destroy_process_group, get_backend, gloo_barrier,
    gloo_init_parallel_env, gloo_release, is_available, is_initialized,
    scatter_object_list, split,
)
from .parallel import (  # noqa: F401
    DataParallel, init_parallel_env, scale_loss, shard_map_fn,
)
from .sharding_api import (  # noqa: F401
    Partial, PartitionSpec, Placement, ProcessMesh, Replicate, Shard,
    dtensor_from_fn, reshard, shard_layer, shard_tensor,
)
from .spawn import spawn  # noqa: F401
from .store import TCPStore  # noqa: F401
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, create_mesh, get_mesh,
    set_mesh,
)

__all__ = [
    "ParallelEnv", "get_rank", "get_world_size", "init_parallel_env",
    "DataParallel", "scale_loss", "shard_map_fn",
    "ReduceOp", "new_group", "get_group", "all_reduce", "all_gather",
    "broadcast", "reduce", "scatter", "alltoall", "barrier", "wait",
    "ProcessMesh", "Shard", "Replicate", "Partial", "Placement",
    "PartitionSpec", "shard_tensor", "reshard", "shard_layer",
    "dtensor_from_fn", "CommunicateTopology", "HybridCommunicateGroup",
    "create_mesh", "get_mesh", "set_mesh", "fleet", "TCPStore", "spawn",
    "communication", "launch", "io", "checkpoint",
    "ParallelMode", "is_initialized", "is_available",
    "destroy_process_group", "get_backend", "alltoall_single",
    "broadcast_object_list", "scatter_object_list", "split",
    "gloo_init_parallel_env", "gloo_barrier", "gloo_release",
    "QueueDataset", "InMemoryDataset", "CountFilterEntry",
    "ShowClickEntry", "ProbabilityEntry",
    "reduce_scatter", "gather", "P2POp", "batch_isend_irecv", "isend",
    "irecv", "send", "recv", "all_gather_object",
]
