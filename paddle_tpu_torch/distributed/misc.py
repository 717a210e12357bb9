"""The rest of ``paddle.distributed``'s names
(``paddle_tpu/distributed/misc.py``): process-group management, the
object collectives, the gloo trio, Megatron's ``split``, and the PS
dataset and entry configs (copied: they hold no device code).

The object collectives and ``alltoall_single`` run on the process
group (``torch.distributed``) where the JAX package uses its
coordination service or ``lax.all_to_all``; the gloo trio runs on the
port's ``TCPStore``, as the JAX one runs on its native store.
"""
from __future__ import annotations

from typing import List

__all__ = [
    "ParallelMode", "is_initialized", "is_available",
    "destroy_process_group", "get_backend", "alltoall_single",
    "broadcast_object_list", "scatter_object_list", "split",
    "gloo_init_parallel_env", "gloo_barrier", "gloo_release",
    "QueueDataset", "InMemoryDataset", "CountFilterEntry",
    "ShowClickEntry", "ProbabilityEntry",
]


class ParallelMode:
    """reference: parallel.py ParallelMode enum."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


def is_available() -> bool:
    """Whether this torch build has ``torch.distributed``."""
    import torch.distributed as dist

    return dist.is_available()


def is_initialized() -> bool:
    """True once ``init_parallel_env``/``fleet.init`` started the process
    group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def destroy_process_group(group=None) -> None:
    """reference: destroy_process_group. With no group: the default
    process group and every group made from it, the mesh and the group
    registry; with one: that group's process group."""
    import torch.distributed as dist

    from . import collective, topology

    if group is not None:
        if group.process_group is not None:
            dist.destroy_process_group(group.process_group)
        return
    topology.set_mesh(None)
    collective._groups.clear()
    collective._next_gid[0] = 0
    if is_initialized():
        dist.destroy_process_group()


def get_backend(group=None) -> str:
    """The communication backend's name, as the reference spells it
    (``NCCL``, ``GLOO``)."""
    import torch.distributed as dist

    pg = getattr(group, "process_group", None)
    return str(dist.get_backend(pg)).upper()


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Single-tensor all-to-all: equal blocks of dim 0, block r to rank r
    (``collective.alltoall``). Uneven splits raise, as in the JAX
    package."""
    from .collective import _write, alltoall

    if in_split_sizes is not None or out_split_sizes is not None:
        raise NotImplementedError(
            "uneven alltoall_single splits are not supported (as in the "
            "JAX package); pad to equal splits")
    out = alltoall(in_tensor, group=group, sync_op=sync_op)
    if out_tensor is not None:
        _write(getattr(out_tensor, "_value", out_tensor),
               getattr(out, "_value", out))
        return out_tensor
    return out


def broadcast_object_list(object_list: List, src: int = 0, group=None):
    """reference: communication/broadcast.py broadcast_object_list: rank
    ``src``'s objects replace ``object_list`` on every rank."""
    import torch.distributed as dist

    if not is_initialized() or dist.get_world_size() == 1:
        return
    dist.broadcast_object_list(object_list, src=int(src),
                               group=getattr(group, "process_group", None))


def scatter_object_list(out_object_list: List, in_object_list=None,
                        src: int = 0, group=None):
    """reference: communication/scatter.py scatter_object_list: rank r
    receives ``in_object_list[r]`` of rank ``src``."""
    import torch.distributed as dist

    from .env import get_rank, get_world_size

    rank, n = get_rank(), get_world_size()
    if rank == src and (in_object_list is None or len(in_object_list) < n):
        raise ValueError(
            f"in_object_list has {len(in_object_list or [])} entries for "
            f"world size {n}")
    if not is_initialized() or n == 1:
        out_object_list[:] = [in_object_list[rank]]
        return
    got = [None]
    dist.scatter_object_list(got, in_object_list if rank == src else None,
                             src=int(src),
                             group=getattr(group, "process_group", None))
    out_object_list[:] = got


# ------------------------------------------------------ gloo-style barrier


_gloo_store = None


def gloo_init_parallel_env(rank_id: int, rank_num: int,
                           server_endpoint: str) -> None:
    """CPU-side rendezvous without a device process group (reference:
    gloo bootstrap): the port's TCPStore, rank 0 hosting it."""
    global _gloo_store
    from .store import TCPStore

    host, port = server_endpoint.rsplit(":", 1)
    _gloo_store = TCPStore(host, int(port), is_master=(rank_id == 0),
                           world_size=rank_num)
    _gloo_store._gloo_rank = rank_id
    _gloo_store._gloo_size = rank_num


def gloo_barrier() -> None:
    if _gloo_store is None:
        raise RuntimeError("call gloo_init_parallel_env first")
    n = _gloo_store._gloo_size
    seq = getattr(gloo_barrier, "_seq", 0)
    gloo_barrier._seq = seq + 1
    key = f"gloo/barrier/{seq}"
    if _gloo_store.add(key, 1) == n:
        _gloo_store.set(key + "/done", b"1")
    _gloo_store.wait([key + "/done"])


def gloo_release() -> None:
    """The rank-0 process hosts the store server, so it must outlive every
    other rank's final barrier read: releases rendezvous before teardown."""
    global _gloo_store
    if _gloo_store is None:
        return
    rank = _gloo_store._gloo_rank
    n = _gloo_store._gloo_size
    if n > 1:
        _gloo_store.set(f"gloo/release/{rank}", b"1")
        if rank == 0:
            _gloo_store.wait([f"gloo/release/{r}" for r in range(n)])
    _gloo_store.stop()
    _gloo_store = None


# ------------------------------------------------------------ megatron split


def split(x, size, operation: str, axis: int = 0, num_partitions: int = 1,
          gather_out: bool = True, weight_attr=None, bias_attr=None,
          name=None):
    """Megatron-style distributed layer op (reference: collective.py:158
    paddle.distributed.split): a row- or column-parallel linear or a
    vocab-parallel embedding across the model-parallel group, applied to
    ``x``."""
    from .fleet import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding)

    if operation == "linear":
        in_f, out_f = size
        if axis == 0:
            layer = RowParallelLinear(in_f, out_f, has_bias=bias_attr
                                      is not False, input_is_parallel=False,
                                      weight_attr=weight_attr)
        elif axis == 1:
            layer = ColumnParallelLinear(in_f, out_f, has_bias=bias_attr
                                         is not False,
                                         gather_output=gather_out,
                                         weight_attr=weight_attr)
        else:
            raise ValueError("linear split axis must be 0 or 1")
        return layer(x)
    if operation == "embedding":
        vocab, emb = size
        layer = VocabParallelEmbedding(vocab, emb, weight_attr=weight_attr)
        return layer(x)
    raise ValueError("operation must be 'linear' or 'embedding'")


# -------------------------------------------------------- PS-side configs


class _EntryConfig:
    """Sparse-table entry/retention rule (reference: distributed/entry_attr
    — controls which sparse features materialize rows)."""

    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.kw = kw

    def _to_attr(self) -> str:
        parts = [self.kind] + [f"{k}:{v}" for k, v in self.kw.items()]
        return " ".join(parts)

    def __repr__(self):
        return f"{type(self).__name__}({self.kw})"


class ProbabilityEntry(_EntryConfig):
    def __init__(self, probability: float):
        if not 0 < probability <= 1:
            raise ValueError("probability must be in (0, 1]")
        super().__init__("probability_entry", probability=probability)


class CountFilterEntry(_EntryConfig):
    def __init__(self, count_filter: int):
        if count_filter < 0:
            raise ValueError("count_filter must be >= 0")
        super().__init__("count_filter_entry", count_filter=count_filter)


class ShowClickEntry(_EntryConfig):
    def __init__(self, show_name: str, click_name: str):
        super().__init__("show_click_entry", show=show_name,
                         click=click_name)


class QueueDataset:
    """Streaming dataset fed from files (reference: fleet/dataset
    QueueDataset — the C++ data_feed pipeline). Host-side file streaming
    into the io pipeline."""

    def __init__(self):
        self._files: List[str] = []
        self._parse_fn = None
        self.batch_size = 1

    def init(self, batch_size=1, use_var=None, pipe_command=None,
             thread_num=1, **kw):
        self.batch_size = batch_size

    def set_filelist(self, files: List[str]) -> None:
        self._files = list(files)

    def set_parse_ins_id(self, flag: bool) -> None:
        pass

    def set_parse_fn(self, fn) -> None:
        self._parse_fn = fn

    def _reader(self):
        for path in self._files:
            with open(path) as f:
                for line in f:
                    line = line.rstrip("\n")
                    yield self._parse_fn(line) if self._parse_fn else line

    def __iter__(self):
        return self._reader()


class InMemoryDataset(QueueDataset):
    """reference: fleet/dataset InMemoryDataset — loads into memory,
    supports shuffle before training."""

    def __init__(self):
        super().__init__()
        self._samples: List = []

    def load_into_memory(self) -> None:
        self._samples = list(self._reader())

    def local_shuffle(self) -> None:
        import random

        random.shuffle(self._samples)

    def global_shuffle(self, fleet=None, thread_num=1) -> None:
        self.local_shuffle()  # single-controller: local IS global

    def release_memory(self) -> None:
        self._samples = []

    def get_memory_data_size(self, fleet=None) -> int:
        return len(self._samples)

    def __iter__(self):
        if self._samples:
            return iter(self._samples)
        return self._reader()
