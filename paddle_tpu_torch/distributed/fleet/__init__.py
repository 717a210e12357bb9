"""``paddle.distributed.fleet`` (``paddle_tpu/distributed/fleet``): the
distributed-training facade and its tensor-parallel layers, and
``recompute``.

``fleet.init`` starts the process group (``init_parallel_env``
rendezvous only) and builds the hybrid mesh from the strategy's
``hybrid_configs`` over every rank of the job, degree -1 or 1 for ``dp``
taking the ranks the others leave, as in the JAX package;
``distributed_model`` wraps a model in ``DataParallel`` over the mesh's
``dp`` group; ``distributed_optimizer`` returns the optimizer as it is
(the gradients it reads are averaged already). Pipeline parallelism,
ZeRO sharding, the role makers and the rest of the JAX package's
``fleet`` are not ported yet.
"""
from __future__ import annotations

from typing import Optional

from .. import topology
from ..env import get_rank, get_world_size
from ..parallel import DataParallel, init_parallel_env
from ..topology import CommunicateTopology, HybridCommunicateGroup
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .recompute import recompute

__all__ = [
    "init", "fleet", "Fleet", "DistributedStrategy", "distributed_model",
    "distributed_optimizer", "get_hybrid_communicate_group",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelCrossEntropy", "recompute", "worker_index", "worker_num",
    "CommunicateTopology", "HybridCommunicateGroup",
]


class DistributedStrategy:
    """reference: DistributedStrategy protobuf (222 fields,
    framework/distributed_strategy.proto:323). Dict-backed: the hybrid
    degrees act; the rest are carried so user configs port over."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
            "micro_batch_size": 1, "accumulate_steps": 1,
        }
        self.sharding = False
        self.sharding_configs = {}
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.pipeline = False
        self.pipeline_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


class Fleet:
    """reference: fleet/fleet.py:100."""

    def __init__(self):
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective: bool = True, strategy=None,
             log_level="INFO"):
        """reference: fleet.py:168: the process group, then the hybrid
        mesh over every rank (``HybridCommunicateGroup``)."""
        init_parallel_env(mesh_axes={})
        self._strategy = strategy or DistributedStrategy()
        hc = dict(self._strategy.hybrid_configs)
        n = get_world_size()
        degrees = {
            "dp": int(hc.get("dp_degree", 1)),
            "pp": int(hc.get("pp_degree", 1)),
            "sharding": int(hc.get("sharding_degree", 1)),
            "sep": int(hc.get("sep_degree", 1)),
            "mp": int(hc.get("mp_degree", 1)),
        }
        others = 1
        for name, v in degrees.items():
            if name != "dp" and v != -1:
                others *= max(v, 1)
        if degrees["dp"] in (-1, 1):
            if n % others:
                raise ValueError(
                    f"world size {n} not divisible by non-dp degrees {others}")
            degrees["dp"] = n // others
        elif degrees["dp"] * others != n:
            raise ValueError(
                f"hybrid degrees {degrees} need {degrees['dp'] * others} "
                f"ranks but the job has {n}")
        topology.set_mesh(None)
        self._hcg = HybridCommunicateGroup(
            dp_degree=degrees["dp"], pp_degree=degrees["pp"],
            sharding_degree=degrees["sharding"], sep_degree=degrees["sep"],
            mp_degree=degrees["mp"])
        self._is_initialized = True
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def strategy(self):
        return self._strategy

    def is_first_worker(self):
        return get_rank() == 0

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def barrier_worker(self):
        from ..collective import barrier

        barrier()

    def distributed_model(self, model):
        """reference: fleet/model.py:30: ``DataParallel`` over the mesh's
        ``dp`` group (``find_unused_parameters`` from the strategy)."""
        if not self._is_initialized:
            raise RuntimeError("call fleet.init() first")
        return DataParallel(
            model, group=self._hcg.get_data_parallel_group(),
            find_unused_parameters=bool(getattr(
                self._strategy, "find_unused_parameters", False)))

    def distributed_optimizer(self, optimizer, strategy=None):
        """reference: fleet.py:1058: the optimizer as it is."""
        if strategy is not None:
            self._strategy = strategy
        return optimizer


fleet = Fleet()


def init(role_maker=None, is_collective=True, strategy=None, log_level="INFO"):
    return fleet.init(role_maker, is_collective, strategy, log_level)


def distributed_model(model):
    return fleet.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def get_hybrid_communicate_group():
    return fleet.get_hybrid_communicate_group()


def worker_index():
    return fleet.worker_index()


def worker_num():
    return fleet.worker_num()
