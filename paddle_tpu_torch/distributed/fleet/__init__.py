"""``paddle.distributed.fleet`` (``paddle_tpu/distributed/fleet``): the
distributed-training facade, its tensor-parallel layers, pipelines and
``recompute``.

``fleet.init`` starts the process group (``init_parallel_env``
rendezvous only) and builds the hybrid mesh from the strategy's
``hybrid_configs`` over every rank of the job, degree -1 or 1 for ``dp``
taking the ranks the others leave, as in the JAX package;
``distributed_model`` returns ``PipelineParallel`` for a
``PipelineLayer`` and wraps any other model in ``DataParallel`` over the
mesh's ``dp`` group (over its ``dp`` and ``sharding`` groups when the
``sharding`` degree is above 1; averaged over ``dp`` and summed over
``sep`` when the ``sep`` degree is above 1, as the ranks of one ``sep``
group hold shares of one loss's gradient, ``distributed/
ring_attention.py``), first passing ``accumulate_steps`` to a model
config's unset ``pp_num_microbatches``; ``distributed_optimizer`` shards
the optimizer's state (ZeRO ``os``, ``distributed/sharding.py``) when
``strategy.sharding`` is set and otherwise returns it as it is (the
gradients it reads are averaged already). The pipeline modules are
``pp_layers``, ``pipeline_schedule`` and ``pipeline_parallel``. The role
makers and the rest of the JAX package's ``fleet`` are not ported yet.
"""
from __future__ import annotations

from typing import Optional

from .. import topology
from ..env import get_rank, get_world_size
from .. import collective
from ..parallel import DataParallel, _Reducer, _torch_buffers, \
    _torch_params, init_parallel_env
from ..ring_attention import refuse_beside_sep
from ..topology import CommunicateTopology, HybridCommunicateGroup
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .pipeline_parallel import PipelineParallel
from .pipeline_schedule import (StackedPipelineBlocks, pipeline_1f1b_train,
                                pipeline_apply)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .recompute import recompute

__all__ = [
    "init", "fleet", "Fleet", "DistributedStrategy", "distributed_model",
    "distributed_optimizer", "get_hybrid_communicate_group",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelCrossEntropy", "PipelineLayer", "LayerDesc",
    "SharedLayerDesc", "PipelineParallel", "StackedPipelineBlocks",
    "pipeline_apply", "pipeline_1f1b_train", "recompute", "worker_index",
    "worker_num", "CommunicateTopology", "HybridCommunicateGroup",
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


class _SepDataParallel(DataParallel):
    """``DataParallel`` over the mesh's ``dp`` group whose gradients are
    also summed over its ``sep`` group (module docstring); the weights
    start from the ``sep`` group's first rank's too."""

    def __init__(self, layers, sep, **kwargs):
        object.__setattr__(self, "_sep", sep)
        super().__init__(layers, **kwargs)
        for t in _torch_params(layers) + _torch_buffers(layers):
            collective.broadcast(t, src=sep.ranks[0], group=sep)

    def _make_reducer(self, params, group, bucket_mb, last_bucket_mb,
                      find_unused):
        return _Reducer(params, group, bucket_mb, last_bucket_mb,
                        find_unused, outer=self._sep, outer_mean=False)


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
        """reference: fleet/model.py:30: ``PipelineParallel`` for a
        ``PipelineLayer``, else ``DataParallel`` over the mesh's ``dp``
        group (``find_unused_parameters`` from the strategy), or, when
        the ``sharding`` degree is above 1, over its ``sharding`` and
        ``dp`` groups (``sharding.GroupShardedModel`` at ``os``: the
        ranks of both axes see different data), or when the ``sep``
        degree is above 1 averaged over ``dp`` and summed over ``sep``;
        a model config's unset ``pp_num_microbatches`` takes the
        strategy's ``accumulate_steps``."""
        if not self._is_initialized:
            raise RuntimeError("call fleet.init() first")
        hc = getattr(self._strategy, "hybrid_configs", {}) \
            if self._strategy else {}
        acc = int(hc.get("accumulate_steps", 1))
        cfg = getattr(model, "config", None)
        if acc > 1 and cfg is not None \
                and hasattr(cfg, "pp_num_microbatches") \
                and cfg.pp_num_microbatches is None:
            cfg.pp_num_microbatches = acc
        if isinstance(model, PipelineLayer):
            return PipelineParallel(model, hcg=self._hcg,
                                    strategy=self._strategy)
        unused = bool(getattr(self._strategy, "find_unused_parameters",
                              False))
        if self._hcg.get_sep_parallel_world_size() > 1:
            refuse_beside_sep()
            return _SepDataParallel(
                model, self._hcg.get_sep_parallel_group(),
                group=self._hcg.get_data_parallel_group(),
                find_unused_parameters=unused)
        if self._hcg.get_sharding_parallel_world_size() > 1:
            from ..sharding import GroupShardedModel

            return GroupShardedModel(model, "os",
                                     find_unused_parameters=unused)
        return DataParallel(model, group=self._hcg.get_data_parallel_group(),
                            find_unused_parameters=unused)

    def distributed_optimizer(self, optimizer, strategy=None):
        """reference: fleet.py:1058: the optimizer, its state sharded
        over the mesh's ``sharding`` (else ``dp``) group when
        ``strategy.sharding`` is set."""
        if strategy is not None:
            self._strategy = strategy
        if self._strategy is not None and self._strategy.sharding:
            from ..sharding import shard_optimizer_state

            shard_optimizer_state(optimizer)
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
