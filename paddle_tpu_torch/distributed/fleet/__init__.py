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
``pp_layers``, ``pipeline_schedule`` and ``pipeline_parallel``.

``fleet.init`` takes a role maker (``role_maker``: ``Role``,
``PaddleCloudRoleMaker`` reading the launcher's environment,
``UserDefinedRoleMaker``); ``is_worker``/``is_server``, the worker and
server counts, indices and endpoints read it. A parameter-server job
(``is_collective=False``, the launcher's ``ps`` mode) starts no process
group and builds no mesh: its trainers talk to the servers through
``distributed.ps``. ``fleet.util`` is one cached ``UtilBase`` whose role
maker ``init`` rebinds. ``utils`` (file systems, the logger, the
hybrid-parallel helpers), ``data_generator``, ``elastic`` and ``auto``
(the auto-parallel ``Engine``) are its submodules, as in the JAX
package.
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
from . import data_generator, utils  # noqa: F401
from .data_generator import (  # noqa: F401
    MultiSlotDataGenerator, MultiSlotStringDataGenerator,
)
from .role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, UserDefinedRoleMaker,
)
from .utils import DistributedInfer, UtilBase  # noqa: F401

__all__ = [
    "utils", "data_generator", "auto", "elastic", "util", "UtilBase", "DistributedInfer",
    "Role", "UserDefinedRoleMaker", "PaddleCloudRoleMaker",
    "MultiSlotDataGenerator", "MultiSlotStringDataGenerator",
    "is_server", "is_worker", "server_num", "server_index",
    "server_endpoints", "worker_endpoints",
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
        self._is_collective = True
        self._role_maker = None
        self._util = None

    @property
    def util(self):
        """reference: fleet.util: ONE cached UtilBase (util_factory
        caches it in the reference, so state set through it persists);
        init() rebinds its role maker."""
        if self._util is None:
            self._util = UtilBase(self._role_maker)
        return self._util

    def init(self, role_maker=None, is_collective: bool = True, strategy=None,
             log_level="INFO"):
        """reference: fleet.py:168: the role maker; then, for a
        collective job, the process group and the hybrid mesh over every
        rank (``HybridCommunicateGroup``); a parameter-server job starts
        neither (module docstring)."""
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        if self._util is not None:
            self._util._set_role_maker(self._role_maker)
        self._is_collective = bool(is_collective)
        self._strategy = strategy or DistributedStrategy()
        if not is_collective:
            self._hcg = None
            self._is_initialized = True
            return self
        init_parallel_env(mesh_axes={})
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

    def _roles(self):
        if self._role_maker is None:
            self._role_maker = PaddleCloudRoleMaker(is_collective=True)
        return self._role_maker

    def is_first_worker(self):
        if not self._is_collective:
            return self._roles()._is_first_worker()
        return get_rank() == 0

    def worker_index(self):
        if not self._is_collective:
            return self._roles()._worker_index()
        return get_rank()

    def worker_num(self):
        if not self._is_collective:
            return self._roles()._worker_num()
        return get_world_size()

    def is_worker(self):
        """reference: fleet.py is_worker."""
        return self._roles()._is_worker()

    def is_server(self):
        """reference: fleet.py is_server."""
        return self._roles()._is_server()

    def server_num(self):
        return self._roles()._server_num()

    def server_index(self):
        return self._roles()._server_index()

    def server_endpoints(self, to_string: bool = False):
        eps = self._roles()._get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def worker_endpoints(self, to_string: bool = False):
        eps = self._roles()._get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

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


def is_worker():
    return fleet.is_worker()


def is_server():
    return fleet.is_server()


def server_num():
    return fleet.server_num()


def server_index():
    return fleet.server_index()


def server_endpoints(to_string=False):
    return fleet.server_endpoints(to_string)


def worker_endpoints(to_string=False):
    return fleet.worker_endpoints(to_string)


util = fleet.util

from . import auto, elastic  # noqa: E402,F401 - auto reads fleet's mesh
