"""MoE and expert parallelism
(``paddle_tpu/incubate/distributed/models/moe``): ``MoELayer``, its
``ExpertLayer``, the gates, ``limit_by_capacity``, ``count_by_gate``
and ``ClipGradForMOEByGlobalNorm``."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa: F401
from .moe_layer import ExpertLayer, MoELayer  # noqa: F401
from .utils import _random_routing, count_by_gate, limit_by_capacity  # noqa: F401

__all__ = [
    "MoELayer", "ExpertLayer", "BaseGate", "NaiveGate", "GShardGate",
    "SwitchGate", "ClipGradForMOEByGlobalNorm", "limit_by_capacity",
    "count_by_gate",
]
