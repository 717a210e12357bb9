"""``paddle.distributed.fleet.auto`` namespace (reference:
python/paddle/distributed/fleet/__init__.py re-exporting auto_parallel;
``paddle_tpu/distributed/fleet/auto.py``) —
the user-facing entry for the auto-parallel Engine."""
from ..auto_parallel import (  # noqa: F401
    Engine, ProcessMesh, Strategy, reshard, shard_tensor,
)

__all__ = ["Engine", "Strategy", "ProcessMesh", "shard_tensor", "reshard"]
