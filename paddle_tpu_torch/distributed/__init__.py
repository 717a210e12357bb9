"""Distributed training of the port (``paddle_tpu/distributed``): so far
``fleet.recompute``, which runs on one card, the single-process sharded
checkpoint format (``distributed.checkpoint``), and the process's rank
and world size as the environment gives them."""
import os

__all__ = ["get_rank", "get_world_size"]


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """``PADDLE_TRAINER_ID``, else the initialized process group's rank,
    else 0 (``paddle_tpu/distributed/env.py``)."""
    v = os.environ.get("PADDLE_TRAINER_ID")
    if v is not None:
        return int(v)
    if _initialized():
        import torch.distributed as dist

        return dist.get_rank()
    return 0


def get_world_size() -> int:
    """``PADDLE_TRAINERS_NUM``, else the initialized process group's
    size, else 1."""
    v = os.environ.get("PADDLE_TRAINERS_NUM")
    if v is not None:
        return int(v)
    if _initialized():
        import torch.distributed as dist

        return dist.get_world_size()
    return 1
