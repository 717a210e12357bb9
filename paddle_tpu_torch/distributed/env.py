"""The process's place in the job (``paddle_tpu/distributed/env.py``).

The launch contract: ``PADDLE_TRAINER_ID`` and ``PADDLE_TRAINERS_NUM``
(written by ``distributed.launch`` and ``distributed.spawn``) take
precedence; without them an initialized ``torch.distributed`` process
group answers; else the process is rank 0 of 1. Reading these never
starts a process group.
"""
from __future__ import annotations

import os

__all__ = ["get_rank", "get_world_size", "ParallelEnv"]


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """``PADDLE_TRAINER_ID``, else the initialized process group's rank,
    else 0."""
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


class ParallelEnv:
    """reference: parallel.py:662 ParallelEnv."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("PADDLE_LOCAL_RANK", get_rank()))

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def dev_id(self) -> int:
        return self.local_rank

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
