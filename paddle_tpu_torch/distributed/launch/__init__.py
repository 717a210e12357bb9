"""``python -m paddle_tpu_torch.distributed.launch``: the multi-process
job launcher (``paddle_tpu/distributed/launch/``; reference:
``python -m paddle.distributed.launch``, launch/main.py:18, with its
collective controller). It writes the ``PADDLE_TRAINER_*`` contract that
``init_parallel_env`` reads, one process per rank, and supervises them
(``main.py``)."""
from .main import launch, main  # noqa: F401

__all__ = ["launch", "main"]
