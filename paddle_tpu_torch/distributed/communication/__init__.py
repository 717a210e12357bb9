"""paddle.distributed.communication: the per-collective API
(``paddle_tpu/distributed/communication/__init__.py``). Every name is
the collective of ``distributed.collective``; ``stream`` holds the
explicit-stream variants."""
from ..collective import (  # noqa: F401
    P2POp,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    alltoall,
    barrier,
    batch_isend_irecv,
    broadcast,
    gather,
    get_group,
    irecv,
    isend,
    new_group,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    wait,
)
from . import stream  # noqa: F401

all_to_all = alltoall  # reference module name

__all__ = [
    "ReduceOp", "new_group", "get_group", "all_reduce", "all_gather",
    "all_gather_object", "broadcast", "reduce", "scatter", "alltoall",
    "all_to_all", "reduce_scatter", "gather", "P2POp", "batch_isend_irecv",
    "isend", "irecv", "send", "recv", "barrier", "wait", "stream",
]
