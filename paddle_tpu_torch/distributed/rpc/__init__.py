"""``paddle.distributed.rpc``: tensor/object RPC between workers
(``paddle_tpu/distributed/rpc``).

Reference parity: ``python/paddle/distributed/rpc/rpc.py`` (init_rpc /
rpc_sync / rpc_async / shutdown / get_worker_info backed by the C++
``RpcAgent`` at ``paddle/fluid/distributed/rpc/rpc_agent.h``).
"""
from .rpc import (  # noqa: F401
    WorkerInfo,
    get_all_worker_infos,
    get_current_worker_info,
    get_worker_info,
    init_rpc,
    rpc_async,
    rpc_sync,
    shutdown,
)

__all__ = [
    "init_rpc", "rpc_sync", "rpc_async", "shutdown", "get_worker_info",
    "get_all_worker_infos", "get_current_worker_info", "WorkerInfo",
]
