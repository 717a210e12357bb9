"""Parameter-server training (``paddle_tpu/distributed/ps``).

Reference parity: the brpc parameter server
(``paddle/fluid/distributed/ps/``: ``BrpcPsServer/Client``, table layer,
``Communicator``; Python runtime ``python/paddle/distributed/ps/``).
As in the JAX package: the table engine (hash-map sparse rows + fused
SGD/AdaGrad/Adam update) is native C++ (``paddle_tpu_torch/csrc/
ps_table.cc``, built at first use with the host compiler), servers host
table shards over TCP, and the client API keeps the reference's verbs
(``pull_sparse`` / ``push_sparse`` / ``pull_dense`` / ``push_dense``)
with key-space sharding across servers. ``SparseEmbedding`` plugs the
client into torch autograd so a dense model on the card trains against
a host-resident embedding table that never enters device memory.
"""
from .table import (  # noqa: F401
    DenseTable, SparseTable, SSDSparseTable, TableConfig,
)
from .service import PSClient, PSServer  # noqa: F401
from .layers import SparseEmbedding  # noqa: F401
from .communicator import AsyncCommunicator, GeoCommunicator  # noqa: F401

__all__ = [
    "TableConfig", "SparseTable", "DenseTable", "SSDSparseTable",
    "PSServer", "PSClient", "SparseEmbedding",
    "AsyncCommunicator", "GeoCommunicator",
]
