"""``paddle.incubate`` of the port (``paddle_tpu/incubate``): experimental
APIs.

- ``distributed.models.moe``: the mixture-of-experts layer with its
  gates, capacity utilities and grad clip, expert-parallel on
  ``all_to_all``;
- ``nn``: the fused transformer layers and their functionals, whose
  attention takes the flash kernels K1-K3 on the card;
- ``optimizer``: ``LookAhead``, ``ModelAverage``, ``LBFGS``,
  ``DistributedFusedLamb`` and ``functional``'s BFGS/L-BFGS;
- ``asp`` (n:m structured sparsity), ``autograd`` (the functional
  transforms and ``forward_grad``), ``autotune`` (``set_config``: the
  flash kernels' switch among others);
- the masked softmaxes, ``identity_loss`` and the graph and segment ops
  (forwarding to ``paddle.geometric``).
"""
from . import asp  # noqa: F401
from ._ops import (  # noqa: F401
    graph_khop_sampler, graph_reindex, graph_sample_neighbors,
    graph_send_recv, identity_loss, segment_max, segment_mean, segment_min,
    segment_sum, softmax_mask_fuse, softmax_mask_fuse_upper_triangle,
)
from . import autograd  # noqa: F401
from . import distributed  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from .autotune import autotune_status, set_config  # noqa: F401
from .optimizer import (  # noqa: F401
    LBFGS, DistributedFusedLamb, LookAhead, ModelAverage,
)

__all__ = ["autograd", "distributed", "asp", "nn", "optimizer",
           "LookAhead", "ModelAverage", "LBFGS", "DistributedFusedLamb",
           "set_config",
           "autotune_status", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "graph_send_recv",
           "graph_khop_sampler", "graph_sample_neighbors", "graph_reindex",
           "segment_sum", "segment_mean", "segment_max", "segment_min",
           "identity_loss"]
