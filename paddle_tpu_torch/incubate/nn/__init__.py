"""``paddle.incubate.nn`` of the port (``paddle_tpu/incubate/nn``): the
fused layers and their functionals (:mod:`.layer`, :mod:`.functional`).
"""
from . import functional  # noqa: F401
from .layer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd, FusedEcMoe,
    FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
    FusedMultiTransformer, FusedTransformerEncoderLayer,
)

__all__ = [
    "FusedMultiHeadAttention", "FusedFeedForward",
    "FusedTransformerEncoderLayer", "FusedMultiTransformer", "FusedLinear",
    "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm", "FusedEcMoe",
    "functional",
]
