"""Functionals of the port (``paddle_tpu/nn/functional``), the subset
GPT's training step uses."""
from .activation import gelu
from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["gelu", "flash_attention", "scaled_dot_product_attention",
           "dropout", "embedding", "linear", "cross_entropy", "layer_norm"]
