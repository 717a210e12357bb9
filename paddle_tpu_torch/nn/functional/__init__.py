"""Functionals of the port (``paddle_tpu/nn/functional``), the subset
the GPT and Llama training steps use."""
from .activation import gelu, silu
from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["gelu", "silu", "flash_attention", "scaled_dot_product_attention",
           "dropout", "embedding", "linear", "cross_entropy", "layer_norm",
           "rms_norm"]
