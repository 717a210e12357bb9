"""The layers and functionals of the port that the GPT and Llama models use.

Counterpart of ``paddle_tpu/nn``: each functional casts its inputs by
the amp rule under the JAX package's op name (:func:`..amp.cast_inputs`),
and each layer is the ``torch.nn`` layer of the same name whose forward
calls that functional.
"""
from . import functional
from .layer.common import Embedding, Linear
from .layer.norm import LayerNorm, RMSNorm

__all__ = ["functional", "Embedding", "Linear", "LayerNorm", "RMSNorm"]
