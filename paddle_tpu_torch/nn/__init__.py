"""The layers and functionals of the port that the GPT and Llama models use,
and gradient clipping.

Counterpart of ``paddle_tpu/nn``: each functional casts its inputs by
the amp rule under the JAX package's op name (:func:`..amp.cast_inputs`),
and each layer is the ``torch.nn`` layer of the same name whose forward
calls that functional. ``clip`` holds the three grad clips an optimizer
takes as ``grad_clip``.
"""
from . import clip, functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer.common import Embedding, Linear
from .layer.norm import LayerNorm, RMSNorm

__all__ = ["clip", "functional", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "Embedding", "Linear", "LayerNorm",
           "RMSNorm"]
