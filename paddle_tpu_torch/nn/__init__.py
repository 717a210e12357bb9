"""``paddle.nn`` of the port (``paddle_tpu/nn``).

``Layer`` (:mod:`.layer_base`) over facade Parameters, ``ParamAttr``,
the ``initializer`` and ``utils`` modules, the grad clips, the
functionals (``functional``) and the layer classes of ``layer.common``,
``layer.activation``, ``layer.container``, ``layer.conv``,
``layer.norm``, ``layer.loss``, ``layer.pooling``, ``layer.rnn``,
``layer.transformer`` and ``layer.extended`` (``Softmax2D``, the
hierarchical-sigmoid, multi-margin and RNN-T losses, beam search),
exported flat as Paddle does, and ``quant`` (``Stub``).

The port's GPT and Llama are ``torch.nn.Module``s built from the
torch-layout layers of ``models/_modules.py``, not from these.
"""
from . import functional, initializer, utils
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (activation, common, container, conv, extended, loss,
                    norm, pooling, rnn, transformer)
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.container import *  # noqa: F401,F403
from .layer.conv import *  # noqa: F401,F403
from .layer.extended import *  # noqa: F401,F403
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.pooling import *  # noqa: F401,F403
from .layer.rnn import *  # noqa: F401,F403
from .layer.transformer import *  # noqa: F401,F403
from .layer_base import Layer
from .param_attr import ParamAttr

__all__ = (["functional", "initializer", "utils", "clip", "Layer",
            "ParamAttr", "ClipGradByValue", "ClipGradByNorm",
            "ClipGradByGlobalNorm"]
           + activation.__all__ + common.__all__ + container.__all__
           + conv.__all__ + extended.__all__ + loss.__all__ + norm.__all__ + pooling.__all__
           + rnn.__all__ + transformer.__all__)

from . import clip  # noqa: E402
from . import quant  # noqa: E402,F401
