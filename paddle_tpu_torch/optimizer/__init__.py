"""Optimizers of the port (``paddle_tpu/optimizer``): the base class, the
nine optimizers and the LR schedulers (``lr``, a copy of the JAX
package's)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         Momentum, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb"]
