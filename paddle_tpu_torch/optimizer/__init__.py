"""Optimizers of the port (``paddle_tpu/optimizer``): the base class and
Adam/AdamW."""
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW"]
