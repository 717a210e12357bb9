"""hapi — high-level Model API (``paddle_tpu/hapi``; reference:
python/paddle/hapi/), with ``summary``, the per-layer table
(:mod:`.summary`); ``Model.summary`` counts parameters."""
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    VisualDL, WandbCallback)
from .model import Model  # noqa: F401
from .summary import summary  # noqa: F401

__all__ = ["Model", "callbacks", "Callback", "ProgBarLogger",
           "ModelCheckpoint", "EarlyStopping", "LRScheduler", "VisualDL",
           "WandbCallback", "summary"]
