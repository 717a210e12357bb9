"""hapi — high-level Model API (``paddle_tpu/hapi``; reference:
python/paddle/hapi/). ``hapi.summary`` (the per-layer table) is not
ported yet (ROADMAP Queue 1C item 13(c)); ``Model.summary`` counts
parameters."""
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    VisualDL, WandbCallback)
from .model import Model  # noqa: F401

__all__ = ["Model", "callbacks", "Callback", "ProgBarLogger",
           "ModelCheckpoint", "EarlyStopping", "LRScheduler", "VisualDL",
           "WandbCallback"]
