"""paddle.callbacks facade (``paddle_tpu/callbacks.py``; reference:
python/paddle/callbacks.py —
re-exports the hapi callbacks; same 8-name __all__)."""
from .hapi.callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
    ReduceLROnPlateau,
    VisualDL,
    WandbCallback,
)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau",
           "WandbCallback"]
