"""``paddle.vision`` of the port (``paddle_tpu/vision``): the ``models``
zoo, exported flat as there, and the detection ``ops``. Not ported yet:
``transforms``, ``datasets`` and the image backend (``image.py``)."""
from . import models, ops  # noqa: F401
from .models import *  # noqa: F401,F403

__all__ = ["models", "ops"] + models.__all__
