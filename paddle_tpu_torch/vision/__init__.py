"""``paddle.vision`` of the port (``paddle_tpu/vision``): the ``models``
ported so far, exported flat as there. Not ported yet: ``transforms``,
``datasets``, ``ops``, the image backend and the other model files."""
from . import models
from .models import *  # noqa: F401,F403

__all__ = ["models"] + models.__all__
