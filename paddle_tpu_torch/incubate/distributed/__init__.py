"""``paddle.incubate.distributed`` (``paddle_tpu/incubate/distributed``)."""
from . import models  # noqa: F401
