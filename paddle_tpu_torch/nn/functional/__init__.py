"""``paddle.nn.functional`` of the port (``paddle_tpu/nn/functional``):
the functionals of ``activation``, ``attention``, ``common``, ``conv``,
``loss``, ``norm`` and ``pooling``, with the JAX package's signatures
and Paddle's layouts. ``extended`` is not ported yet."""
from . import activation, attention, common, conv, loss, norm, pooling
from .activation import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403

__all__ = (activation.__all__ + attention.__all__ + common.__all__
           + conv.__all__ + loss.__all__ + norm.__all__ + pooling.__all__)
