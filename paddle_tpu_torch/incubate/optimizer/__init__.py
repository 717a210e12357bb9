"""``paddle.incubate.optimizer`` of the port
(``paddle_tpu/incubate/optimizer``): ``LookAhead``, ``ModelAverage``,
``LBFGS`` and ``DistributedFusedLamb`` over the port's ``Optimizer``
(state on the parameters' device, written in place), and
``functional``'s ``minimize_bfgs``/``minimize_lbfgs``."""
from . import functional  # noqa: F401
from .fused_lamb import DistributedFusedLamb  # noqa: F401
from .lbfgs import LBFGS  # noqa: F401
from .lookahead import LookAhead  # noqa: F401
from .modelaverage import ModelAverage  # noqa: F401

__all__ = ["LookAhead", "ModelAverage", "LBFGS",
           "DistributedFusedLamb"]
