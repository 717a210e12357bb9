"""``paddle.incubate.distributed.models``: the MoE layer (``moe``)."""
from . import moe  # noqa: F401
