"""``paddle.utils`` of the port: ``flops`` (:mod:`.flops`). The rest of
the JAX package's ``utils`` is not ported yet."""
from .flops import flops  # noqa: F401

__all__ = ["flops"]
