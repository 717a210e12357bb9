"""``paddle.incubate`` (``paddle_tpu/incubate``): experimental APIs.

Ported: ``distributed.models.moe``, the mixture-of-experts layer with its
gates, capacity utilities and grad clip, expert-parallel on
``all_to_all``. The JAX package's other families here (``autograd``,
the fused ``nn`` layers, ``asp``, ``optimizer``, ``autotune`` and the
graph and segment ops) are not ported yet.
"""
from . import distributed  # noqa: F401

__all__ = ["distributed"]
