"""``paddle.sysconfig`` (``paddle_tpu/sysconfig.py``): where the port's
native sources are and where they are built (``ops/_build.py``)."""
from __future__ import annotations

__all__ = ["get_include", "get_lib"]


def get_include() -> str:
    """The native sources: ``paddle_tpu_torch/csrc``."""
    from .ops._build import CSRC

    return str(CSRC)


def get_lib() -> str:
    """Where the native libraries are built."""
    from .ops._build import BUILD_DIR

    return str(BUILD_DIR)
