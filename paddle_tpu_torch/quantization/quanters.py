"""``paddle.quantization.quanters`` (``paddle_tpu/quantization/quanters.py``)."""
from . import FakeQuanterWithAbsMaxObserver  # noqa: F401

__all__ = ["FakeQuanterWithAbsMaxObserver"]
