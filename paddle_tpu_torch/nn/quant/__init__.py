"""``paddle.nn.quant`` (``paddle_tpu/nn/quant/__init__.py``): ``Stub``,
the identity placeholder that marks where an input is observed or
quantized; it runs its observer when given one."""
from ..layer_base import Layer

__all__ = ["Stub"]


class Stub(Layer):
    def __init__(self, observer=None):
        super().__init__()
        self._observer = observer

    def forward(self, input):
        if self._observer is not None:
            return self._observer(input)
        return input
