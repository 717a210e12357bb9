"""Convolution layers (``paddle_tpu/nn/layer/conv.py``): ``Conv1D``,
``Conv2D``, ``Conv3D`` and their transposes over
:mod:`..functional.conv`.

The weight is Paddle's ``[out, in / groups, *k]`` (a transpose's
``[in, out / groups, *k]``), drawn from ``Uniform(-k, k)`` with ``k =
1 / sqrt(fan_in)``; ``bias_attr=False`` gives no bias. ``padding_mode``
is stored and not used, as in the reference: every convolution pads
with zeros (ROADMAP Queue 3).
"""
from __future__ import annotations

import numpy as np

from .. import functional as F
from ..layer_base import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose"]


def _tuplize(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, transposed,
                 stride=1, padding=0, output_padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW"):
        super().__init__()
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _tuplize(kernel_size, n)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        self._n = n
        if transposed:
            wshape = [in_channels, out_channels // groups] + list(self._kernel_size)
        else:
            wshape = [out_channels, in_channels // groups] + list(self._kernel_size)
        from .. import initializer as I

        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        k = 1.0 / np.sqrt(fan_in) if fan_in else 1.0
        self.weight = self.create_parameter(
            wshape, attr=weight_attr, default_initializer=I.Uniform(-k, k))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, False, stride,
                         padding, 0, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    """2-D convolution layer (reference: nn/layer/conv.py Conv2D).

    Examples:
        >>> conv = paddle.nn.Conv2D(3, 8, kernel_size=3, padding=1)
        >>> out = conv(paddle.to_tensor(np.ones((2, 3, 16, 16), "float32")))
        >>> out.shape
        [2, 8, 16, 16]
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, False, stride,
                         padding, 0, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, False, stride,
                         padding, 0, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, True, stride,
                         padding, output_padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding, self._groups,
                                  self._dilation, output_size, self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, True, stride,
                         padding, output_padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding, self._groups,
                                  self._dilation, output_size, self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, True, stride,
                         padding, output_padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding, self._groups,
                                  self._dilation, output_size, self._data_format)
