"""Pooling layers (``paddle_tpu/nn/layer/pooling.py``): the max,
average, adaptive and unpooling classes over
:mod:`..functional.pooling`, each holding its arguments as the
reference's does."""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer

__all__ = [
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
]


class _PoolBase(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        for k, v in kw.items():
            setattr(self, k, v)


class MaxPool1D(_PoolBase):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, return_mask=return_mask,
                         ceil_mode=ceil_mode)

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode)


class MaxPool2D(_PoolBase):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode, self.data_format)


class MaxPool3D(_PoolBase):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode, self.data_format)


class AvgPool1D(_PoolBase):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, exclusive=exclusive,
                         ceil_mode=ceil_mode)

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive, self.ceil_mode)


class AvgPool2D(_PoolBase):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, exclusive=exclusive,
                         ceil_mode=ceil_mode, divisor_override=divisor_override,
                         data_format=data_format)

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive, self.divisor_override,
                            self.data_format)


class AvgPool3D(_PoolBase):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, exclusive=exclusive,
                         ceil_mode=ceil_mode, divisor_override=divisor_override,
                         data_format=data_format)

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive, self.divisor_override,
                            self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.data_format, self.output_size = data_format, output_size

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format, self.output_size)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.data_format, self.output_size = data_format, output_size

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format, self.output_size)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCDHW",
                 output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.data_format, self.output_size = data_format, output_size

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format, self.output_size)
