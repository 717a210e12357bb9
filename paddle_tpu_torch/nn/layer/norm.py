"""Normalization layers (``paddle_tpu/nn/layer/norm.py``): the BatchNorms,
LayerNorm, RMSNorm, GroupNorm, the InstanceNorms, LocalResponseNorm and
SpectralNorm.

BatchNorm's running statistics are buffers (``_mean``, ``_variance``)
that ``functional.batch_norm`` updates in place, so a captured step
moves them at every replay. ``SyncBatchNorm`` is ``BatchNorm`` on one
device (the JAX package reduces its statistics across a ``shard_map``
axis; the port has no cross-replica path yet). These class names keep
their parameters in f32 under ``amp.decorate(level="O2")``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...autograd.engine import apply_op
from ...device import default_device
from ...ops._apply import ensure_tensor
from ...tensor import Tensor
from .. import functional as F
from ..layer_base import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
    "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
    "LocalResponseNorm", "SpectralNorm", "RMSNorm",
]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        from .. import initializer as I

        self.weight = self.create_parameter(
            [num_features], attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)
        dev = default_device()
        self.register_buffer("_mean", Tensor(torch.zeros(num_features, device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(num_features, device=dev)))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum, epsilon=self._epsilon,
            data_format=self._data_format, use_global_stats=self._use_global_stats,
        )

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """Legacy paddle.nn.BatchNorm (fluid BatchNorm layer) — same math."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, **kwargs):
        super().__init__(num_channels, momentum, epsilon, param_attr, bias_attr,
                         data_layout, use_global_stats)
        self._act = act

    def forward(self, x):
        y = super().forward(x)
        if self._act == "relu":
            y = F.relu(y)
        elif self._act:
            y = getattr(F, self._act)(y)
        return y


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCL", use_global_stats=None, name=None):
        df = "NCHW" if data_format in ("NCL", "NC") else "NHWC"
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         df, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None, name=None):
        df = "NCHW" if data_format == "NCDHW" else "NHWC"
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         df, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm; on one device it is BatchNorm (module
    docstring)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """reference: SyncBatchNorm.convert_sync_batchnorm."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum, layer._epsilon,
                                data_format=layer._data_format)
            out.weight = layer.weight
            out.bias = layer.bias
            out.register_buffer("_mean", layer._mean)
            out.register_buffer("_variance", layer._variance)
        for name, sub in list(layer._sub_layers.items()):
            converted = cls.convert_sync_batchnorm(sub)
            if converted is not sub:
                layer._sub_layers[name] = converted
        return out


class LayerNorm(Layer):
    """reference: paddle.nn.LayerNorm (nn/layer/norm.py).

    Examples:
        >>> ln = paddle.nn.LayerNorm(4)
        >>> out = ln(paddle.to_tensor(np.ones((2, 4), "float32")))
        >>> out.shape
        [2, 4]
    """

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        from .. import initializer as I

        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """RMS norm (no reference op — required by Llama family; paddlenlp has a
    fused_rms_norm incubate op)."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        from .. import initializer as I

        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr, default_initializer=I.Constant(1.0))

    def forward(self, x):
        x = ensure_tensor(x)
        eps = self._epsilon

        def fn(a, w):
            var = a.float().pow(2).mean(-1, keepdim=True)
            return a * (1.0 / torch.sqrt(var + eps)).to(a.dtype) * w

        return apply_op(fn, [x, self.weight], name="rms_norm")


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        from .. import initializer as I

        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is False or bias_attr is False:
            self.scale = None
            self.bias = None
        else:
            from .. import initializer as I

            self.scale = self.create_parameter(
                [num_features], attr=weight_attr, default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon, data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self._data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta, self.k,
                                     self._data_format)


class SpectralNorm(Layer):
    """Power-iteration spectral norm of a weight (reference: nn/layer/norm.py
    SpectralNorm)."""

    def __init__(self, weight_shape, dim: int = 0, power_iters: int = 1,
                 epsilon: float = 1e-12, name=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        from .. import initializer as I

        self.weight_u = self.create_parameter([h], default_initializer=I.Normal(0, 1))
        self.weight_v = self.create_parameter([w], default_initializer=I.Normal(0, 1))
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        weight = ensure_tensor(weight)
        dim, iters, eps = self._dim, self._power_iters, self._epsilon
        # power iteration on the host's schedule; u and v persist (in place)
        # so the estimate converges across forward passes
        with torch.no_grad():
            w = weight._value
            wm = w.movedim(dim, 0).reshape(w.shape[dim], -1)
            u, v = self.weight_u._value, self.weight_v._value
            for _ in range(iters):
                v.copy_(wm.T @ u)
                v.div_(torch.linalg.vector_norm(v) + eps)
                u.copy_(wm @ v)
                u.div_(torch.linalg.vector_norm(u) + eps)
        uc, vc = u.clone(), v.clone()

        def fn(w_):
            wm_ = w_.movedim(dim, 0).reshape(w_.shape[dim], -1)
            return w_ / (uc.to(w_.dtype) @ wm_ @ vc.to(w_.dtype))

        return apply_op(fn, [weight], name="spectral_norm")
