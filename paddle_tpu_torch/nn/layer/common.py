"""Common layers (``paddle_tpu/nn/layer/common.py``): Linear, the
dropouts, Embedding, padding, up-sampling, folding and shuffles.

``Linear``'s weight is Paddle's ``[in, out]``; its forward reads it
through a transposed view (``functional.linear``), so no step copies
it. An ``Embedding`` with ``padding_idx`` starts with that row zeroed.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...autograd.engine import apply_op
from ...ops._apply import ensure_tensor
from .. import functional as F
from ..layer_base import Layer

__all__ = [
    "Identity", "Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
    "Embedding", "Flatten", "Upsample", "UpsamplingNearest2D", "UpsamplingBilinear2D",
    "Bilinear", "CosineSimilarity", "PairwiseDistance", "Pad1D", "Pad2D", "Pad3D",
    "ZeroPad2D", "Unfold", "Fold", "PixelShuffle", "PixelUnshuffle", "ChannelShuffle",
]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Linear(Layer):
    """y = xW + b, weight [in, out] (reference: nn/layer/common.py Linear).

    Examples:
        >>> layer = paddle.nn.Linear(4, 3)
        >>> out = layer(paddle.to_tensor(np.ones((2, 4), "float32")))
        >>> out.shape
        [2, 3]
    """

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter([in_features, out_features], attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr, is_bias=True)

    def forward(self, input):
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, out_features={self._out_features}"


class Dropout(Layer):
    def __init__(self, p: float = 0.5, axis=None, mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, input):
        return F.dropout(input, self.p, axis=self.axis, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p: float = 0.5, data_format: str = "NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, input):
        return F.dropout2d(input, self.p, training=self.training, data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p: float = 0.5, data_format: str = "NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, input):
        return F.dropout3d(input, self.p, training=self.training, data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p: float = 0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, input):
        return F.alpha_dropout(input, self.p, training=self.training)


class Embedding(Layer):
    """Lookup table, weight [num_embeddings, embedding_dim]
    (reference: nn/layer/common.py Embedding).

    Examples:
        >>> emb = paddle.nn.Embedding(10, 4)
        >>> out = emb(paddle.to_tensor([[1, 2], [3, 4]]))
        >>> out.shape
        [2, 2, 4]
    """

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        from .. import initializer as I

        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal(),
        )
        if padding_idx is not None:
            pidx = padding_idx if padding_idx >= 0 else num_embeddings + padding_idx
            with torch.no_grad():
                self.weight._value[pidx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(Layer):
    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, input):
        from ...ops import flatten

        return flatten(input, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode: str = "nearest",
                 align_corners: bool = False, align_mode: int = 0,
                 data_format: str = "NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode, self.data_format)


class UpsamplingNearest2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format: str = "NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor, self.data_format = size, scale_factor, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "nearest",
                             data_format=self.data_format)


class UpsamplingBilinear2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format: str = "NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor, self.data_format = size, scale_factor, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "bilinear",
                             align_corners=True, data_format=self.data_format)


class Bilinear(Layer):
    def __init__(self, in1_features: int, in2_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([1, out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis: int = 1, eps: float = 1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p: float = 2.0, epsilon: float = 1e-6,
                 keepdim: bool = False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        x, y = ensure_tensor(x), ensure_tensor(y)
        return apply_op(
            lambda a, b: ((a - b + self.epsilon).abs() ** self.p).sum(
                -1, keepdim=self.keepdim) ** (1.0 / self.p),
            [x, y], name="pairwise_distance",
        )


class _PadNd(Layer):
    def __init__(self, padding, mode, value, data_format):
        super().__init__()
        self.padding, self.mode, self.value, self.data_format = padding, mode, value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: str = "NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: str = "NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: str = "NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format: str = "NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings, self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes, self.kernel_sizes = output_sizes, kernel_sizes
        self.strides, self.paddings, self.dilations = strides, paddings, dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor: int, data_format: str = "NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor: int, data_format: str = "NCHW", name=None):
        super().__init__()
        self.downscale_factor, self.data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups: int, data_format: str = "NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
