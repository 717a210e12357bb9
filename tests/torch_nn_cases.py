"""The layer cases of the ``nn`` twin tests: ``CASES[name] = (make,
inputs[, train])``, ``make(P)`` building a layer from a Paddle namespace
``P`` and ``inputs`` the numpy arrays it is called on; ``LAYERS``
(``VISION``: the conv, pooling and RNN layers among them; ``EXTENDED``:
those of ``nn/layer/extended.py``),
``ACTIVATIONS`` and ``LOSSES`` split them by the module their class
lives in."""
import numpy as np

import paddle_tpu_torch as paddle


def R(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype("float32")


def _ids(shape, hi, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape)


def _lbl(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 2, shape).astype("f4")


X4 = (2, 4, 6, 6)
CASES = {
    # common
    "Identity": (lambda P: P.nn.Identity(), [R(2, 3)]),
    "Linear": (lambda P: P.nn.Linear(5, 3), [R(2, 4, 5)]),
    "Linear_no_bias": (lambda P: P.nn.Linear(5, 3, bias_attr=False),
                       [R(2, 5)]),
    "Dropout_eval": (lambda P: P.nn.Dropout(0.3), [R(3, 4)], False),
    "Dropout_downscale_eval": (
        lambda P: P.nn.Dropout(0.3, mode="downscale_in_infer"), [R(3, 4)],
        False),
    "Dropout2D_eval": (lambda P: P.nn.Dropout2D(0.3), [R(*X4)], False),
    "Dropout3D_eval": (lambda P: P.nn.Dropout3D(0.3), [R(2, 3, 2, 2, 2)],
                       False),
    "AlphaDropout_eval": (lambda P: P.nn.AlphaDropout(0.3), [R(3, 4)],
                          False),
    "Embedding": (lambda P: P.nn.Embedding(11, 4), [_ids((2, 5), 11)]),
    "Flatten": (lambda P: P.nn.Flatten(), [R(2, 3, 4)]),
    "Upsample": (lambda P: P.nn.Upsample(scale_factor=2), [R(*X4)]),
    "Upsample_bilinear": (lambda P: P.nn.Upsample(size=[9, 7],
                                                  mode="bilinear"),
                          [R(*X4)]),
    "UpsamplingNearest2D": (lambda P: P.nn.UpsamplingNearest2D(size=[8, 9]),
                            [R(*X4)]),
    "UpsamplingBilinear2D": (
        lambda P: P.nn.UpsamplingBilinear2D(scale_factor=2), [R(*X4)]),
    "Bilinear": (lambda P: P.nn.Bilinear(3, 4, 5),
                 [R(2, 3), R(2, 4, seed=1)]),
    "CosineSimilarity": (lambda P: P.nn.CosineSimilarity(axis=1),
                         [R(3, 5), R(3, 5, seed=1)]),
    "PairwiseDistance": (lambda P: P.nn.PairwiseDistance(keepdim=True),
                         [R(3, 5), R(3, 5, seed=1)]),
    "Pad1D": (lambda P: P.nn.Pad1D([1, 2], mode="reflect"), [R(2, 3, 5)]),
    "Pad2D": (lambda P: P.nn.Pad2D([1, 0, 2, 1], mode="replicate"),
              [R(*X4)]),
    "Pad3D": (lambda P: P.nn.Pad3D([1, 1, 0, 1, 1, 0], value=2.0),
              [R(1, 2, 3, 3, 3)]),
    "ZeroPad2D": (lambda P: P.nn.ZeroPad2D([1, 2, 0, 1]), [R(*X4)]),
    "Unfold": (lambda P: P.nn.Unfold([2, 3], strides=1, paddings=1),
               [R(*X4)]),
    "Fold": (lambda P: P.nn.Fold([5, 5], 2, strides=1), [R(2, 8, 16)]),
    "PixelShuffle": (lambda P: P.nn.PixelShuffle(2), [R(2, 8, 3, 3)]),
    "PixelUnshuffle": (lambda P: P.nn.PixelUnshuffle(2, "NHWC"),
                       [R(2, 4, 4, 3)]),
    "ChannelShuffle": (lambda P: P.nn.ChannelShuffle(2), [R(*X4)]),
    # containers
    "Sequential": (lambda P: P.nn.Sequential(
        P.nn.Linear(4, 6), P.nn.GELU(), P.nn.Linear(6, 2)), [R(3, 4)]),
    "LayerList": (lambda P: _Chain(P, P.nn.LayerList(
        [P.nn.Linear(4, 4), P.nn.Tanh(), P.nn.Linear(4, 3)])), [R(3, 4)]),
    "ParameterList": (lambda P: _Params(P), [R(3, 4)]),
    "LayerDict": (lambda P: _Chain(P, P.nn.LayerDict(
        [("a", P.nn.Linear(4, 5)), ("b", P.nn.Sigmoid())])), [R(3, 4)]),
    # norms
    "BatchNorm": (lambda P: P.nn.BatchNorm(4, act="relu"), [R(*X4)]),
    "BatchNorm1D": (lambda P: P.nn.BatchNorm1D(4), [R(6, 4)]),
    "BatchNorm2D_eval": (lambda P: P.nn.BatchNorm2D(4), [R(*X4)], False),
    "BatchNorm3D": (lambda P: P.nn.BatchNorm3D(3), [R(2, 3, 2, 3, 2)]),
    # the JAX package's SyncBatchNorm imports a name its distributed
    # package lacks: on one device it is its BatchNorm2D, held here
    "SyncBatchNorm": (lambda P: P.nn.SyncBatchNorm(4) if P is paddle
                      else P.nn.BatchNorm2D(4), [R(*X4)]),
    "LayerNorm": (lambda P: P.nn.LayerNorm([3, 4]), [R(2, 3, 4)]),
    "RMSNorm": (lambda P: P.nn.RMSNorm(6), [R(2, 3, 6)]),
    "GroupNorm": (lambda P: P.nn.GroupNorm(2, 4), [R(*X4)]),
    "InstanceNorm1D": (lambda P: P.nn.InstanceNorm1D(3), [R(2, 3, 7)]),
    "InstanceNorm2D": (lambda P: P.nn.InstanceNorm2D(4), [R(*X4)]),
    "InstanceNorm3D": (lambda P: P.nn.InstanceNorm3D(3),
                       [R(2, 3, 2, 3, 2)]),
    "LocalResponseNorm": (lambda P: P.nn.LocalResponseNorm(3),
                          [R(*X4)]),
    "SpectralNorm": (lambda P: P.nn.SpectralNorm([4, 5], power_iters=3),
                     [R(4, 5)]),
    # transformer
    "MultiHeadAttention": (lambda P: P.nn.MultiHeadAttention(
        8, 2, kdim=6, vdim=5), [R(2, 3, 8), R(2, 4, 6, seed=1),
                                R(2, 4, 5, seed=2)]),
    "TransformerEncoderLayer": (lambda P: P.nn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0, normalize_before=True), [R(2, 5, 8)]),
    "TransformerEncoder": (lambda P: P.nn.TransformerEncoder(
        P.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                     activation="gelu"), 2,
        P.nn.LayerNorm(8)), [R(2, 5, 8)]),
    "TransformerDecoderLayer": (lambda P: P.nn.TransformerDecoderLayer(
        8, 2, 16, dropout=0.0), [R(2, 3, 8), R(2, 5, 8, seed=1)]),
    "TransformerDecoder": (lambda P: P.nn.TransformerDecoder(
        P.nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0,
                                     normalize_before=True), 2),
        [R(2, 3, 8), R(2, 5, 8, seed=1)]),
    "Transformer": (lambda P: P.nn.Transformer(
        8, 2, 1, 1, 16, dropout=0.0, normalize_before=True),
        [R(2, 5, 8), R(2, 3, 8, seed=1)]),
}

_VISION = {
    # conv
    "Conv1D": (lambda P: P.nn.Conv1D(3, 4, 3, stride=2, padding=1),
               [R(2, 3, 9)]),
    "Conv2D": (lambda P: P.nn.Conv2D(4, 6, 3, padding=1, groups=2),
               [R(*X4)]),
    "Conv2D_nhwc_no_bias": (lambda P: P.nn.Conv2D(
        4, 5, [3, 2], stride=2, padding="SAME", bias_attr=False,
        data_format="NHWC"), [R(2, 6, 7, 4)]),
    "Conv2D_padding_mode_reflect": (lambda P: P.nn.Conv2D(
        4, 3, 3, padding=1, padding_mode="reflect"), [R(*X4)]),
    "Conv3D": (lambda P: P.nn.Conv3D(2, 3, 2, padding=[1, 0, 1]),
               [R(1, 2, 4, 4, 4)]),
    "Conv1DTranspose": (lambda P: P.nn.Conv1DTranspose(
        3, 4, 3, stride=2, padding=1, output_padding=1), [R(2, 3, 5)]),
    "Conv2DTranspose": (lambda P: P.nn.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, groups=2), [R(*X4)]),
    "Conv3DTranspose": (lambda P: P.nn.Conv3DTranspose(2, 3, 2, stride=2),
                        [R(1, 2, 3, 3, 3)]),
    # pooling
    "MaxPool1D": (lambda P: P.nn.MaxPool1D(3, 2, 1, ceil_mode=True),
                  [R(2, 3, 10)]),
    "MaxPool2D": (lambda P: P.nn.MaxPool2D(3, 2, 1), [R(*X4)]),
    "MaxPool3D": (lambda P: P.nn.MaxPool3D(2, 2, 1), [R(1, 2, 4, 5, 4)]),
    "AvgPool1D": (lambda P: P.nn.AvgPool1D(3, 2, 1, exclusive=False),
                  [R(2, 3, 10)]),
    "AvgPool2D": (lambda P: P.nn.AvgPool2D(3, 2, 1, ceil_mode=True),
                  [R(*X4)]),
    "AvgPool3D": (lambda P: P.nn.AvgPool3D(2, divisor_override=3),
                  [R(1, 2, 4, 4, 4)]),
    "AdaptiveAvgPool1D": (lambda P: P.nn.AdaptiveAvgPool1D(3),
                          [R(2, 3, 10)]),
    "AdaptiveAvgPool2D": (lambda P: P.nn.AdaptiveAvgPool2D([2, 3]),
                          [R(2, 3, 5, 7)]),
    "AdaptiveAvgPool3D": (lambda P: P.nn.AdaptiveAvgPool3D([1, 2, 1]),
                          [R(1, 2, 3, 5, 4)]),
    "AdaptiveMaxPool1D": (lambda P: P.nn.AdaptiveMaxPool1D(
        3, return_mask=True), [R(2, 3, 10)]),
    "AdaptiveMaxPool2D": (lambda P: P.nn.AdaptiveMaxPool2D([2, 3]),
                          [R(2, 3, 5, 7)]),
    "AdaptiveMaxPool3D": (lambda P: P.nn.AdaptiveMaxPool3D([1, 2, 1]),
                          [R(1, 2, 3, 5, 4)]),
    "MaxUnPool1D": (lambda P: _Unpool(P, 1), [R(2, 3, 8)]),
    "MaxUnPool2D": (lambda P: _Unpool(P, 2), [R(*X4)]),
    "MaxUnPool3D": (lambda P: _Unpool(P, 3), [R(1, 2, 4, 4, 4)]),
    # rnn
    "SimpleRNNCell": (lambda P: P.nn.SimpleRNNCell(4, 6), [R(3, 4)]),
    "LSTMCell": (lambda P: P.nn.LSTMCell(4, 5), [R(3, 4)]),
    "GRUCell": (lambda P: P.nn.GRUCell(4, 5), [R(3, 4)]),
    "RNN_reverse": (lambda P: P.nn.RNN(P.nn.SimpleRNNCell(4, 5),
                                       is_reverse=True), [R(2, 5, 4)]),
    "BiRNN": (lambda P: P.nn.BiRNN(P.nn.GRUCell(4, 5), P.nn.GRUCell(4, 5)),
              [R(2, 5, 4)]),
    "SimpleRNN": (lambda P: P.nn.SimpleRNN(4, 5, 2, "bidirect"),
                  [R(2, 5, 4)]),
    "LSTM": (lambda P: P.nn.LSTM(4, 5, 2, time_major=True), [R(5, 2, 4)]),
    "GRU": (lambda P: P.nn.GRU(4, 5, 2, "bidirect"), [R(2, 5, 4)]),
}
VISION = dict(_VISION)
CASES.update(_VISION)

_ACT = {
    "CELU": lambda P: P.nn.CELU(0.7), "ELU": lambda P: P.nn.ELU(0.5),
    "GELU": lambda P: P.nn.GELU(), "GELU_tanh": lambda P: P.nn.GELU(True),
    "GLU": lambda P: P.nn.GLU(), "Hardshrink": lambda P: P.nn.Hardshrink(),
    "Hardsigmoid": lambda P: P.nn.Hardsigmoid(),
    "Hardswish": lambda P: P.nn.Hardswish(),
    "Hardtanh": lambda P: P.nn.Hardtanh(-0.5, 0.7),
    "LeakyReLU": lambda P: P.nn.LeakyReLU(0.2),
    "LogSigmoid": lambda P: P.nn.LogSigmoid(),
    "LogSoftmax": lambda P: P.nn.LogSoftmax(0),
    "Maxout": lambda P: P.nn.Maxout(2, axis=-1),
    "Mish": lambda P: P.nn.Mish(),
    "PReLU": lambda P: P.nn.PReLU(4, 0.1, data_format="NLC"),
    "ReLU": lambda P: P.nn.ReLU(), "ReLU6": lambda P: P.nn.ReLU6(),
    "RReLU_eval": lambda P: P.nn.RReLU(),
    "SELU": lambda P: P.nn.SELU(), "Sigmoid": lambda P: P.nn.Sigmoid(),
    "Silu": lambda P: P.nn.Silu(), "Softmax": lambda P: P.nn.Softmax(),
    "Softplus": lambda P: P.nn.Softplus(2.0, 3.0),
    "Softshrink": lambda P: P.nn.Softshrink(0.3),
    "Softsign": lambda P: P.nn.Softsign(), "Swish": lambda P: P.nn.Swish(),
    "Tanh": lambda P: P.nn.Tanh(), "Tanhshrink": lambda P: P.nn.Tanhshrink(),
    "ThresholdedReLU": lambda P: P.nn.ThresholdedReLU(0.4, -1.0),
}
ACTIVATIONS = {name: (make, [R(3, 5, 4, scale=3.0)], "eval" not in name)
               for name, make in _ACT.items()}
LAYERS = dict(CASES)
CASES.update(ACTIVATIONS)

# the Layers of nn/layer/extended.py
EXTENDED = {
    "Softmax2D": (lambda P: P.nn.Softmax2D(), [R(2, 3, 4, 4)]),
    "Softmax2D_chw": (lambda P: P.nn.Softmax2D(), [R(3, 4, 5)]),
    "HSigmoidLoss": (lambda P: P.nn.HSigmoidLoss(8, 6),
                     [R(5, 8), _ids((5, 1), 6)]),
    "HSigmoidLoss_no_bias": (lambda P: P.nn.HSigmoidLoss(
        8, 5, bias_attr=False), [R(4, 8), _ids((4,), 5, seed=1)]),
    "MultiMarginLoss": (lambda P: P.nn.MultiMarginLoss(p=2, margin=0.5),
                        [R(5, 4), _ids(5, 4)]),
    "RNNTLoss": (lambda P: P.nn.RNNTLoss(reduction="sum"),
                 [R(2, 4, 3, 5), _ids((2, 2), 4) + 1, np.array([4, 3]),
                  np.array([2, 1])]),
}
LAYERS.update(EXTENDED)
CASES.update(EXTENDED)

_LOSS = {
    "CrossEntropyLoss": (lambda P: P.nn.CrossEntropyLoss(
        ignore_index=1, label_smoothing=0.05), [R(6, 5), _ids(6, 5)]),
    "NLLLoss": (lambda P: P.nn.NLLLoss(reduction="sum"),
                [R(4, 5, 3), _ids((4, 3), 5)]),
    "MSELoss": (lambda P: P.nn.MSELoss(), [R(4, 3), R(4, 3, seed=1)]),
    "L1Loss": (lambda P: P.nn.L1Loss("sum"), [R(4, 3), R(4, 3, seed=1)]),
    "BCELoss": (lambda P: P.nn.BCELoss(),
                [1 / (1 + np.exp(-R(4, 3))), _lbl((4, 3))]),
    "BCEWithLogitsLoss": (lambda P: P.nn.BCEWithLogitsLoss(
        pos_weight=P.to_tensor(np.full(3, 2.0, "f4"))),
        [R(4, 3), _lbl((4, 3))]),
    "SmoothL1Loss": (lambda P: P.nn.SmoothL1Loss(delta=0.5),
                     [R(4, 3), R(4, 3, seed=1)]),
    "KLDivLoss": (lambda P: P.nn.KLDivLoss("sum"),
                  [R(4, 3), np.abs(R(4, 3, seed=1))]),
    "MarginRankingLoss": (lambda P: P.nn.MarginRankingLoss(0.1),
                          [R(5), R(5, seed=1), 2 * _ids(5, 2) - 1]),
    "HingeEmbeddingLoss": (lambda P: P.nn.HingeEmbeddingLoss(),
                           [R(5), 2 * _ids(5, 2) - 1]),
    "CosineEmbeddingLoss": (lambda P: P.nn.CosineEmbeddingLoss(0.2),
                            [R(4, 6), R(4, 6, seed=1), 2 * _ids(4, 2) - 1]),
    "CTCLoss": (lambda P: P.nn.CTCLoss(blank=0),
                [R(6, 2, 5), _ids((2, 3), 4) + 1, np.array([6, 5]),
                 np.array([3, 2])]),
    "SigmoidFocalLoss": (lambda P: P.nn.SigmoidFocalLoss(),
                         [R(4, 3), _lbl((4, 3))]),
    "TripletMarginLoss": (lambda P: P.nn.TripletMarginLoss(swap=True),
                          [R(4, 5), R(4, 5, seed=1), R(4, 5, seed=2)]),
    "TripletMarginWithDistanceLoss": (
        lambda P: P.nn.TripletMarginWithDistanceLoss(
            distance_function=lambda a, b: ((a - b) ** 2).sum(-1)),
        [R(4, 5), R(4, 5, seed=1), R(4, 5, seed=2)]),
    "MultiLabelSoftMarginLoss": (lambda P: P.nn.MultiLabelSoftMarginLoss(),
                                 [R(4, 3), _lbl((4, 3))]),
    "SoftMarginLoss": (lambda P: P.nn.SoftMarginLoss(),
                       [R(4, 3), 2 * _lbl((4, 3)) - 1]),
    "PoissonNLLLoss": (lambda P: P.nn.PoissonNLLLoss(full=True),
                       [R(4, 3), 3 * np.abs(R(4, 3, seed=1))]),
    "GaussianNLLLoss": (lambda P: P.nn.GaussianNLLLoss(full=True),
                        [R(4, 3), R(4, 3, seed=1),
                         np.abs(R(4, 3, seed=2)) + 0.1]),
}
LOSSES = dict(_LOSS)
CASES.update(_LOSS)


class _Chain:
    """A Layer applying a container's layers in turn (LayerList,
    LayerDict hold layers but have no forward)."""

    def __new__(cls, P, container):
        class Chain(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.body = container

            def forward(self, x):
                layers = (self.body.values() if hasattr(self.body, "values")
                          else self.body)
                for layer in layers:
                    x = layer(x)
                return x
        return Chain()


def _Params(P):
    class Params(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ps = P.nn.ParameterList([
                self.create_parameter([4, 3]),
                self.create_parameter([3], is_bias=True)])
            self.ps.append(self.create_parameter([3]))

        def forward(self, x):
            return P.matmul(x, self.ps[0]) + self.ps[1] * self.ps[-1]
    return Params()


def _Unpool(P, n):
    """A max pool with its mask, then the unpool of that dimension."""
    class Unpool(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.pool = getattr(P.nn, f"MaxPool{n}D")(2, return_mask=True)
            self.unpool = getattr(P.nn, f"MaxUnPool{n}D")(2)

        def forward(self, x):
            return self.unpool(*self.pool(x))
    return Unpool()
