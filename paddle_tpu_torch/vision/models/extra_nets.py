"""DenseNet, ShuffleNetV2, GoogLeNet and InceptionV3
(``paddle_tpu/vision/models/extra_nets.py``).

Built as the JAX package builds them, over the port's ``nn``, so weights
carry across with ``set_state_dict``. GoogLeNet returns ``(out, aux1,
aux2)`` in training and ``out`` in eval; InceptionV3 takes inputs of at
least 75 x 75 (299 x 299 as published). ShuffleNetV2's units shuffle
channels with ``F.channel_shuffle``. ``pretrained=True`` raises: no
weights ship.
"""
from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...ops.manipulation import concat

__all__ = [
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "GoogLeNet", "googlenet", "InceptionV3",
    "inception_v3",
]

_NO_WEIGHTS = ("pretrained weights are not bundled; load a state_dict "
               "with model.set_state_dict")


# ---------------------------------------------------------------- DenseNet
class _DenseLayer(nn.Layer):
    def __init__(self, in_ch, growth_rate, bn_size, drop_rate):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(in_ch)
        self.conv1 = nn.Conv2D(in_ch, bn_size * growth_rate, 1, bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3, padding=1,
                               bias_attr=False)
        self.drop_rate = drop_rate

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        if self.drop_rate:
            out = F.dropout(out, self.drop_rate, training=self.training)
        return concat([x, out], axis=1)


class _Transition(nn.Layer):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.norm = nn.BatchNorm2D(in_ch)
        self.conv = nn.Conv2D(in_ch, out_ch, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, 2)

    def forward(self, x):
        return self.pool(self.conv(F.relu(self.norm(x))))


_DENSE_CFG = {
    121: (32, [6, 12, 24, 16], 64), 161: (48, [6, 12, 36, 24], 96),
    169: (32, [6, 12, 32, 32], 64), 201: (32, [6, 12, 48, 32], 64),
    264: (32, [6, 12, 64, 48], 64),
}


class DenseNet(nn.Layer):
    """reference: vision/models/densenet.py."""

    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        growth, block_cfg, num_init = _DENSE_CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        feats = [
            nn.Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False),
            nn.BatchNorm2D(num_init), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
        ]
        ch = num_init
        for i, n in enumerate(block_cfg):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if i != len(block_cfg) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        feats += [nn.BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _densenet(layers, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)


# ------------------------------------------------------------ ShuffleNetV2
def _channel_shuffle(x, groups):
    return F.channel_shuffle(x, groups)


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, act_layer=None):
        super().__init__()
        self.stride = stride
        act_layer = act_layer or nn.ReLU
        branch = out_ch // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                nn.Conv2D(branch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), act_layer(),
                nn.Conv2D(branch, branch, 3, stride=1, padding=1, groups=branch,
                          bias_attr=False),
                nn.BatchNorm2D(branch),
                nn.Conv2D(branch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), act_layer(),
            )
        else:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_ch, in_ch, 3, stride=stride, padding=1,
                          groups=in_ch, bias_attr=False),
                nn.BatchNorm2D(in_ch),
                nn.Conv2D(in_ch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), act_layer(),
            )
            self.branch2 = nn.Sequential(
                nn.Conv2D(in_ch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), act_layer(),
                nn.Conv2D(branch, branch, 3, stride=stride, padding=1,
                          groups=branch, bias_attr=False),
                nn.BatchNorm2D(branch),
                nn.Conv2D(branch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), act_layer(),
            )

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1, x2 = x[:, :c], x[:, c:]
            out = concat([x1, self.branch2(x2)], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return _channel_shuffle(out, 2)


_SHUFFLE_CFG = {
    0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048],
}


class ShuffleNetV2(nn.Layer):
    """reference: vision/models/shufflenetv2.py."""

    def __init__(self, scale=1.0, act="relu", num_classes=1000, with_pool=True):
        super().__init__()
        cfg = _SHUFFLE_CFG[scale]
        act_layer = {"relu": nn.ReLU, "swish": nn.Swish}.get(act)
        if act_layer is None:
            raise ValueError(f"unsupported act {act!r}; use 'relu'/'swish'")
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, cfg[0], 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(cfg[0]), act_layer(),
        )
        self.maxpool = nn.MaxPool2D(3, 2, padding=1)
        stages = []
        in_ch = cfg[0]
        for i, (out_ch, repeat) in enumerate(zip(cfg[1:4], [4, 8, 4])):
            units = [_ShuffleUnit(in_ch, out_ch, 2, act_layer)]
            for _ in range(repeat - 1):
                units.append(_ShuffleUnit(out_ch, out_ch, 1, act_layer))
            stages.append(nn.Sequential(*units))
            in_ch = out_ch
        self.stages = nn.Sequential(*stages)
        self.conv_last = nn.Sequential(
            nn.Conv2D(in_ch, cfg[4], 1, bias_attr=False),
            nn.BatchNorm2D(cfg[4]), act_layer(),
        )
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(cfg[4], num_classes)

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        x = self.stages(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _shufflenet(scale, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return ShuffleNetV2(scale=scale, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    """reference: shufflenet_v2_swish — the x1.0 net with swish
    activations throughout."""
    return _shufflenet(1.0, pretrained, act="swish", **kwargs)


# -------------------------------------------------------------- GoogLeNet
class _Inception(nn.Layer):
    def __init__(self, in_ch, c1, c2_red, c2, c3_red, c3, c4):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(in_ch, c1, 1), nn.ReLU())
        self.b2 = nn.Sequential(
            nn.Conv2D(in_ch, c2_red, 1), nn.ReLU(),
            nn.Conv2D(c2_red, c2, 3, padding=1), nn.ReLU())
        self.b3 = nn.Sequential(
            nn.Conv2D(in_ch, c3_red, 1), nn.ReLU(),
            nn.Conv2D(c3_red, c3, 5, padding=2), nn.ReLU())
        self.b4 = nn.Sequential(
            nn.MaxPool2D(3, 1, padding=1), nn.Conv2D(in_ch, c4, 1), nn.ReLU())

    def forward(self, x):
        return concat(
            [self.b1(x), self.b2(x), self.b3(x), self.b4(x)], axis=1)


class GoogLeNet(nn.Layer):
    """reference: vision/models/googlenet.py (aux heads active in training)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
            nn.Conv2D(64, 64, 1), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
        )
        self.inc3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.inc3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2, padding=1)
        self.inc4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.inc4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.inc4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.inc4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.inc4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2, padding=1)
        self.inc5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.inc5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)
            # aux classifiers (reference returns (out, aux1, aux2))
            self.aux1 = nn.Sequential(
                nn.AdaptiveAvgPool2D((4, 4)), nn.Conv2D(512, 128, 1), nn.ReLU(),
                nn.Flatten(), nn.Linear(2048, 1024), nn.ReLU(), nn.Dropout(0.7),
                nn.Linear(1024, num_classes))
            self.aux2 = nn.Sequential(
                nn.AdaptiveAvgPool2D((4, 4)), nn.Conv2D(528, 128, 1), nn.ReLU(),
                nn.Flatten(), nn.Linear(2048, 1024), nn.ReLU(), nn.Dropout(0.7),
                nn.Linear(1024, num_classes))

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        aux1 = self.aux1(x) if (self.training and self.num_classes > 0) else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if (self.training and self.num_classes > 0) else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        if self.training and self.num_classes > 0:
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return GoogLeNet(**kwargs)


# ------------------------------------------------------------- InceptionV3
class _BasicConv(nn.Layer):
    def __init__(self, in_ch, out_ch, k, **kw):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, k, bias_attr=False, **kw)
        self.bn = nn.BatchNorm2D(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _InceptionA(nn.Layer):
    def __init__(self, in_ch, pool_ch):
        super().__init__()
        self.b1 = _BasicConv(in_ch, 64, 1)
        self.b5 = nn.Sequential(_BasicConv(in_ch, 48, 1),
                                _BasicConv(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_BasicConv(in_ch, 64, 1),
                                _BasicConv(64, 96, 3, padding=1),
                                _BasicConv(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _BasicConv(in_ch, pool_ch, 1))

    def forward(self, x):
        return concat(
            [self.b1(x), self.b5(x), self.b3(x), self.bp(x)], axis=1)


class _InceptionB(nn.Layer):
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = _BasicConv(in_ch, 384, 3, stride=2)
        self.b3d = nn.Sequential(_BasicConv(in_ch, 64, 1),
                                 _BasicConv(64, 96, 3, padding=1),
                                 _BasicConv(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class _InceptionC(nn.Layer):
    def __init__(self, in_ch, c7):
        super().__init__()
        self.b1 = _BasicConv(in_ch, 192, 1)
        self.b7 = nn.Sequential(
            _BasicConv(in_ch, c7, 1),
            _BasicConv(c7, c7, (1, 7), padding=(0, 3)),
            _BasicConv(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _BasicConv(in_ch, c7, 1),
            _BasicConv(c7, c7, (7, 1), padding=(3, 0)),
            _BasicConv(c7, c7, (1, 7), padding=(0, 3)),
            _BasicConv(c7, c7, (7, 1), padding=(3, 0)),
            _BasicConv(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _BasicConv(in_ch, 192, 1))

    def forward(self, x):
        return concat(
            [self.b1(x), self.b7(x), self.b7d(x), self.bp(x)], axis=1)


class _InceptionD(nn.Layer):
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = nn.Sequential(_BasicConv(in_ch, 192, 1),
                                _BasicConv(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _BasicConv(in_ch, 192, 1),
            _BasicConv(192, 192, (1, 7), padding=(0, 3)),
            _BasicConv(192, 192, (7, 1), padding=(3, 0)),
            _BasicConv(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class _InceptionE(nn.Layer):
    def __init__(self, in_ch):
        super().__init__()
        self.b1 = _BasicConv(in_ch, 320, 1)
        self.b3_stem = _BasicConv(in_ch, 384, 1)
        self.b3_a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = nn.Sequential(_BasicConv(in_ch, 448, 1),
                                      _BasicConv(448, 384, 3, padding=1))
        self.b3d_a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _BasicConv(in_ch, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        b3 = concat([self.b3_a(s), self.b3_b(s)], axis=1)
        d = self.b3d_stem(x)
        b3d = concat([self.b3d_a(d), self.b3d_b(d)], axis=1)
        return concat([self.b1(x), b3, b3d, self.bp(x)], axis=1)


class InceptionV3(nn.Layer):
    """reference: vision/models/inceptionv3.py (299x299 inputs)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _BasicConv(3, 32, 3, stride=2), _BasicConv(32, 32, 3),
            _BasicConv(32, 64, 3, padding=1), nn.MaxPool2D(3, 2),
            _BasicConv(64, 80, 1), _BasicConv(80, 192, 3), nn.MaxPool2D(3, 2),
        )
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64), _InceptionA(288, 64),
            _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160), _InceptionC(768, 160),
            _InceptionC(768, 192),
            _InceptionD(768),
            _InceptionE(1280), _InceptionE(2048),
        )
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return InceptionV3(**kwargs)
