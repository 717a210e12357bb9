"""MobileNet V1, V2 and V3 (``paddle_tpu/vision/models/mobilenet.py``).

Depthwise-separable stacks over the port's ``nn``: each depthwise conv is
``Conv2D(groups=channels)``, cuDNN's grouped convolution on the card;
V3 adds ``Hardswish`` and the squeeze-excitation block (``_SEBlock``).
The layers and their names are the JAX package's, so weights carry across
with ``set_state_dict``. ``pretrained=True`` raises: no weights ship.
"""
from __future__ import annotations

from ... import nn
from ...nn import functional as F

__all__ = [
    "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
    "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
    "mobilenet_v3_large",
]

_NO_WEIGHTS = ("pretrained weights are not bundled; load a state_dict "
               "with model.set_state_dict")


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNReLU(nn.Sequential):
    def __init__(self, in_ch, out_ch, k=3, stride=1, groups=1, act=nn.ReLU):
        pad = (k - 1) // 2
        layers = [
            nn.Conv2D(in_ch, out_ch, k, stride=stride, padding=pad,
                      groups=groups, bias_attr=False),
            nn.BatchNorm2D(out_ch),
        ]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


class MobileNetV1(nn.Layer):
    """reference: vision/models/mobilenetv1.py — depthwise-separable stack."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # (out, stride) per dw/pw pair
            (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1),
        ]
        in_ch = int(32 * scale)
        layers = [_ConvBNReLU(3, in_ch, 3, stride=2)]
        for out, s in cfg:
            out_ch = int(out * scale)
            layers.append(_ConvBNReLU(in_ch, in_ch, 3, stride=s, groups=in_ch))
            layers.append(_ConvBNReLU(in_ch, out_ch, 1))
            in_ch = out_ch
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(in_ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return MobileNetV1(scale=scale, **kwargs)


class _InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU(inp, hidden, 1, act=nn.ReLU6))
        layers += [
            _ConvBNReLU(hidden, hidden, 3, stride=stride, groups=hidden,
                        act=nn.ReLU6),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(nn.Layer):
    """reference: vision/models/mobilenetv2.py."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [
            # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        in_ch = _make_divisible(32 * scale)
        last_ch = _make_divisible(1280 * max(1.0, scale))
        layers = [_ConvBNReLU(3, in_ch, 3, stride=2, act=nn.ReLU6)]
        for t, c, n, s in cfg:
            out_ch = _make_divisible(c * scale)
            for i in range(n):
                layers.append(_InvertedResidual(in_ch, out_ch,
                                                s if i == 0 else 1, t))
                in_ch = out_ch
        layers.append(_ConvBNReLU(in_ch, last_ch, 1, act=nn.ReLU6))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last_ch, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return MobileNetV2(scale=scale, **kwargs)


class _SEBlock(nn.Layer):
    def __init__(self, ch, r=4):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc1 = nn.Conv2D(ch, ch // r, 1)
        self.fc2 = nn.Conv2D(ch // r, ch, 1)

    def forward(self, x):
        s = self.pool(x)
        s = F.relu(self.fc1(s))
        s = F.hardsigmoid(self.fc2(s))
        return x * s


class _MBV3Block(nn.Layer):
    def __init__(self, inp, hidden, out, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and inp == out
        layers = []
        if hidden != inp:
            layers.append(_ConvBNReLU(inp, hidden, 1, act=act))
        layers.append(_ConvBNReLU(hidden, hidden, k, stride=stride,
                                  groups=hidden, act=act))
        if use_se:
            layers.append(_SEBlock(hidden))
        layers += [nn.Conv2D(hidden, out, 1, bias_attr=False),
                   nn.BatchNorm2D(out)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.block(x) if self.use_res else self.block(x)


_V3_LARGE = [
    # k, exp, out, se, act, s
    (3, 16, 16, False, nn.ReLU, 1), (3, 64, 24, False, nn.ReLU, 2),
    (3, 72, 24, False, nn.ReLU, 1), (5, 72, 40, True, nn.ReLU, 2),
    (5, 120, 40, True, nn.ReLU, 1), (5, 120, 40, True, nn.ReLU, 1),
    (3, 240, 80, False, nn.Hardswish, 2), (3, 200, 80, False, nn.Hardswish, 1),
    (3, 184, 80, False, nn.Hardswish, 1), (3, 184, 80, False, nn.Hardswish, 1),
    (3, 480, 112, True, nn.Hardswish, 1), (3, 672, 112, True, nn.Hardswish, 1),
    (5, 672, 160, True, nn.Hardswish, 2), (5, 960, 160, True, nn.Hardswish, 1),
    (5, 960, 160, True, nn.Hardswish, 1),
]

_V3_SMALL = [
    (3, 16, 16, True, nn.ReLU, 2), (3, 72, 24, False, nn.ReLU, 2),
    (3, 88, 24, False, nn.ReLU, 1), (5, 96, 40, True, nn.Hardswish, 2),
    (5, 240, 40, True, nn.Hardswish, 1), (5, 240, 40, True, nn.Hardswish, 1),
    (5, 120, 48, True, nn.Hardswish, 1), (5, 144, 48, True, nn.Hardswish, 1),
    (5, 288, 96, True, nn.Hardswish, 2), (5, 576, 96, True, nn.Hardswish, 1),
    (5, 576, 96, True, nn.Hardswish, 1),
]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_exp, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_ch = _make_divisible(16 * scale)
        layers = [_ConvBNReLU(3, in_ch, 3, stride=2, act=nn.Hardswish)]
        for k, exp, out, se, act, s in cfg:
            hidden = _make_divisible(exp * scale)
            out_ch = _make_divisible(out * scale)
            layers.append(_MBV3Block(in_ch, hidden, out_ch, k, s, se, act))
            in_ch = out_ch
        last = _make_divisible(last_exp * scale)
        layers.append(_ConvBNReLU(in_ch, last, 1, act=nn.Hardswish))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            out_dim = 1280 if last_exp == 960 else 1024
            self.classifier = nn.Sequential(
                nn.Linear(last, out_dim), nn.Hardswish(), nn.Dropout(0.2),
                nn.Linear(out_dim, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_LARGE, 960, scale, num_classes, with_pool)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_SMALL, 576, scale, num_classes, with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return MobileNetV3Small(scale=scale, **kwargs)
