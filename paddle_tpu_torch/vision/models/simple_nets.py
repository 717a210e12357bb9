"""LeNet, AlexNet, VGG and SqueezeNet
(``paddle_tpu/vision/models/simple_nets.py``).

Paddle ``Layer``s over the port's ``nn``, built as the JAX package builds
them, so the ``state_dict`` names and shapes are its own and weights carry
across with ``set_state_dict`` (BatchNorm running statistics included,
``vgg*(batch_norm=True)``). ``pretrained=True`` raises: no weights ship.
"""
from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...ops.manipulation import concat

__all__ = [
    "LeNet", "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
]

_NO_WEIGHTS = ("pretrained weights are not bundled; load a state_dict "
               "with model.set_state_dict")


class LeNet(nn.Layer):
    """reference: vision/models/lenet.py (MNIST 1x28x28)."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120), nn.Linear(120, 84),
                nn.Linear(84, num_classes),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


class AlexNet(nn.Layer):
    """reference: vision/models/alexnet.py."""

    def __init__(self, num_classes=1000, dropout=0.5):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(dropout), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                nn.Dropout(dropout), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return AlexNet(**kwargs)


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def _make_vgg_features(cfg, batch_norm=False):
    layers = []
    in_ch = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_ch, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_ch = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    """reference: vision/models/vgg.py."""

    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def _vgg(cfg, batch_norm, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return VGG(_make_vgg_features(_VGG_CFGS[cfg], batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)


class _Fire(nn.Layer):
    def __init__(self, in_ch, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Conv2D(in_ch, squeeze, 1)
        self.expand1 = nn.Conv2D(squeeze, e1, 1)
        self.expand3 = nn.Conv2D(squeeze, e3, 3, padding=1)

    def forward(self, x):
        x = F.relu(self.squeeze(x))
        return concat([F.relu(self.expand1(x)), F.relu(self.expand3(x))],
                             axis=1)


class SqueezeNet(nn.Layer):
    """reference: vision/models/squeezenet.py."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(512, 64, 256, 256),
            )
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2, padding=1), nn.ReLU(),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256),
            )
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5),
                nn.Conv2D(512, num_classes, 1), nn.ReLU(),
            )
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(_NO_WEIGHTS)
    return SqueezeNet("1.1", **kwargs)
