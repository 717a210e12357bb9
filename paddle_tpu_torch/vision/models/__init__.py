"""The vision model zoo of the port (``paddle_tpu/vision/models``): the
ResNet family. The detection, OCR, MobileNet and other model files are
not ported yet."""
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
    resnext101_64x4d, resnext152_32x4d, resnext152_64x4d, wide_resnet50_2,
    wide_resnet101_2,
)

__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d", "resnext50_64x4d",
    "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
    "resnext152_64x4d", "BasicBlock", "BottleneckBlock",
]
