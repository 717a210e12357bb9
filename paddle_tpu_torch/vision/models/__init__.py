"""The vision model zoo of the port (``paddle_tpu/vision/models``): the
ResNet family, LeNet, AlexNet, VGG, SqueezeNet, the MobileNets, DenseNet,
ShuffleNetV2, GoogLeNet, InceptionV3, PP-YOLOE and PP-OCR (DBNet,
CRNN), exported as there."""
from .detection import (  # noqa: F401
    CSPPAN, CSPResNet, PPYOLOE, PPYOLOEHead, ppyoloe_l, ppyoloe_m,
    ppyoloe_s,
)
from .ocr import (  # noqa: F401
    CRNN, DBHead, DBNet, crnn_ctc, db_loss, db_mobilenet_v3,
)
from .extra_nets import (  # noqa: F401
    DenseNet, GoogLeNet, InceptionV3, ShuffleNetV2, densenet121, densenet161,
    densenet169, densenet201, densenet264, googlenet, inception_v3,
    shufflenet_v2_x0_25, shufflenet_v2_x0_33, shufflenet_v2_x0_5,
    shufflenet_v2_swish, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0,
)
from .mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV2, MobileNetV3Large, MobileNetV3Small,
    mobilenet_v1, mobilenet_v2, mobilenet_v3_large, mobilenet_v3_small,
)
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
    resnext101_64x4d, resnext152_32x4d, resnext152_64x4d, wide_resnet50_2,
    wide_resnet101_2,
)
from .simple_nets import (  # noqa: F401
    AlexNet, LeNet, SqueezeNet, VGG, alexnet, squeezenet1_0, squeezenet1_1,
    vgg11, vgg13, vgg16, vgg19,
)

__all__ = [
    "PPYOLOE", "ppyoloe_s", "ppyoloe_m", "ppyoloe_l", "CSPResNet",
    "CSPPAN", "PPYOLOEHead", "DBNet", "DBHead", "CRNN", "db_mobilenet_v3",
    "crnn_ctc", "db_loss",
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d", "resnext50_64x4d",
    "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
    "resnext152_64x4d", "BasicBlock", "BottleneckBlock",
    "LeNet", "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
    "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
    "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
    "mobilenet_v3_large",
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_swish",
    "shufflenet_v2_x2_0", "GoogLeNet", "googlenet", "InceptionV3",
    "inception_v3",
]
