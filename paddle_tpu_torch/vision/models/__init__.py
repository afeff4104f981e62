"""The vision models (counterpart of paddle_tpu/vision/models). Their
constructors take no device: they build on the current place
(``paddle.set_device``)."""
import sys as _sys

from . import mobilenet  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2  # noqa: F401
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,  # noqa: F401
                     resnet152, wide_resnet50_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401

# the reference's file names mobilenetv1/mobilenetv2 are both mobilenet
mobilenetv1 = mobilenetv2 = mobilenet
for _alias in ("mobilenetv1", "mobilenetv2"):
    _sys.modules[f"{__name__}.{_alias}"] = mobilenet
del _alias
