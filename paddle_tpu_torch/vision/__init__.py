"""paddle.vision (counterpart of paddle_tpu/vision): the models. The
datasets, transforms and detection ops are not ported yet."""
from . import models  # noqa: F401
from .models import LeNet  # noqa: F401
