"""paddle.vision (counterpart of paddle_tpu/vision): the models, the
datasets and the transforms. The detection ops (``vision/ops.py``) are not
ported yet (ROADMAP Queue 1)."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import transforms  # noqa: F401
from .models import LeNet  # noqa: F401


def set_image_backend(backend):
    pass


def get_image_backend():
    return "numpy"
