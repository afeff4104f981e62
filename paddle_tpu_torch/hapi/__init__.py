"""paddle.hapi (counterpart of paddle_tpu/hapi): the high-level Model API,
its callbacks, ``summary`` and ``flops``."""
from . import callbacks  # noqa: F401
from .flops import flops  # noqa: F401
from .model import Model  # noqa: F401
from .model_summary import summary  # noqa: F401
