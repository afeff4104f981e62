"""paddle.incubate.optimizer (counterpart of paddle_tpu/incubate/optimizer):
re-exports of the wrapper optimizers."""
from ...optimizer import LookAhead, ModelAverage  # noqa: F401

__all__ = ["LookAhead", "ModelAverage"]
