"""Optimizers, learning-rate schedulers and the parameter-averaging
wrappers (EMA, LookAhead, ModelAverage) of the port (counterpart of
paddle_tpu.optimizer)."""
from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    Adadelta, Adagrad, Adam, Adamax, AdamW, DecayedAdagrad, Ftrl, Lamb, Lars,
    LarsMomentum, Momentum, Optimizer, RMSProp, SGD,
)
from .wrappers import ExponentialMovingAverage, LookAhead, ModelAverage  # noqa: F401
