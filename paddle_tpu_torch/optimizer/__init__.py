"""Optimizers and learning-rate schedulers of the port (counterpart of
paddle_tpu.optimizer; its ``wrappers`` (EMA, LookAhead, ModelAverage) are
not ported yet)."""
from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    Adadelta, Adagrad, Adam, Adamax, AdamW, DecayedAdagrad, Ftrl, Lamb, Lars,
    LarsMomentum, Momentum, Optimizer, RMSProp, SGD,
)
