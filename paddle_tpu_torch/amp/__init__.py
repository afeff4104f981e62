"""Mixed precision (counterpart of paddle_tpu.amp): the O1/O2 ``auto_cast``
context (``amp_guard`` is its other name) with the reference's white and
black op lists, the dynamic loss scaler (``GradScaler``, ``AmpScaler``) for
float16, and ``decorate``, which under O2 casts the models to the AMP
dtype."""
from .auto_cast import (AMP_BLACK_LIST, AMP_WHITE_LIST, auto_cast,  # noqa: F401
                        cast_inputs, target_dtype)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

amp_guard = auto_cast
white_list = AMP_WHITE_LIST
black_list = AMP_BLACK_LIST


def decorate(models, optimizers=None, level="O1", dtype="bfloat16", master_weight=None,
             save_dtype=None):
    """The reference's dygraph ``decorate``: under O2 every model's
    floating parameters and buffers are cast to ``dtype`` in place; O1
    leaves them float32. Returns ``models``, or ``(models, optimizers)``
    where optimizers were given."""
    if level == "O2":
        for m in models if isinstance(models, (list, tuple)) else [models]:
            m.to(dtype=dtype)
    if optimizers is None:
        return models
    return models, optimizers
