"""Mixed precision (counterpart of paddle_tpu.amp): the O1/O2 auto_cast
context. The fp16 loss scaler (``amp/grad_scaler.py``) is not ported yet."""
from .auto_cast import (AMP_BLACK_LIST, AMP_WHITE_LIST, auto_cast,  # noqa: F401
                        cast_inputs, target_dtype)
