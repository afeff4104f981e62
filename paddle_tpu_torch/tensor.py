"""The tensor ops of the BERT path (counterpart of the matching entries of
paddle_tpu/tensor/math.py and manipulation.py). Each casts its inputs as
the active auto_cast does for the reference op of the same name."""
import numpy as np
import torch

from .amp.auto_cast import cast_inputs


def add(x, y):
    x, y = cast_inputs("add", x, y)
    return x + y


def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = cast_inputs("matmul", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def take_along_axis(arr, indices, axis):
    """jnp.take_along_axis: ``indices`` broadcasts against ``arr`` on every
    axis but ``axis``."""
    (arr,) = cast_inputs("take_along_axis", arr)
    return torch.take_along_dim(arr, indices.long(), dim=axis)


def divide_by_scalar(x, c):
    """x / c for a Python scalar c, rounded as the reference's compiled
    ``x / c`` is: XLA turns a float32 division by a constant into a product
    with the float32 reciprocal, and a bfloat16 division divides by the
    constant rounded to bfloat16."""
    if x.dtype == torch.float32:
        return x * float(np.float32(1.0) / np.float32(c))
    return x / torch.full((), c, dtype=x.dtype, device=x.device)
