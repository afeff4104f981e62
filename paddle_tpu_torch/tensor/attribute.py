"""Attribute ops (counterpart of paddle_tpu/tensor/attribute.py)."""
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import finish


def shape(input):
    """The shape as a 1-D int32 tensor."""
    return finish("shape", torch.tensor(list(input.shape), dtype=torch.int32,
                                        device=input.device))


def rank(input):
    return finish("rank", torch.tensor(input.dim(), dtype=torch.int32, device=input.device))


def is_floating_point(x):
    return dtype_mod.is_floating(x.dtype)


def is_integer(x):
    return dtype_mod.is_integer(x.dtype)


def is_complex(x):
    return x.dtype.is_complex
