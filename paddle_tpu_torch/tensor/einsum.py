"""einsum (counterpart of paddle_tpu/tensor/einsum.py)."""
import torch

from ..core.dispatch import apply


def einsum(equation, *operands):
    return apply("einsum", lambda *xs: torch.einsum(equation, *xs), *operands)
