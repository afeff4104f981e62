"""paddle.nn.utils (counterpart of paddle_tpu/nn/utils): spectral_norm."""
from .spectral_norm_hook import spectral_norm  # noqa: F401

__all__ = ["spectral_norm"]
