"""Layers and functional ops of the port (counterpart of paddle_tpu.nn)."""
from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layers import (Dropout, Embedding, LayerList, LayerNorm, Linear,  # noqa: F401
                     MultiHeadAttention, TransformerEncoder,
                     TransformerEncoderLayer)
