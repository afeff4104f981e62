"""Layers and functional ops of the port (counterpart of paddle_tpu.nn)."""
from . import functional  # noqa: F401
from .layer import Layer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,  # noqa: F401
                   clip_by_norm, clip_grad_norm_)
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from .layers import (BiRNN, Dropout, Embedding, GRU, GRUCell, LSTM,  # noqa: F401
                     LSTMCell, LayerList, LayerNorm, Linear, MultiHeadAttention,
                     RNN, RNNCellBase, SimpleRNN, SimpleRNNCell, Transformer,
                     TransformerDecoder, TransformerDecoderLayer,
                     TransformerEncoder, TransformerEncoderLayer)
