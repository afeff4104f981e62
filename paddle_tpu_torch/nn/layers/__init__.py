from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import LayerList  # noqa: F401
from .norm import LayerNorm  # noqa: F401
from .rnn import (BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN, RNNCellBase,  # noqa: F401
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
