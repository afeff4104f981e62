from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .distance import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import (BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN, RNNCellBase,  # noqa: F401
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
