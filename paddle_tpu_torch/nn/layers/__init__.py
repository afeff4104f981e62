from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import LayerList  # noqa: F401
from .norm import LayerNorm  # noqa: F401
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
