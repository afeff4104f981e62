"""Common layers (counterpart of paddle_tpu/nn/layers/common.py)."""
import torch

from ...core.place import resolve_device
from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class Linear(Layer):
    """y = x W + b, with ``weight`` [in, out] as in Paddle. With
    ``bias_attr=False`` there is no bias parameter at all."""

    def __init__(self, in_features, out_features, *, bias_attr=None, device="cuda",
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = I.create_parameter([in_features, out_features],
                                         I.XavierNormal(), dev, generator)
        self.bias = (None if bias_attr is False
                     else I.create_parameter([out_features], I.Constant(0.0), dev))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self._in_features}, out={self._out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, *,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._padding_idx = padding_idx
        self.weight = I.create_parameter([num_embeddings, embedding_dim],
                                         I.Normal(0.0, 1.0), dev, generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)
