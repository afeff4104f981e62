"""Normalisation layers (counterpart of paddle_tpu/nn/layers/norm.py)."""

from ...core.place import resolve_device
from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = I.create_parameter(self._normalized_shape, I.Constant(1.0), dev)
        self.bias = I.create_parameter(self._normalized_shape, I.Constant(0.0), dev)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)
