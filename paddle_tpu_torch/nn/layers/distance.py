"""Distance layers (counterpart of paddle_tpu/nn/layers/distance.py)."""
from .. import functional as F
from ..layer import Layer


class PairwiseDistance(Layer):
    """The p-norm of (x - y) over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)
