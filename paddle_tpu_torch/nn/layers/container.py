"""Containers (counterpart of paddle_tpu/nn/layers/container.py)."""
import torch

from ..layer import Layer


class LayerList(Layer, torch.nn.ModuleList):
    """Sublayers named "0", "1", ... as in the JAX package's LayerList."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.extend(sublayers)
