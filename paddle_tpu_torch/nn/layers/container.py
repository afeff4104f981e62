"""Containers (counterpart of paddle_tpu/nn/layers/container.py)."""
import torch


class LayerList(torch.nn.ModuleList):
    """Sublayers named "0", "1", ... as in the JAX package's LayerList."""
