"""The default initializers of Linear, Embedding, LayerNorm, RMSNorm and
the RNNs (counterpart of paddle_tpu/nn/initializer.py). A draw takes the
device of its ``torch.Generator``: by default the CPU, then the weights
move to the target device, so a seed gives the same weights on every
device; a CUDA generator draws on the card, so a 7B model never passes
through host memory."""
import math

import torch

from ..core import random as random_core
from ..core.tensor import Parameter


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    return shape[0], shape[1]


class Constant:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, generator=None):
        return torch.full(tuple(shape), float(self.value))


class Normal:
    def __init__(self, mean=0.0, std=1.0):
        self.mean = mean
        self.std = std

    def __call__(self, shape, generator=None):
        gen = generator or random_core.default_generator()
        x = torch.randn(tuple(shape), generator=gen, device=gen.device)
        return x.mul_(self.std).add_(self.mean)


class Uniform:
    def __init__(self, low=-1.0, high=1.0):
        self.low = low
        self.high = high

    def __call__(self, shape, generator=None):
        gen = generator or random_core.default_generator()
        x = torch.rand(tuple(shape), generator=gen, device=gen.device)
        return x.mul_(self.high - self.low).add_(self.low)


class XavierNormal:
    def __call__(self, shape, generator=None):
        fan_in, fan_out = _fans(tuple(shape))
        return Normal(0.0, math.sqrt(2.0 / (fan_in + fan_out)))(shape, generator)


def create_parameter(shape, initializer, device, generator=None):
    return Parameter(initializer(shape, generator).to(device))
