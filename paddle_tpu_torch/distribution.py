"""paddle.distribution (counterpart of paddle_tpu/distribution.py;
reference: python/paddle/distribution.py): ``Uniform``, ``Normal`` and
``Categorical``.

The parameters are float32 tensors on the device of a tensor given for
them (the current place for Python numbers and arrays). ``sample`` draws
one key from the global key stream (``core.random.next_key``), where the
reference draws one, and samples on jax.random's stream
(core/random.py): ``Categorical`` gives the reference's samples bitwise,
``Uniform`` and ``Normal`` within a few ulp (XLA fuses the uniform's scale
and shift into an FMA; ``torch.erfinv`` is not XLA's polynomial). Results
are Tensors.
"""
import math

import numpy as np
import torch

from .core import place as place_mod
from .core import random as random_core
from .core.tensor import plain, wrap

__all__ = ["Distribution", "Uniform", "Normal", "Categorical"]


def _arr(x, like=None):
    if isinstance(x, torch.Tensor):
        return plain(x).detach()
    dev = like.device if like is not None else place_mod.current_device()
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _arr(low)
        self.high = _arr(high, self.low)

    def sample(self, shape=(), seed=0):
        full = tuple(shape) + tuple(torch.broadcast_shapes(self.low.shape, self.high.shape))
        u = random_core.uniform(random_core.next_key(), full, device=self.low.device)
        return wrap(u * (self.high - self.low) + self.low)

    def log_prob(self, value):
        v = _arr(value, self.low)
        lb = (v > self.low).to(torch.float32)
        ub = (v < self.high).to(torch.float32)
        return wrap(torch.log(lb * ub) - torch.log(self.high - self.low))

    def probs(self, value):
        return wrap(torch.exp(plain(self.log_prob(value))))

    def entropy(self):
        return wrap(torch.log(self.high - self.low))


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _arr(loc)
        self.scale = _arr(scale, self.loc)

    def sample(self, shape=(), seed=0):
        full = tuple(shape) + tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))
        z = random_core.normal(random_core.next_key(), full, device=self.loc.device)
        return wrap(self.loc + self.scale * z)

    def log_prob(self, value):
        v = _arr(value, self.loc)
        var = self.scale ** 2
        return wrap(-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                    - 0.5 * math.log(2 * math.pi))

    def probs(self, value):
        return wrap(torch.exp(plain(self.log_prob(value))))

    def entropy(self):
        return wrap(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale))

    def kl_divergence(self, other):
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return wrap(0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio)))


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _arr(logits)

    def sample(self, shape=()):
        """jax.random.categorical(key, logits, shape=shape + batch): the
        first maximum of logits + Gumbel noise of shape ``shape +
        logits.shape``. int32 indices, as the reference's."""
        full = tuple(shape) + tuple(self.logits.shape)
        g = random_core.gumbel(random_core.next_key(), full, device=self.logits.device)
        return wrap(torch.argmax(g + self.logits, dim=-1).to(torch.int32))

    def _index(self, value):
        return _arr(value, self.logits).long()[..., None]

    def probs(self, value=None):
        p = torch.softmax(self.logits, dim=-1)
        if value is None:
            return wrap(p)
        return wrap(torch.take_along_dim(p, self._index(value), dim=-1)[..., 0])

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, dim=-1)
        return wrap(torch.take_along_dim(logp, self._index(value), dim=-1)[..., 0])

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        return wrap(-torch.sum(torch.exp(logp) * logp, dim=-1))

    def kl_divergence(self, other):
        logp = torch.log_softmax(self.logits, dim=-1)
        logq = torch.log_softmax(other.logits, dim=-1)
        return wrap(torch.sum(torch.exp(logp) * (logp - logq), dim=-1))
