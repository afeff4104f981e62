"""Weight initializers (counterpart of paddle_tpu/nn/initializer.py).

``init(shape, generator=None)`` draws a float32 tensor of ``shape``;
``init(param)`` re-initializes an existing parameter in place, as the
reference's call does. A draw takes the device of its ``torch.Generator``:
by default the CPU (``paddle.seed``'s generator), then the weights move to
the target device, so a seed gives the same weights on every device; a
CUDA generator draws on the card, so a 7B model never passes through host
memory. The samples are torch's, not jax.random's: where two runs must
agree, weights are carried across (convert.py). The deterministic ones
(``Constant``, ``Assign``, ``Dirac``, ``Bilinear``) equal the reference's.
"""
import math

import numpy as np
import torch

from ..core import random as random_core


def _fans(shape):
    """(fan_in, fan_out): a conv kernel [out, in, *spatial] counts its
    receptive field, as the reference does."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _gen(generator):
    return generator or random_core.default_generator()


class Initializer:
    def __call__(self, shape_or_param, generator=None):
        if isinstance(shape_or_param, torch.Tensor):
            p = shape_or_param
            with torch.no_grad():
                p.copy_(self._generate(tuple(p.shape), generator))
            return p
        return self._generate(tuple(int(s) for s in shape_or_param), generator)

    def _generate(self, shape, generator):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, shape, generator):
        return torch.full(shape, float(self.value))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean = mean
        self.std = std

    def _generate(self, shape, generator):
        gen = _gen(generator)
        x = torch.randn(shape, generator=gen, device=gen.device)
        return x.mul_(self.std).add_(self.mean)


class TruncatedNormal(Initializer):
    """mean + std * a standard normal truncated to [-2, 2] (the
    reference's bounds), drawn by the inverse CDF."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean = mean
        self.std = std

    def _generate(self, shape, generator):
        gen = _gen(generator)
        lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
        u = torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo
        x = torch.erfinv(2 * u - 1).mul_(math.sqrt(2)).clamp_(-2.0, 2.0)
        return x.mul_(self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low = low
        self.high = high

    def _generate(self, shape, generator):
        gen = _gen(generator)
        x = torch.rand(shape, generator=gen, device=gen.device)
        return x.mul_(self.high - self.low).add_(self.low)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        self.fan_in = fan_in
        self.fan_out = fan_out

    def _generate(self, shape, generator):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return Normal(0.0, math.sqrt(2.0 / (fi + fo)))._generate(shape, generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        self.fan_in = fan_in
        self.fan_out = fan_out

    def _generate(self, shape, generator):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)._generate(shape, generator)


def _kaiming_gain(nonlinearity, negative_slope):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, generator):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        std = _kaiming_gain(self.nonlinearity, self.negative_slope) / math.sqrt(fi)
        return Normal(0.0, std)._generate(shape, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, generator):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        limit = _kaiming_gain(self.nonlinearity, self.negative_slope) * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)._generate(shape, generator)


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def _generate(self, shape, generator):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return torch.from_numpy(np.array(v, np.float32).reshape(shape))


class Orthogonal(Initializer):
    """gain * a (semi-)orthogonal matrix from the QR of a normal draw, over
    [prod(shape[:-1]), shape[-1]] as jax's ``orthogonal()`` builds it."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _generate(self, shape, generator):
        gen = _gen(generator)
        rows, cols = int(np.prod(shape[:-1])), shape[-1]
        a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen, device=gen.device)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q).reshape(shape).contiguous()


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _generate(self, shape, generator):
        arr = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            arr[(i, i % ic) + centers] = 1.0
        return torch.from_numpy(arr)


class Bilinear(Initializer):
    """The bilinear upsampling stencil on each (i, i % c_in) kernel of a 4-D
    weight, so that a fresh Conv2DTranspose(stride=f, kernel=2f - f % 2,
    padding=ceil((f - 1) / 2)) interpolates bilinearly."""

    def _generate(self, shape, generator):
        if len(shape) != 4:
            raise ValueError(f"Bilinear initializer needs a 4-D weight, got shape {shape}")
        k = shape[3]
        factor = (k + 1) // 2
        center = factor - 1.0 if k % 2 == 1 else factor - 0.5
        og = np.ogrid[:k, :k]
        filt = (1 - np.abs(og[0] - center) / factor) * (1 - np.abs(og[1] - center) / factor)
        weight = np.zeros(shape, np.float32)
        for i in range(shape[0]):
            weight[i, i % shape[1]] = filt
        return torch.from_numpy(weight)


# lowercase aliases of paddle 2.x
constant = Constant
normal = Normal
uniform = Uniform

_GLOBAL_WEIGHT_INIT = None
_GLOBAL_BIAS_INIT = None


def set_global_initializer(weight_init, bias_init=None):
    """The initializers of parameters that neither their ParamAttr nor their
    layer gives one (``None`` restores the defaults)."""
    global _GLOBAL_WEIGHT_INIT, _GLOBAL_BIAS_INIT
    _GLOBAL_WEIGHT_INIT = weight_init
    _GLOBAL_BIAS_INIT = bias_init


def global_initializer(is_bias):
    return _GLOBAL_BIAS_INIT if is_bias else _GLOBAL_WEIGHT_INIT


def create_parameter(shape, initializer, device, generator=None):
    """A Parameter of ``initializer``'s draw on ``device``, outside any
    Layer (a Layer's own go through ``Layer.create_parameter``)."""
    from ..core.tensor import Parameter

    return Parameter(initializer(shape, generator).to(device))
