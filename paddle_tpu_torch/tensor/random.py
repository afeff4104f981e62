"""Random ops (counterpart of paddle_tpu/tensor/random.py). Each op draws
one key from the global key stream (``core.random.next_key``), where the
reference draws one, and samples on jax.random's own stream
(core/random.py), so the same seed gives the JAX package's samples:
bitwise for the ops built on bits or uniform, within a few ulp where
``erfinv`` or ``log`` differ from XLA's (``normal``, ``exponential``).
Floating samples are float32, as jax's default dtype here."""
import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import errors
from ..core import random as random_core
from ..core.dispatch import apply, finish
from .creation import _dev, _dtype, _norm_shape
from .math import _inplace


def _f32(dtype):
    d = _dtype(dtype)
    if d != torch.float32:
        raise errors.UnimplementedError(
            f"random floating samples in {dtype_mod.dtype_name(d)}: the port samples "
            "jax's float32 stream only")
    return d


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    _f32(dtype)
    key = random_core.next_key()
    return finish("uniform", random_core.uniform(key, _norm_shape(shape), float(min),
                                                 float(max), _dev()))


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    key = random_core.next_key()
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        def _normal_t(mean, std):
            dev = mean.device if isinstance(mean, torch.Tensor) else std.device
            shp = torch.broadcast_shapes(tuple(np.shape(mean)) if not isinstance(
                mean, torch.Tensor) else mean.shape, tuple(np.shape(std)) if not isinstance(
                std, torch.Tensor) else std.shape)
            return mean + std * random_core.normal(key, tuple(shp), dev)

        return apply("gaussian", _normal_t, mean, std)
    shape = _norm_shape(shape if shape is not None else [1])
    _f32(None)
    return finish("gaussian", float(mean) + float(std) * random_core.normal(key, shape, _dev()))


def gaussian(shape, mean=0.0, std=1.0, dtype=None, name=None):
    """reference: tensor/random.py gaussian(shape, mean, std, dtype)."""
    out = normal(mean, std, shape)
    if dtype is not None:
        from .manipulation import cast

        out = cast(out, dtype)
    return out


def randn(shape, dtype=None, name=None):
    _f32(dtype)
    key = random_core.next_key()
    return finish("randn", random_core.normal(key, _norm_shape(shape), _dev()))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    d = dtype_mod.convert_dtype(dtype or "int64")
    key = random_core.next_key()
    out = random_core.randint(key, _norm_shape(shape), int(low), int(high), _dev())
    return finish("randint", out.to(d))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, tuple(x.shape), dtype or x.dtype)


def randperm(n, dtype="int64", name=None):
    d = dtype_mod.convert_dtype(dtype or "int64")
    key = random_core.next_key()
    return finish("randperm", random_core.permutation(key, int(n), _dev()).to(d))


def multinomial(x, num_samples=1, replacement=False, name=None):
    key = random_core.next_key()
    n = int(num_samples)

    def _multinomial(x):
        logits = torch.log(torch.clamp(x, min=1e-30))
        if replacement:
            shape = (n,) + tuple(x.shape[:-1]) + (x.shape[-1],)
            g = random_core.gumbel(key, shape, x.device)
            idx = torch.argmax(g + logits[None], dim=-1)
            return idx.permute(*reversed(range(idx.dim()))).to(torch.int32)
        g = random_core.gumbel(key, tuple(x.shape), x.device)
        order = torch.sort(logits + g, dim=-1, descending=True, stable=True).indices
        return order[..., :n].to(torch.int32)

    return apply("multinomial", _multinomial, x)


def bernoulli(x, name=None):
    key = random_core.next_key()
    return apply("bernoulli", lambda x: random_core.bernoulli(key, x).to(x.dtype), x)


def poisson(x, name=None):
    key = random_core.next_key()
    return apply("poisson", lambda x: random_core.poisson(key, x).to(x.dtype), x)


def exponential_(x, lam=1.0, name=None):
    key = random_core.next_key()
    out = apply("exponential", lambda x: (random_core.exponential(key, tuple(x.shape), x.device)
                                          / float(lam)).to(x.dtype), x)
    return _inplace(x, out)


def check_shape(shape):
    """Validate a shape argument (reference: fluid/layers/utils.py:364): a
    list or tuple of non-negative ints, or an int32/int64 tensor."""
    if isinstance(shape, torch.Tensor):
        if shape.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"shape tensor must be int32 or int64, got {shape.dtype}")
        return
    for ele in shape:
        if isinstance(ele, torch.Tensor):
            continue
        if not isinstance(ele, (int, np.integer)):
            raise TypeError("All elements in ``shape`` must be integers "
                            "when it's a list or tuple")
        if ele < 0:
            raise ValueError("All elements in ``shape`` must be positive "
                             "when it's a list or tuple")
