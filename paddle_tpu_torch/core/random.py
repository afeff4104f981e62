"""RNG (counterpart of paddle_tpu/core/random.py).

Initialisation draws from a seeded ``torch.Generator``: weights are
carried across from the JAX package where two runs must agree, so the
port does not reproduce jax.random's samples. The counter-hash pieces of
dropout (``fmix32``, ``keep_thresh_u32``) ARE bit-identical to the JAX
package: the flash kernel's in-kernel dropout mask is built from them.
uint32 arithmetic is done in int64 tensors masked to 32 bits, with each
multiply split in 16-bit halves so no product leaves int64's range.
"""
import torch

U32 = 0xFFFFFFFF

_GLOBAL_GENERATOR = torch.Generator().manual_seed(0)


def seed(s):
    """paddle.seed: reseed the default generator used for initialisation."""
    _GLOBAL_GENERATOR.manual_seed(int(s))
    return _GLOBAL_GENERATOR


def default_generator():
    return _GLOBAL_GENERATOR


def keep_thresh_u32(keep_prob):
    """keep probability -> uint32 comparison threshold (the same value the
    JAX package's functional dropout and flash kernel compare against)."""
    return min(int(float(keep_prob) * 4294967296.0), 4294967295)


def mul32(a, c):
    """(a * c) mod 2**32 for an int64 tensor ``a`` in [0, 2**32) and a
    Python int constant ``c`` in [0, 2**32)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def fmix32(h):
    """murmur3's 32-bit avalanche finalizer on int64 tensors holding
    uint32 values."""
    h = h & U32
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)
