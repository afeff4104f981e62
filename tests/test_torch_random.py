"""The port's counter-hash pieces (paddle_tpu_torch/core/random.py) are
bitwise the JAX package's (paddle_tpu/core/random.py): the flash kernel's
dropout mask is built from them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import random as jrandom
from paddle_tpu_torch.core import random as trandom

torch.set_num_threads(1)


def _u32_grid():
    rng = np.random.RandomState(0)
    edges = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
                      0x85EBCA6B, 0x9E3779B1], np.uint64)
    return np.concatenate([edges, rng.randint(0, 2**32, 4096, dtype=np.uint64)])


def test_fmix32_bitwise():
    x = _u32_grid()
    want = np.asarray(jrandom.fmix32(jnp.asarray(x.astype(np.uint32))))
    got = trandom.fmix32(torch.from_numpy(x.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF


@pytest.mark.parametrize("c", [0x85EBCA6B, 0xC2B2AE35, 0x9E3779B1, 1, 0xFFFFFFFF])
def test_mul32_is_uint32_multiply(c):
    x = _u32_grid()
    want = (x.astype(np.uint32) * np.uint32(c)).astype(np.uint32)
    got = trandom.mul32(torch.from_numpy(x.astype(np.int64)), c)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("keep_prob", [0.0, 1e-9, 0.1, 0.5, 0.8, 0.9, 0.999999, 1.0])
def test_keep_thresh_u32_equal(keep_prob):
    assert trandom.keep_thresh_u32(keep_prob) == jrandom.keep_thresh_u32(keep_prob)


def test_default_generator_is_seeded():
    a = torch.randn(4, generator=trandom.seed(3))
    b = torch.randn(4, generator=trandom.seed(3))
    assert torch.equal(a, b)
    assert trandom.default_generator().initial_seed() == 3
    trandom.seed(0)
