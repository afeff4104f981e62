"""The port's RNG (paddle_tpu_torch/core/random.py) is bitwise the JAX
package's (paddle_tpu/core/random.py): the threefry key stream
(``PRNGKey``/``split``/``fold_in``/``key_data``, the global ``Generator``,
``next_key`` under ``rng_guard``) and the counter-hash pieces the dropout
masks and the flash kernels' masks are built from."""
import jax
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


SEEDS = [0, 1, 42, -1, -2**31, 2**31 - 1, 2**32 - 1, 123456789]


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)).reshape(-1))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    assert trandom.key_data(tk) == _words(jk)
    for n in (2, 3, 7):
        assert trandom.split(tk, n) == [_words(k) for k in jax.random.split(jk, n)]
    for data in (0, 1, 3, 37, 2**31 - 1, 2**32 - 1):
        assert trandom.fold_in(tk, data) == _words(jax.random.fold_in(jk, data))


def test_partitionable_split_values():
    # the values jax gives with jax_threefry_partitionable on (the default
    # of this jax), not the legacy split's
    assert trandom.split(trandom.PRNGKey(0)) == [(1797259609, 2579123966),
                                                 (928981903, 3453687069)]
    assert trandom.fold_in(trandom.PRNGKey(0), 3) == (2467461003, 3840466878)


def test_generator_stream_bitwise():
    jg, tg = jrandom.Generator(7), trandom.Generator(7)
    for _ in range(5):
        assert tg.next_key() == _words(jg.next_key())
    assert tg.initial_seed == 7 and trandom.key_data(tg.get_state()) == _words(jg.get_state())
    jg.manual_seed(3)
    tg.manual_seed(3)
    assert tg.next_key() == _words(jg.next_key())


def test_next_key_order_under_rng_guard_bitwise():
    jkey, tkey = jax.random.PRNGKey(11), trandom.PRNGKey(11)
    with jrandom.rng_guard(jkey):
        want = [_words(jrandom.next_key()) for _ in range(6)]
    with trandom.rng_guard(tkey):
        got = [trandom.next_key() for _ in range(3)]
        with trandom.rng_guard(trandom.fold_in(tkey, 99)):
            trandom.next_key()  # a nested scope keeps its own counter
        got += [trandom.next_key() for _ in range(3)]
    assert got == want
    # outside any scope the global generator hands keys out
    trandom.seed(5)
    jrandom.seed(5)
    assert trandom.next_key() == _words(jrandom.next_key())
    trandom.seed(0)
    jrandom.seed(0)


@pytest.mark.parametrize("shape,keep_prob", [
    ((3, 4, 5), 0.9), ((2, 3, 17, 11), 0.5), ((1,), 0.1), ((0, 3), 0.9),
    ((4, 64, 128), 0.9)])
@pytest.mark.parametrize("seed", [0, 2**31 - 1, -7])
def test_fast_keep_mask_bitwise(shape, keep_prob, seed):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    want = np.asarray(jrandom.fast_keep_mask(jk, keep_prob, shape))
    got = trandom.fast_keep_mask(trandom.fold_in(trandom.PRNGKey(seed), 5), keep_prob, shape,
                                  device="cpu")
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- jax.random's sampling stream
TINY = float(np.finfo(np.float32).tiny)


@pytest.mark.parametrize("shape", [(4, 1000), (16, 32000), (3, 5, 7)])
@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_random_bits_and_uniform_bitwise(shape, seed):
    """jax.random.bits and uniform (minval tiny, as the Gumbel draw uses
    it) from a host key and from the same key as a device tensor."""
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    tk = trandom.fold_in(trandom.PRNGKey(seed), 1)
    want_bits = np.asarray(jax.random.bits(jk, shape))
    want_u = np.asarray(jax.random.uniform(jk, shape, minval=TINY, maxval=1.0))
    for key in (tk, trandom.key_tensor(tk, "cpu")):
        bits = trandom.random_bits(key, shape, device="cpu")
        assert bits.dtype == torch.int64 and tuple(bits.shape) == shape
        np.testing.assert_array_equal(bits.numpy().astype(np.uint32), want_bits)
        u = trandom.uniform(key, shape, TINY, 1.0, device="cpu")
        assert u.dtype == torch.float32
        np.testing.assert_array_equal(u.numpy(), want_u)
    np.testing.assert_array_equal(trandom.uniform(tk, shape, device="cpu").numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_gumbel_within_two_ulp(seed):
    """-log(-log(u)) of the bitwise uniform: torch's and XLA's log each
    round within 1 ulp of the other, so the draws agree within 2 ulp of
    max(|g|, 1) (an inner log's ulp carries to the scale of 1 where g is
    near 0)."""
    shape = (16, 4000)
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = trandom.gumbel(trandom.PRNGKey(seed), shape, device="cpu").numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert (np.abs(got - want) <= 2 * ulp).all()


def test_split_of_a_device_key_is_the_host_split():
    for seed in (0, 5, 2**32 - 1):
        key = trandom.PRNGKey(seed)
        for n in (2, 3):
            dev = trandom.split(trandom.key_tensor(key, "cpu"), n)
            assert dev.dtype == torch.int64 and tuple(dev.shape) == (n, 2)
            assert [tuple(k) for k in dev.tolist()] == trandom.split(key, n)


@pytest.mark.parametrize("seed", [0, 3])
def test_categorical_matches_jax(seed):
    logits = (np.random.RandomState(seed).randn(8, 700) * 2).astype(np.float32)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed), logits))
    got = trandom.categorical(trandom.PRNGKey(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
