"""The port's flash-attention forward (paddle_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel, run here in interpret mode.

On the CPU the port's ``_fwd`` runs ``mha_reference``, the plain version
that sits beside the CUDA kernel; tests/test_torch_gpu.py holds the
kernel itself against it on the card. Inputs come from a numpy seed and
go through both. Tolerances: 2e-4 in float32 (as tests/test_pallas_kernels.py),
2e-2 in bfloat16 (P is rounded to bf16 before the PV product at different
points: per tile in the JAX kernel, once in the plain version).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch.core import cuda_build
from paddle_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(bh, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, sq, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32))


def _both_fwd(q, k, v, *, causal, dropout_p=0.0, seed=0, dtype="float32"):
    """(JAX O, JAX LSE), (port O, port LSE) as float32 numpy arrays."""
    d = q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    jd = JDT[dtype]
    jo, jl = fa._fwd(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                     jnp.asarray(seed, jnp.int32).reshape(1, 1), scale, causal,
                     fa._block(q.shape[1], 256), fa._block(k.shape[1], 256),
                     dropout_p)
    td = TDT[dtype]
    to, tl = tfa._fwd(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                      torch.from_numpy(v).to(td), seed, scale, causal, dropout_p)
    assert to.dtype == td and tl.dtype == torch.float32
    assert tuple(tl.shape) == tuple(jl.shape) == (q.shape[0], q.shape[1], 1)
    return ((np.asarray(jo, np.float32), np.asarray(jl)),
            (to.float().numpy(), tl.numpy()))


def _assert_close(j, t, dtype="float32"):
    tol = TOL[dtype]
    np.testing.assert_allclose(t[0], j[0], rtol=tol, atol=tol)
    # LSE is computed in f32 from f32 scores in both dtypes
    np.testing.assert_allclose(t[1], j[1], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bh,sq,sk,d,causal", [
    (3, 64, 64, 16, False),      # non-causal
    (2, 128, 128, 32, False),    # several JAX blocks
    (3, 64, 64, 16, True),       # causal, sq == sk
    (2, 32, 96, 32, True),       # cross lengths, sq < sk
    (2, 100, 77, 16, False),     # ragged lengths
    (2, 1, 64, 32, True),        # single-query decode
    (2, 64, 64, 128, False),     # head_dim 128 (the Llama shape)
    (2, 64, 64, 128, True),
])
def test_fwd_matches_pallas_kernel(bh, sq, sk, d, causal):
    q, k, v = _inputs(bh, sq, sk, d)
    j, t = _both_fwd(q, k, v, causal=causal)
    _assert_close(j, t)


def test_fully_masked_rows_give_zero_output_and_neg_inf_lse():
    # sq > sk under bottom-right causal masking: the first sq - sk rows
    # attend nothing; O = 0 and LSE = NEG_INF + log(1e-30) ~= -1e30
    q, k, v = _inputs(2, 96, 32, 16)
    j, t = _both_fwd(q, k, v, causal=True)
    _assert_close(j, t)
    dead = slice(0, 96 - 32)
    assert np.all(t[0][:, dead] == 0.0)
    assert np.all(t[1][:, dead] < -1e29)
    np.testing.assert_array_equal(t[1][:, dead], j[1][:, dead])
    assert np.all(t[1][:, 96 - 32:] > -1e3)


@pytest.mark.parametrize("dropout_p,causal,seed", [
    (0.1, False, 0), (0.2, True, 7), (0.5, False, -3)])
def test_dropout_matches_pallas_kernel(dropout_p, causal, seed):
    q, k, v = _inputs(3, 64, 64, 16, seed=1)
    j, t = _both_fwd(q, k, v, causal=causal, dropout_p=dropout_p, seed=seed)
    _assert_close(j, t)


@pytest.mark.parametrize("seed", [0, 1, 12345, -1, 2**31 - 1])
@pytest.mark.parametrize("keep_prob", [0.9, 0.5])
def test_keep_mask_is_bitwise_the_kernel_hash(seed, keep_prob):
    sq, sk = 48, 80
    thresh = fa._keep_thresh(1.0 - keep_prob)
    rows_j = jnp.arange(sq, dtype=jnp.int32)[:, None] + jnp.zeros((1, sk), jnp.int32)
    cols_j = jnp.arange(sk, dtype=jnp.int32)[None, :] + jnp.zeros((sq, 1), jnp.int32)
    seed_u = jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
    rows_t = torch.arange(sq)[:, None]
    cols_t = torch.arange(sk)[None, :]
    for b in (0, 1, 5, 977):
        want = np.asarray(fa._keep_mask(seed_u, jnp.asarray(b, jnp.int32), rows_j,
                                        cols_j, sq, sk, thresh))
        got = tfa._keep_mask(seed, torch.tensor(b), rows_t, cols_t, sk, thresh)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0.3 < want.mean() < 1.0


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_inputs(causal):
    q, k, v = _inputs(2, 64, 64, 64, seed=2)
    j, t = _both_fwd(q, k, v, causal=causal, dtype="bfloat16")
    _assert_close(j, t, "bfloat16")


@pytest.mark.parametrize("causal", [False, True])
def test_mha_3d_form(causal):
    q, k, v = _inputs(4, 32, 48, 16, seed=3)
    jo = fa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                block_q=32, block_k=16)
    to = tfa.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 causal=causal, block_q=32, block_k=16)
    assert tuple(to.shape) == q.shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-4)


def test_mha_4d_default_scale_and_seed():
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 3, 32, 16).astype(np.float32) for _ in range(3))
    jo = fa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), dropout_p=0.1)
    to = tfa.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 dropout_p=0.1)
    assert tuple(to.shape) == q.shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-4)
    # an explicit scale is honoured the same way
    jo = fa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.5)
    to = tfa.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 scale=0.5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-4)


def test_cpu_tensors_never_touch_the_kernel():
    before = tfa.launches
    q, k, v = (torch.randn(2, 16, 64) for _ in range(3))
    tfa.mha(q, k, v)
    tfa._fwd(q, k, v, 0, 0.125, True, 0.1)
    assert tfa.launches == before
    # the build is lazy: nothing was compiled or loaded for a CPU call
    assert tfa._lib is None and cuda_build._libs == {}


def test_dropout_p_out_of_range_raises():
    q = torch.randn(1, 8, 16)
    with pytest.raises(ValueError):
        tfa._fwd(q, q, q, 0, 0.25, False, 1.0)
