"""The port's flash attention (paddle_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernels, run here in interpret mode.

On the CPU the port's ``_fwd`` runs ``mha_reference`` and its ``_bwd``
runs ``mha_bwd_reference``, the plain versions that sit beside the CUDA
kernels; tests/test_torch_gpu.py holds the kernels themselves against them
on the card. Inputs come from a numpy seed and go through both.
Tolerances: forward 2e-4 in float32 (as tests/test_pallas_kernels.py),
2e-2 in bfloat16 (P is rounded to bf16 before the PV product at different
points: per tile in the JAX kernel, once in the plain version); backward
1e-5 abs in float32 against the JAX ``_bwd`` (the same formulas, summed in
another order) and 2e-2 abs in bfloat16; 1e-5 abs against torch autograd
of ``mha_reference`` in float32.
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
    assert tfa._libs == {} and cuda_build._libs == {}


def test_dropout_p_out_of_range_raises():
    q = torch.randn(1, 8, 16)
    with pytest.raises(ValueError):
        tfa._fwd(q, q, q, 0, 0.25, False, 1.0)


# ------------------------------------------------------------------ backward


def _both_bwd(bh, sq, sk, d, *, causal, dropout_p=0.0, seed=0, dtype="float32"):
    """(JAX dq, dk, dv), (port dq, dk, dv) as float32 numpy arrays, both from
    the JAX forward's O and LSE on the same inputs."""
    rng = np.random.RandomState(11)
    q, k, v, do = (rng.randn(bh, n, d).astype(np.float32) for n in (sq, sk, sk, sq))
    scale = 1.0 / np.sqrt(d)
    bq, bk = fa._block(sq, 256), fa._block(sk, 256)
    seed2d = jnp.asarray(seed, jnp.int32).reshape(1, 1)
    jq, jk, jv, jdo = (jnp.asarray(x, JDT[dtype]) for x in (q, k, v, do))
    o, lse = fa._fwd(jq, jk, jv, seed2d, scale, causal, bq, bk, dropout_p)
    jg = fa._bwd(scale, causal, bq, bk, dropout_p, (jq, jk, jv, o, lse, seed2d), jdo)
    td = TDT[dtype]
    tg = tfa._bwd(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                  torch.from_numpy(np.array(o, np.float32)).to(td),
                  torch.from_numpy(np.array(lse)),
                  torch.from_numpy(do).to(td), seed, scale, causal, dropout_p)
    for t, x in zip(tg, (q, k, v)):
        assert t.dtype == td and tuple(t.shape) == x.shape
    return ([np.asarray(g, np.float32) for g in jg], [t.float().numpy() for t in tg])


@pytest.mark.parametrize("bh,sq,sk,d,causal,dropout_p,seed", [
    (3, 64, 64, 16, False, 0.0, 0),
    (2, 128, 128, 32, True, 0.0, 0),      # causal, sq == sk
    (2, 32, 96, 32, True, 0.0, 0),        # causal, sq < sk
    (2, 96, 32, 16, True, 0.0, 0),        # fully masked rows
    (2, 100, 77, 16, False, 0.0, 0),      # ragged lengths
    (2, 64, 64, 128, False, 0.0, 0),      # head_dim 128
    (3, 64, 64, 16, False, 0.1, -1),      # dropout, seed -1
    (2, 64, 64, 32, True, 0.2, 2**31 - 1),
    (2, 96, 32, 16, True, 0.1, 5),        # dropout over fully masked rows
])
def test_bwd_reference_matches_pallas_bwd(bh, sq, sk, d, causal, dropout_p, seed):
    j, t = _both_bwd(bh, sq, sk, d, causal=causal, dropout_p=dropout_p, seed=seed)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    if sq > sk and causal:
        # rows that attend nothing have no gradient
        assert np.all(t[0][:, :sq - sk] == 0.0)


@pytest.mark.parametrize("causal,dropout_p", [(False, 0.1), (True, 0.0)])
def test_bwd_reference_matches_pallas_bwd_bf16(causal, dropout_p):
    j, t = _both_bwd(2, 64, 64, 64, causal=causal, dropout_p=dropout_p, seed=3,
                     dtype="bfloat16")
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-2)


@pytest.mark.parametrize("sq,sk,causal,dropout_p,seed", [
    (48, 48, False, 0.0, 0), (32, 80, True, 0.0, 0), (80, 32, True, 0.0, 0),
    (48, 48, False, 0.3, -1), (40, 56, True, 0.1, 2**31 - 1)])
def test_function_gradients_match_autograd_of_the_plain_forward(sq, sk, causal,
                                                                dropout_p, seed):
    """The autograd Function (K1 forward, K2/K3 backward; their plain
    versions here) against torch autograd through ``mha_reference``."""
    rng = np.random.RandomState(5)
    b, h, d = 2, 3, 16
    arrs = [rng.randn(b, h, n, d).astype(np.float32) for n in (sq, sk, sk, sq)]
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs[:3]]
    out = tfa.mha(*leaves, causal=causal, dropout_p=dropout_p, seed=seed)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(arrs[3]))
    ref_leaves = [torch.tensor(a, requires_grad=True) for a in arrs[:3]]
    flat = [x.reshape(b * h, -1, d) for x in ref_leaves]
    ref_out, _ = tfa.mha_reference(*flat, seed, d ** -0.5, causal, dropout_p)
    want = torch.autograd.grad(ref_out, ref_leaves,
                               torch.from_numpy(arrs[3]).reshape(b * h, sq, d))
    np.testing.assert_allclose(out.detach().numpy(),
                               ref_out.detach().reshape(out.shape).numpy(), atol=1e-6)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dq_dropout_placement_premise(d, dtype):
    """The construction of the card's K2 dropout-placement check, held
    through the plain version: q = 0, K = V = I, dO = ones, O = 0 (so
    delta = 0) and LSE = log d give P = 1/d, dP = 1 dropped to keep / (1 -
    p), dS = P * dP and dQ = scale * dS K = scale * dS: non-zero exactly
    where ``_keep_mask`` keeps, and that value there."""
    bh, p, seed = 3, 0.3, 2024
    td = TDT[dtype]
    zeros = torch.zeros(bh, d, d, dtype=td)
    eye = torch.eye(d, dtype=td).expand(bh, d, d).contiguous()
    lse = torch.full((bh, d, 1), float(np.log(d)))
    dq, _, _ = tfa.mha_bwd_reference(zeros, eye, eye, zeros, lse, torch.ones_like(zeros),
                                     seed, d ** -0.5, False, p)
    idx = torch.arange(d)
    keep = tfa._dropout_keep(seed, bh, idx[:, None], idx[None, :], d, p)
    assert 0.5 < keep.float().mean().item() < 0.9
    assert torch.equal(dq != 0, keep)
    want = torch.where(keep, d ** -0.5 / (d * (1 - p)), 0.0)
    tol = TOL[dtype]
    torch.testing.assert_close(dq.float(), want, rtol=tol, atol=0)


def test_function_saves_nothing_without_grad_and_launches_nothing_on_cpu():
    q = torch.randn(1, 2, 16, 64, requires_grad=True)
    with torch.no_grad():
        assert tfa.mha(q, q, q).grad_fn is None
    counts = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    out = tfa.mha(q, q, q, dropout_p=0.1, seed=4)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == counts


# ------------------------------------------------------------- cache views


@pytest.mark.parametrize("sq,n", [(1, 40), (40, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_on_a_prefix_view_of_a_longer_cache(sq, n, dtype):
    """The cached decode's form: K and V are the first n rows of a longer
    [B, H, total, D] buffer, causal with sq = 1 (one decode step) and
    sq = sk (the prefill). The view goes to K1 as it lies; here its plain
    version, held against the Pallas kernel on the contiguous prefix."""
    rng = np.random.RandomState(6)
    b, h, total, d = 2, 3, 64, 128
    q = rng.randn(b, h, sq, d).astype(np.float32)
    kbuf, vbuf = (rng.randn(b, h, total, d).astype(np.float32) for _ in range(2))
    jd, td = JDT[dtype], TDT[dtype]
    jo = fa.mha(*(jnp.asarray(x, jd) for x in (q, kbuf[:, :, :n], vbuf[:, :, :n])),
                causal=True)
    tk, tv = (torch.from_numpy(x).to(td) for x in (kbuf, vbuf))
    kview, vview = tk[:, :, :n], tv[:, :, :n]
    assert not kview.is_contiguous()
    to = tfa.mha(torch.from_numpy(q).to(td), kview, vview, causal=True)
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_kv_operand_passes_cache_views_through():
    """K1's K/V operand: a [bh, sk, d] tensor with contiguous rows and a
    16-byte head stride goes to the kernel in place with that stride (the
    first sk rows of a longer buffer); anything else is copied first."""
    buf = torch.zeros(6, 50, 64)
    view = buf[:, :20]
    t, stride = tfa._kv_operand(view)
    assert t.data_ptr() == buf.data_ptr() and stride == 50 * 64
    t, stride = tfa._kv_operand(buf)
    assert t is buf and stride == 50 * 64
    # rows that are not contiguous (a transposed view) are copied
    tr = torch.zeros(6, 64, 20).transpose(1, 2)
    t, stride = tfa._kv_operand(tr)
    assert t.is_contiguous() and stride == 20 * 64 and torch.equal(t, tr)
    # a head stride that is not a multiple of 16 bytes (5 * 3 floats) is copied
    odd = torch.zeros(4, 5, 3)[:, :2]
    t, stride = tfa._kv_operand(odd)
    assert t.is_contiguous() and stride == 2 * 3
    # one head: its stride does not matter
    t, stride = tfa._kv_operand(buf[:1, :20])
    assert t.data_ptr() == buf.data_ptr() and stride == 20 * 64
