"""The port's CUDA kernels on the card: flash_attention_fwd (K1) against
``mha_reference``, flash_attention_bwd_dq/_dkv (K2/K3) against
``mha_bwd_reference``, their refusals, the BERT forward and a training
step through them. Needs a CUDA card (marker ``gpu``; skipped without one).
This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.text.models import BertModel

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(bh, sq, sk, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, n, d, device="cuda", generator=g).to(dtype)
            for n in (sq, sk, sk)]


# the forms of K1 and of the backward, each run in both dtypes: the f32
# and bf16 forms are separate kernels
FORMS = [
    (8, 100, 77, 64, False, 0.0),    # ragged lengths
    (8, 77, 300, 128, True, 0.0),    # causal, sq < sk
    (8, 300, 77, 64, True, 0.0),     # fully masked rows
    (8, 1, 257, 128, True, 0.0),     # single-query decode
    (8, 256, 256, 64, True, 0.2),    # dropout
    (8, 256, 256, 128, False, 0.1),  # head_dim 128
]
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("bh,sq,sk,d,causal,p,dtype", [
    (12, 128, 128, 64, False, 0.0, torch.float32),
    (96, 512, 512, 64, False, 0.0, torch.bfloat16),
] + [f + (dt,) for f in FORMS for dt in DTYPES])
def test_kernel_matches_plain_version(cuda, bh, sq, sk, d, causal, p, dtype):
    q, k, v = _qkv(bh, sq, sk, d, dtype)
    before = fa.launches
    o, lse = fa._fwd(q, k, v, 99, d ** -0.5, causal, p)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ro, rlse = fa.mha_reference(q, k, v, 99, d ** -0.5, causal, p)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-4


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(2, 16, 16, 32, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa._fwd(q, k, v, 0, 0.2, False, 0.0)
    q, k, v = _qkv(2, 16, 16, 64, torch.float16)
    with pytest.raises(TypeError):
        fa._fwd(q, k, v, 0, 0.125, False, 0.0)
    q, k, v = _qkv(2, 16, 16, 64, torch.float32)
    q.requires_grad_(True)
    # a CUDA input that needs a gradient now goes through K2/K3
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    fa.mha(q, k, v).sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(n + 1 for n in before)
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    with torch.no_grad():
        assert fa.mha(q, k, v).shape == q.shape
    with pytest.raises(ValueError):
        fa._fwd(q.detach(), k.cpu(), v, 0, 0.125, False, 0.0)
    o, lse = fa._fwd(q.detach(), k, v, 0, 0.125, False, 0.0)
    with pytest.raises(TypeError):  # dO of another dtype
        fa._bwd(q.detach(), k, v, o, lse, o.double(), 0, 0.125, False, 0.0)
    with pytest.raises(ValueError):  # a CPU dO
        fa._bwd(q.detach(), k, v, o, lse, o.cpu(), 0, 0.125, False, 0.0)


def _rel_err(a, b):
    """max |a - b| over max |b| (the gradient's own scale)."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("bh,sq,sk,d,causal,p,dtype", [
    (24, 128, 128, 64, False, 0.0, torch.float32),
    (24, 128, 128, 64, False, 0.1, torch.bfloat16),
    (8, 256, 256, 128, True, 0.2, torch.bfloat16),
    (8, 256, 256, 64, True, 0.1, torch.float32),
] + [f + (dt,) for f in FORMS for dt in DTYPES])
def test_backward_kernels_match_plain_version(cuda, bh, sq, sk, d, causal, p, dtype):
    """K2 and K3 against mha_bwd_reference on the same saved O and LSE:
    within 1e-4 (f32) / 2e-2 (bf16) of the gradient's max magnitude."""
    q, k, v = _qkv(bh, sq, sk, d, dtype, seed=3)
    do = torch.randn(bh, sq, d, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(4)).to(dtype)
    o, lse = fa._fwd(q, k, v, 77, d ** -0.5, causal, p)
    before = (fa.dq_launches, fa.dkv_launches)
    got = fa._bwd(q, k, v, o, lse, do, 77, d ** -0.5, causal, p)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    want = fa.mha_bwd_reference(q, k, v, o, lse, do, 77, d ** -0.5, causal, p)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel_err(g, w) <= TOL[dtype]
    if causal and sq > sk:
        assert (got[0][:, :sq - sk] == 0).all()
    # deterministic: no atomics, the same bits run to run
    again = fa._bwd(q, k, v, o, lse, do, 77, d ** -0.5, causal, p)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dropout_lands_exactly_where_the_hash_keeps(cuda, d, dtype):
    """q = k = 0 makes every p 1/sk. With V = I (sk = d), K1's O is
    non-zero exactly where ``_keep_mask`` keeps (row, col); with dO = I (sq
    = d), K3's dV is non-zero exactly at the transposed mask. With q = 0,
    K = V = I, dO = ones, O = 0 (delta = 0) and LSE = log d, K2's dQ =
    scale * P * keep / (1 - p) is non-zero exactly where kept (the premise
    is held on the CPU in test_torch_flash_attention.py). A value tolerance
    alone could miss a mask placed one element off."""
    bh, p, seed = 6, 0.3, 2024
    zeros = torch.zeros(bh, d, d, device="cuda", dtype=dtype)
    eye = torch.eye(d, device="cuda", dtype=dtype).expand(bh, d, d).contiguous()
    o, lse = fa._fwd(zeros, zeros, eye, seed, d ** -0.5, False, p)
    _, _, dv = fa._bwd(zeros, zeros, eye, o, lse, eye, seed, d ** -0.5, False, p)
    lse_d = torch.full((bh, d, 1), float(np.log(d)), device="cuda")
    dq, _, _ = fa._bwd(zeros, eye, eye, zeros, lse_d, torch.ones_like(zeros), seed,
                       d ** -0.5, False, p)
    idx = torch.arange(d, device="cuda")
    keep = fa._dropout_keep(seed, bh, idx[:, None], idx[None, :], d, p)
    assert 0.5 < keep.float().mean().item() < 0.9
    assert torch.equal(o != 0, keep)
    assert torch.equal(dq != 0, keep)
    assert torch.equal(dv != 0, keep.transpose(1, 2))


def test_kernels_take_unaligned_views(cuda):
    """A view that does not start on a 16-byte boundary is copied once
    before the kernels' 16-byte staging copies; the result is the plain
    version's."""
    for dtype in DTYPES:
        g = torch.Generator(device="cuda").manual_seed(5)
        base = torch.randn(3 * 8 * 96 * 64 + 1, device="cuda", generator=g).to(dtype)
        q, k, v = base[1:].view(3, 8, 96, 64).unbind(0)
        assert q.data_ptr() % 16 != 0
        o, lse = fa._fwd(q, k, v, 1, 0.125, True, 0.0)
        ro, rlse = fa.mha_reference(q, k, v, 1, 0.125, True, 0.0)
        assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
        got = fa._bwd(q, k, v, o, lse, q, 1, 0.125, True, 0.0)
        want = fa.mha_bwd_reference(q, k, v, o, lse, q, 1, 0.125, True, 0.0)
        for a, b in zip(got, want):
            assert _rel_err(a, b) <= TOL[dtype]


def test_shared_memory_of_the_redesigned_kernels(cuda):
    """The bf16 forms stage bf16 tiles: K1 about 45 / 85 KB, K2 54 / 102 KB
    and K3 about 55 / 103 KB at head_dim 64 / 128. K2's f32 form holds Q,
    dO, K and V rows, LSE and delta (dS takes V's buffer); K3's K, V, a
    32-row Q and dO tile and one dS/P buffer: three blocks per SM at
    head_dim 64 for both. Every form fits one block."""
    sizes = {(name, d, dt): fa.smem_bytes(d, name, dt)
             for name in fa._LIBS for d in fa.HEAD_DIMS for dt in DTYPES}
    assert sizes["flash_attention_fwd", 64, torch.bfloat16] == 46080
    assert sizes["flash_attention_fwd", 128, torch.bfloat16] == 87040
    assert sizes["flash_attention_bwd_dq", 64, torch.bfloat16] == 55296
    assert sizes["flash_attention_bwd_dq", 128, torch.bfloat16] == 104448
    assert sizes["flash_attention_bwd_dq", 64, torch.float32] == 70144
    assert sizes["flash_attention_bwd_dq", 128, torch.float32] == 135680
    assert sizes["flash_attention_bwd_dkv", 64, torch.bfloat16] == 56320
    assert sizes["flash_attention_bwd_dkv", 128, torch.bfloat16] == 105472
    assert sizes["flash_attention_bwd_dkv", 64, torch.float32] == 61696
    assert sizes["flash_attention_bwd_dkv", 128, torch.float32] == 110848
    assert all(0 < b <= 232448 for b in sizes.values())
    # three blocks of K2's and K3's f32 forms share an SM's 228 KB (each
    # block also reserves 1 KB)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert 3 * (sizes[name, 64, torch.float32] + 1024) <= 233472


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One O0 build_train_step step of a small BertForPretraining on the
    card and on the CPU from the same weights, batch and key: the same
    dropout masks, loss within 1e-4 relative, updated parameters within
    2.5 * lr (AdamW's first step is about lr * sign(g))."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.distributed import spmd
    from paddle_tpu_torch.text.models import BertForPretraining

    cfg = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=512)
    gpu = BertForPretraining(**cfg, device="cuda", generator=torch.Generator().manual_seed(2))
    cpu = BertForPretraining(**cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})

    def loss_fn(out, y):
        return -torch.log_softmax(out[0].float(), -1).gather(-1, y[..., None]).mean()

    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 128)))
    y = torch.from_numpy(np.random.RandomState(1).randint(0, 512, (2, 128)))
    res = []
    for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
        opt = optimizer.AdamW(1e-3, parameters=m.parameters(),
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        step, init = spmd.build_train_step(m, loss_fn, opt)
        params, state = init()
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        loss, params, _ = step(params, state, ids.to(dev), y.to(dev),
                               key=prandom.PRNGKey(5))
        launched = tuple(a - b for a, b in zip((fa.launches, fa.dq_launches,
                                                fa.dkv_launches), before))
        res.append((float(loss), {n: t.cpu() for n, t in params.items()}, launched))
    (gl, gp, glaunch), (cl, cp, claunch) = res
    assert glaunch == (2, 2, 2) and claunch == (0, 0, 0)
    assert abs(gl - cl) <= 1e-4 * abs(cl)
    for n in cp:
        assert (gp[n] - cp[n]).abs().max().item() <= 2.5e-3, n


def test_bert_forward_on_the_card_matches_the_cpu(cuda):
    cfg = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=512)
    gpu = BertModel(**cfg, device="cuda", generator=torch.Generator().manual_seed(1)).eval()
    cpu = BertModel(**cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (3, 128)))
    before = fa.launches
    with torch.inference_mode():
        gs, gp = gpu(ids.cuda())
        cs, cp = cpu(ids)
    assert fa.launches == before + cfg["num_hidden_layers"]
    assert (gs.cpu() - cs).abs().max().item() <= 1e-3
    assert (gp.cpu() - cp).abs().max().item() <= 1e-3
