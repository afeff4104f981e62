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


@pytest.mark.parametrize("bh,sq,sk,d,causal,p,dtype", [
    (12, 128, 128, 64, False, 0.0, torch.float32),
    (96, 512, 512, 64, False, 0.0, torch.bfloat16),
    (8, 100, 77, 64, False, 0.0, torch.float32),
    (8, 77, 300, 128, True, 0.0, torch.float32),
    (8, 300, 77, 64, True, 0.0, torch.float32),   # fully masked rows
    (8, 1, 257, 128, True, 0.0, torch.bfloat16),  # single-query decode
    (8, 256, 256, 64, True, 0.2, torch.float32),
])
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
    (8, 100, 77, 64, False, 0.0, torch.float32),    # ragged lengths
    (8, 77, 300, 128, True, 0.0, torch.float32),    # causal, sq < sk
    (8, 300, 77, 64, True, 0.0, torch.float32),     # fully masked rows
    (8, 256, 256, 128, True, 0.2, torch.bfloat16),
    (8, 256, 256, 64, True, 0.1, torch.float32),
])
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
