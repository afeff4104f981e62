"""The port's CUDA kernels on the card: flash_attention_fwd (K1) against
``mha_reference``, flash_attention_bwd_dq/_dkv (K2/K3) against
``mha_bwd_reference``, wq_matmul (quantized serving's dequantizing
product) against ``wq_matmul_reference``, their refusals, the BERT
forward, a training step and Llama's cached decode through them, the
decode paths captured as CUDA graphs against their eager runs, a
quantized Llama engine's solo = batch, K1's translation forms with a
small beam search against the CPU, and K1-K3 at the training forms with a
small Llama and Transformer step against the CPU, and the conv path (an
f32 conv IEEE with cuDNN's TF32 flag on, BatchNorm's running statistics
against the CPU, a bf16 conv under O1 against f32). Needs a CUDA card
(marker ``gpu``; skipped without one).
This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import copy

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,n", [(1, 193), (128, 128)])
def test_cache_prefix_view_reaches_the_kernel_in_place(cuda, monkeypatch, dtype, sq, n):
    """K/V as the first n rows of a [bh, total, d] cache buffer: K1 gets
    the buffer's own data pointers and its head stride (no copy), and O
    and LSE are the plain version's on the contiguous prefix."""
    bh, total, d = 64, 256, 128
    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(bh, sq, d, device="cuda", generator=g).to(dtype)
    kbuf, vbuf = (torch.randn(bh, total, d, device="cuda", generator=g).to(dtype)
                  for _ in range(2))
    seen = []
    real = fa._launch
    monkeypatch.setattr(fa, "_launch", lambda name, *a: (seen.append(a), real(name, *a)))
    o, lse = fa._fwd(q, kbuf[:, :n], vbuf[:, :n], 0, d ** -0.5, True, 0.0)
    torch.cuda.synchronize()
    (args,) = seen
    assert args[1] == kbuf.data_ptr() and args[2] == vbuf.data_ptr()
    assert args[5:10] == (bh, sq, n, d, total * d)
    ro, rlse = fa.mha_reference(q, kbuf[:, :n].contiguous(), vbuf[:, :n].contiguous(), 0,
                                d ** -0.5, True, 0.0)
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-4


def test_full_width_llama_layer_bf16_matches_its_plain_version(cuda, monkeypatch):
    """One Llama-2-7B decoder layer (hidden 4096, 32 heads of 128, FFN
    11008) in bfloat16 on the card, its causal attention through K1,
    against the same layer with K1 replaced by its plain version: within
    2e-2 of the output's max magnitude."""
    from paddle_tpu_torch.text.models import LlamaDecoderLayer

    layer = LlamaDecoderLayer(4096, 32, 11008, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(0))
    layer.to(torch.bfloat16).eval()
    x = torch.randn(2, 128, 4096, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)).to(torch.bfloat16)
    before = fa.launches
    with torch.inference_mode():
        got = layer(x)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    monkeypatch.setattr(fa, "_fwd", lambda q, k, v, seed, scale, causal, p:
                        fa.mha_reference(q, k, v, seed, scale, causal, p))
    with torch.inference_mode():
        want = layer(x)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err.item() <= 2e-2


def test_small_llama_generate_on_the_card_matches_the_cpu(cuda):
    """A small Llama's cached greedy decode on the card, float32: the same
    tokens as the CPU run of the same weights, one K1 launch per layer per
    forward (the prefill and every step)."""
    from paddle_tpu_torch.text.models import LlamaModel

    cfg = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
               intermediate_size=512)
    gpu = LlamaModel(**cfg, device="cuda", generator=torch.Generator().manual_seed(3))
    cpu = LlamaModel(**cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompt = np.random.RandomState(1).randint(0, 512, (3, 16)).astype(np.int32)
    before = fa.launches
    got = gpu.generate(prompt, max_new_tokens=6)
    assert fa.launches == before + 2 * 6
    np.testing.assert_array_equal(got, cpu.generate(prompt, max_new_tokens=6))
    np.testing.assert_array_equal(gpu.generate(prompt, max_new_tokens=6, use_cache=False), got)


def _lengths_case(b, h, sq, sk, d, dtype, seed=8):
    """q [b*h, sq, d] and a K/V pool [b*h, sk, d] whose rows past each
    batch row's seeded length hold NaN (stale rows K1 must never read)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b * h, sq, d, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(b * h, sk, d, device="cuda", generator=g).to(dtype) for _ in range(2))
    k_len = torch.from_numpy(np.random.RandomState(seed).randint(1, sk + 1, b).astype(np.int32))
    k_len = k_len.cuda()
    stale = torch.arange(sk, device="cuda")[None, :] >= k_len.repeat_interleave(h)[:, None]
    k[stale] = float("nan")
    v[stale] = float("nan")
    return q, k, v, k_len


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(1, 256, True), (1, 100, False), (96, 96, True),
                                          (70, 130, False)])
def test_kernel_with_row_lengths_matches_plain_version(cuda, dtype, d, sq, sk, causal):
    b, h = 6, 4
    q, k, v, k_len = _lengths_case(b, h, sq, sk, d, dtype)
    before = fa.launches
    o, lse = fa._fwd(q, k, v, 0, d ** -0.5, causal, 0.0, k_len=k_len, heads=h)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ro, rlse = fa.mha_reference(q, k, v, 0, d ** -0.5, causal, 0.0, k_len=k_len, heads=h)
    assert torch.isfinite(o).all()
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-4
    # mha's 4-d form passes the lengths per batch row
    o4 = fa.mha(q.view(b, h, sq, d), k.view(b, h, sk, d), v.view(b, h, sk, d),
                causal=causal, k_len=k_len)
    assert torch.equal(o4.view(b * h, sq, d), o)


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_bits_do_not_depend_on_pool_width_or_neighbours(cuda, dtype):
    """A single-query row reads only its slot below its length: its O and
    LSE are the same bits in a pool twice as wide (the new rows NaN) and
    beside other rows' lengths."""
    b, h, sk, d = 16, 32, 256, 128
    q, k, v, k_len = _lengths_case(b, h, 1, sk, d, dtype)
    args = (0, d ** -0.5, True, 0.0)
    o, lse = fa._fwd(q, k, v, *args, k_len=k_len, heads=h)
    wide = [torch.cat([t, torch.full_like(t, float("nan"))], 1) for t in (k, v)]
    o2, lse2 = fa._fwd(q, *wide, *args, k_len=k_len, heads=h)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    clean = [torch.nan_to_num(t) for t in (k, v)]
    other = k_len.clone()
    other[1:] = sk + 1 - k_len[1:]
    o3, lse3 = fa._fwd(q, *clean, *args, k_len=other, heads=h)
    assert torch.equal(o3[:h], o[:h]) and torch.equal(lse3[:h], lse[:h])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,causal", [(1, 193, True), (128, 128, True), (100, 77, False)])
def test_null_lengths_give_the_full_length_bits(cuda, dtype, sq, sk, causal):
    """Without k_len the kernel runs as before: the same bits as every row
    at the operand's full length, and the plain version's values."""
    q, k, v = _qkv(32, sq, sk, 128, dtype)
    o, lse = fa._fwd(q, k, v, 0, 128 ** -0.5, causal, 0.0)
    full = torch.full((8,), sk, dtype=torch.int32, device="cuda")
    o2, lse2 = fa._fwd(q, k, v, 0, 128 ** -0.5, causal, 0.0, k_len=full, heads=4)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = fa.mha_reference(q, k, v, 0, 128 ** -0.5, causal, 0.0)
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-4


def test_kernel_refuses_bad_lengths(cuda):
    q, k, v = _qkv(8, 1, 64, 64, torch.float32)
    with pytest.raises(TypeError):
        fa._fwd(q, k, v, 0, 0.125, False, 0.0, k_len=torch.ones(2, dtype=torch.int64,
                                                                 device="cuda"), heads=4)
    with pytest.raises(ValueError):
        fa._fwd(q, k, v, 0, 0.125, False, 0.0, k_len=torch.ones(3, dtype=torch.int32,
                                                                 device="cuda"), heads=4)


def test_small_llama_engine_on_the_card_batch_equals_solo(cuda):
    """The continuous-batching engine over a small float32 Llama on the
    card, its programs captured as CUDA graphs by ``warmup``: sequences
    decoded together give exactly their solo tokens (alone in the same
    engine), the tokens of the same engine run eagerly, the CPU engine's
    tokens, and one K1 launch per layer in every fill and step, credited
    by the replays."""
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.text.generation import llama_decode_model
    from paddle_tpu_torch.text.models import LlamaModel

    cfg = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
               intermediate_size=512)
    gpu = LlamaModel(**cfg, device="cuda", generator=torch.Generator().manual_seed(3)).eval()
    cpu = LlamaModel(**cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32) for n in (3, 30, 17, 9, 1)]
    with DecodeEngine(llama_decode_model(gpu, 4, 64), max_prompt_len=32) as eng:
        assert eng.warmup() == [8, 16, 24, 32]
        st = eng.stats()
        assert st["cuda_graphs"] and st["graph_pool_bytes"] > 0 and st["graph_replays"] == 0
        assert set(st["programs"]) == {"fill1x8", "fill1x16", "fill1x24", "fill1x32",
                                       "step4x64"}
        assert all(v["compiles"] == 1 and v["capture_ms"] > 0
                   for v in st["programs"].values())
        before = fa.launches
        reqs = [eng.submit(p, max_new_tokens=7) for p in prompts]
        together = [r.result(timeout=300) for r in reqs]
        st = eng.stats()
        fills = st["prefix_fill_steps"]
        assert fa.launches - before == 2 * (fills + st["steps"]) == st["k1_launches"]
        assert st["graph_replays"] == fills + st["steps"]
        assert all(v["compiles"] == 1 for v in st["programs"].values())
        alone = [eng.generate(p, max_new_tokens=7, timeout=300) for p in prompts]
    with DecodeEngine(llama_decode_model(gpu, 4, 64), max_prompt_len=32,
                      cuda_graph=False) as eng:
        eager = [r.result(timeout=300) for r in [eng.submit(p, max_new_tokens=7)
                                                  for p in prompts]]
        assert eng.stats()["graph_replays"] == 0
    with DecodeEngine(llama_decode_model(cpu, 4, 64), device="cpu", max_prompt_len=32) as eng:
        on_cpu = [eng.generate(p, max_new_tokens=7, timeout=300) for p in prompts]
    for t, a, e, c in zip(together, alone, eager, on_cpu):
        assert t.tolist() == a.tolist() == e.tolist() == c.tolist()


def _small_llama(seed=3):
    from paddle_tpu_torch.text.models import LlamaModel

    cfg = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
               intermediate_size=512)
    return LlamaModel(**cfg, device="cuda", generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("sampling", [dict(), dict(do_sample=True, temperature=0.8, top_k=50,
                                                   top_p=0.9, seed=4)])
def test_graphed_llama_generate_equals_eager(cuda, sampling):
    """The captured step, replayed, gives the eager steps' tokens bitwise,
    greedy and sampled (the key splits on the card inside the graph); K1
    is credited once per layer per replay, so the count is one per layer
    per token."""
    from paddle_tpu_torch.text.generation import llama_generate

    model = _small_llama()
    prompt = np.random.RandomState(1).randint(0, 512, (3, 16)).astype(np.int32)
    before = fa.launches
    graphed = llama_generate(model, prompt, max_new_tokens=9, **sampling)
    assert fa.launches - before == 2 * 9
    eager = llama_generate(model, prompt, max_new_tokens=9, cuda_graph=False, **sampling)
    np.testing.assert_array_equal(graphed, eager)
    assert graphed.shape == (3, 25)


def test_replay_credits_the_captured_launches(cuda):
    from paddle_tpu_torch.core.cuda_graph import Graph, pool_bytes

    q, k, v = _qkv(8, 1, 64, 64, torch.float32)
    out = torch.empty_like(q)

    def fn():
        out.copy_(fa._fwd(q, k, v, 0, 0.125, True, 0.0)[0])
        return out

    before = fa.launches
    graph = Graph(fn, q.device)
    assert fa.launches == before + 1  # the warm-up ran; the capture ran nothing
    assert graph.launches == (1, 0, 0, 0) and graph.capture_ms > 0
    assert pool_bytes(graph.pool()) > 0
    out.zero_()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert fa.launches == before + 4 and graph.replays == 3
    assert torch.equal(out, fa._fwd(q, k, v, 0, 0.125, True, 0.0)[0])


def test_a_failed_capture_raises_and_nothing_runs_eagerly(cuda, monkeypatch):
    """A step that syncs with the host cannot be captured: llama_generate
    raises after its prefill and the warm-up step, and the engine fails
    the request retryable; neither runs the eager step in its place."""
    from paddle_tpu_torch.inference.batching import RetryableError
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.text import generation

    model = _small_llama()
    prompt = np.random.RandomState(1).randint(0, 512, (2, 8)).astype(np.int32)
    real_step = generation._CachedLlama.step

    def syncing_step(self):
        real_step(self)
        self.pos.item()  # a host read: fine eagerly, illegal under capture

    monkeypatch.setattr(generation._CachedLlama, "step", syncing_step)
    before = fa.launches
    with pytest.raises(RuntimeError):
        generation.llama_generate(model, prompt, max_new_tokens=6)
    torch.cuda.synchronize()
    assert fa.launches - before == 2 * 2  # the prefill and the warm-up step only
    monkeypatch.undo()

    dm = generation.llama_decode_model(model, 4, 32)
    real_fn = dm.step_fn

    def syncing_step_fn(*args):
        logits = real_fn(*args)
        logits.sum().item()
        return logits

    dm.step_fn = syncing_step_fn
    with DecodeEngine(dm, max_prompt_len=16) as eng:
        req = eng.submit(prompt[0], max_new_tokens=4)
        with pytest.raises(RetryableError):
            req.result(timeout=300)
        st = eng.stats()
        assert st["steps"] == 0 and st["graph_replays"] == st["prefix_fill_steps"] == 1
        assert "step4x32" not in st["programs"]
        assert eng.health()["free_slots"] == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_chunk_form_over_a_prefix_view(cuda, dtype):
    """K1's chunk form (the engine's fill): C queries at positions
    start..start+C-1, causal bottom-right over the first start + C rows of
    a longer staging buffer, read in place; against mha_reference, and a
    row keeps its bits when the operand is C rows wider (the rows below
    it, as the kernel's tile loop stops at each row's diagonal)."""
    h, c, d, total = 4, 32, 128, 160
    g = torch.Generator(device="cuda").manual_seed(5)
    k, v = (torch.randn(h, total, d, device="cuda", generator=g).to(dtype) for _ in range(2))
    for start in (0, 32, 96):
        q = torch.randn(h, 2 * c, d, device="cuda", generator=g).to(dtype)
        end = start + c
        o, lse = fa._fwd(q[:, :c], k[:, :end], v[:, :end], 0, d ** -0.5, True, 0.0)
        ro, rlse = fa.mha_reference(q[:, :c], k[:, :end], v[:, :end], 0, d ** -0.5, True)
        assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
        assert (lse - rlse).abs().max().item() <= 1e-4
        wide, wlse = fa._fwd(q, k[:, :end + c], v[:, :end + c], 0, d ** -0.5, True, 0.0)
        assert torch.equal(wide[:, :c], o) and torch.equal(wlse[:, :c], lse)


def test_prefix_hit_equals_cold_and_resume_on_the_card(cuda):
    """A small bf16 Llama engine on the card, programs captured: prompts
    sharing a 32-token prefix hit and emit exactly their cold tokens (a
    prefix=False engine of the same configuration); a stream resumed from
    its snapshot on the other engine emits exactly the unbroken suffix;
    K1 runs once per layer in every fill and step."""
    from paddle_tpu_torch.inference import wire_spec
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.text.generation import llama_decode_model

    model = _small_llama().to(torch.bfloat16).eval()
    dm = llama_decode_model(model, 4, 96)
    rng = np.random.RandomState(3)
    shared = rng.randint(0, 512, 32).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 512, n).astype(np.int32)])
               for n in (3, 16, 31, 9)]
    with DecodeEngine(dm, max_prompt_len=64, min_seq_bucket=16, name="hot") as hot, \
            DecodeEngine(dm, max_prompt_len=64, min_seq_bucket=16, prefix=False,
                         name="cold") as cold:
        assert hot.warmup() == cold.warmup() == [16, 32, 48, 64]
        before = fa.launches
        hot.generate(prompts[0], max_new_tokens=2, timeout=300)
        got = [r.result(timeout=300) for r in [hot.submit(p, max_new_tokens=9)
                                                for p in prompts]]
        st = hot.stats()
        assert fa.launches - before == 2 * (st["prefix_fill_steps"] + st["steps"])
        assert st["prefix"]["hits"] == len(prompts)
        want = [cold.generate(p, max_new_tokens=9, timeout=300) for p in prompts]
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        req = hot.submit(prompts[2], max_new_tokens=12, snapshot_every=5)
        toks = req.result(timeout=300).tolist()
        snap = req.latest_snapshot()
        n_gen = wire_spec.decode_kv_snapshot_header(snap)["n_generated"]
        resumed = cold.resume(snap).result(timeout=300).tolist()
        assert n_gen == 10 and resumed == toks
        assert all(v["compiles"] == 1 for e in (hot, cold) for v in e.stats()["programs"].values())


def test_weights_digest_on_the_card_equals_the_cpu_copy(cuda):
    """The weights digest of a model on the card equals the digest of the
    same weights on the CPU (bf16 hashed as its raw words), so a snapshot
    taken on one resumes on the other's identity check."""
    from paddle_tpu_torch.text.generation import llama_decode_model

    model = _small_llama().to(torch.bfloat16).eval()
    on_card = llama_decode_model(model, 2, 32).weights_digest()[0]
    on_cpu = llama_decode_model(model.to("cpu"), 2, 32).weights_digest()[0]
    assert on_card == on_cpu


@pytest.mark.parametrize("draft_layers", [2, 1], ids=["self-draft", "layer-skip"])
def test_speculative_equals_plain_on_the_card(cuda, draft_layers):
    """A small bf16 Llama engine on the card with ``spec_k=4``, its
    programs (the verify's k step calls in one graph, the draft's step
    and fills) captured by ``warmup``: opted streams, decoded beside
    non-opted ones, give exactly the plain tokens; a self-draft (the
    target's functions and weights, its own pools and programs) has every
    proposal accepted, which holds only if each verify call is bitwise the
    step; K1 runs once per layer in every target call (a verify replay
    counts k) and every draft call."""
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.text.generation import llama_decode_model, llama_layer_skip

    model = _small_llama().to(torch.bfloat16).eval()
    draft = llama_decode_model(llama_layer_skip(model, draft_layers), 4, 96)
    dm = llama_decode_model(model, 4, 96, draft=draft)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in (5, 40, 17, 1, 29, 12)]
    with DecodeEngine(dm, max_prompt_len=64, min_seq_bucket=16, spec_k=4) as eng:
        assert eng.spec_enabled and eng.warmup() == [16, 32, 48, 64]
        assert set(eng.stats()["programs"]) == {
            "fill1x16", "fill1x32", "fill1x48", "fill1x64", "step4x96", "verify4x96",
            "draft_step4x96", "draft_fill1x16", "draft_fill1x32", "draft_fill1x48",
            "draft_fill1x64"}
        before = fa.launches
        # each prompt twice, opted once: even ones first, odd ones second
        reqs = [eng.submit(p, max_new_tokens=20, speculative=(i % 2 == 0) != (i >= 6))
                for i, p in enumerate(prompts + prompts)]
        got = [r.result(timeout=300).tolist() for r in reqs]
        st = eng.stats()
        sp = st["spec"]
        assert all(got[i] == got[6 + i] for i in range(6))
        assert sp["iterations"] > 0 and sp["verify_steps"] > 0
        if draft_layers == 2:
            assert sp["rejected"] == 0 and sp["accepted"] > 0
        want = (2 * (st["prefix_fill_steps"] + st["steps"] + 4 * sp["verify_steps"])
                + draft_layers * (sp["draft_prefills"] + sp["draft_steps"]))
        assert fa.launches - before == st["k1_launches"] == want
        assert all(v["compiles"] == 1 for v in st["programs"].values())
        assert all(v.get("breaker", {}).get("consecutive_failures", 0) == 0
                   for v in st["programs"].values())



def test_restart_on_the_card_keeps_the_programs(cuda):
    """A small bf16 Llama engine on the card, its programs captured by
    ``warmup``: the scheduler dies at ``serving.decode.loop`` with streams
    in flight; they fail retryable with a prefix of their tokens, the
    replacement thread (on the same card) replays the captured graphs, so
    no program is built again, and the retried streams equal the unbroken
    ones bitwise; no slot leaks, and K1 runs once per layer in every
    replay of the retry."""
    from paddle_tpu_torch.inference.batching import SchedulerRestarted
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.text.generation import llama_decode_model

    model = _small_llama().to(torch.bfloat16).eval()
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in (5, 40, 17, 29)]
    chaos.reset()
    try:
        with DecodeEngine(llama_decode_model(model, 4, 96), max_prompt_len=64,
                          min_seq_bucket=16, watchdog_interval=0.02, wedge_timeout=5.0,
                          name="restart-card") as eng:
            eng.warmup()
            unbroken = [r.result(timeout=300).tolist()
                        for r in [eng.submit(p, max_new_tokens=12) for p in prompts]]
            programs = eng.stats()["programs"]
            chaos.arm("serving.decode.loop", exc=RuntimeError("die"),
                      at=chaos.visits("serving.decode.loop") + 3)
            reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
            for r, want in zip(reqs, unbroken):
                with pytest.raises(SchedulerRestarted):
                    r.result(timeout=300)
                assert r.tokens_so_far() == want[:len(r.tokens_so_far())]
            st0, before = eng.stats(), fa.launches
            retried = [r.result(timeout=300).tolist()
                       for r in [eng.submit(p, max_new_tokens=12) for p in prompts]]
            st, h = eng.stats(), eng.health()
    finally:
        chaos.reset()
    assert retried == unbroken
    assert st["scheduler_restarts"] == 1 and st["programs"] == programs
    assert all(v["compiles"] == 1 for v in st["programs"].values())
    assert h["free_slots"] == 4 and st["active"] == 0 and h["scheduler_alive"]
    calls = (st["prefix_fill_steps"] - st0["prefix_fill_steps"]) + (st["steps"] - st0["steps"])
    assert fa.launches - before == 2 * calls
    assert st["graph_replays"] - st0["graph_replays"] == calls


def test_fill_timer_reads_device_time(cuda):
    """``paddle_decode_step_seconds{phase="fill"}`` reads the device's
    work: a fill call's time is at least the CUDA-event time of the same
    fill replayed alone, not the graph's launch."""
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.text.generation import llama_decode_model
    from paddle_tpu_torch.text.models import LlamaModel

    cfg = dict(vocab_size=512, hidden_size=1024, num_layers=4, num_heads=8,
               intermediate_size=2816)
    model = LlamaModel(**cfg, device="cuda", generator=torch.Generator().manual_seed(1))
    model = model.to(torch.bfloat16).eval()
    prompt = np.random.RandomState(7).randint(0, 512, 128).astype(np.int32)
    with DecodeEngine(llama_decode_model(model, 2, 256), max_prompt_len=128,
                      min_seq_bucket=128, prefix=False, name="fill-timer") as eng:
        eng.warmup()
        for _ in range(5):
            eng.generate(prompt, max_new_tokens=1, timeout=300)
        timer = eng._m_step_exec.value(phase="fill")
        key = ("fill", 1, 128)
        with torch.inference_mode(), eng._exec_lock:
            run = eng._program(key)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
    assert timer["count"] == 5
    assert timer["sum"] / timer["count"] >= 0.9 * float(np.median(times)) > 0


# ------------------------------------------------ wq_matmul (quantized serving)
def _wq_operands(m, k, n, form, seed=0):
    from paddle_tpu_torch.quantization.post_training import _quantize_array

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(k, n, device="cuda", generator=g) * 0.02
    x = torch.randn(m, k, device="cuda", generator=g)
    if form == "w8":
        return (x,) + _quantize_array(w, channel_axis=1)
    return x, w.to(torch.bfloat16), None


@pytest.mark.parametrize("form", ["w8", "bf16w"])
@pytest.mark.parametrize("m,k,n", [(5, 64, 48), (1, 300, 16), (37, 260, 112),
                                   (16, 4096, 4096), (128, 4096, 11008), (16, 11008, 4096),
                                   (16, 4096, 32000), (1, 768, 768), (4096, 768, 3072),
                                   (4096, 3072, 768), (37, 11008, 208), (128, 3072, 1040),
                                   (5, 4096, 11008)])
def test_wq_matmul_matches_plain_version(cuda, form, m, k, n):
    """Every 7B and BERT shape of the path, ragged N tiles (208, 1040: a
    tile of 80 or 16 columns past the last full 128) and ragged K (260,
    300: a chunk of 4 or 44 past the last full 64)."""
    from paddle_tpu_torch.ops import quant_matmul as qmm

    x, w, s = _wq_operands(m, k, n, form)
    before = qmm.launches
    out = qmm.wq_matmul(x, w, s)
    torch.cuda.synchronize()
    assert qmm.launches == before + 1 and out.shape == (m, n) and out.dtype == torch.float32
    ref = qmm.wq_matmul_reference(x, w, s)
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-4


@pytest.mark.parametrize("form", ["w8", "bf16w"])
@pytest.mark.parametrize("scale", [1e30, 1e-30])
def test_wq_matmul_split_is_exact_at_extreme_scales(cuda, form, scale):
    """x at 1e30 and 1e-30: the three bf16 pieces still sum to x, so the
    kernel stays within 1e-4 of its plain version's max."""
    from paddle_tpu_torch.ops import quant_matmul as qmm

    x, w, s = _wq_operands(16, 4096, 1024, form, seed=2)
    x = x * scale
    out = qmm.wq_matmul(x, w, s)
    ref = qmm.wq_matmul_reference(x, w, s)
    assert torch.isfinite(out).all()
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-4


def test_wq_matmul_split_count_is_its_twin(cuda):
    from paddle_tpu_torch.ops import quant_matmul as qmm

    for k in (64, 260, 768, 3072, 4096, 11008):
        for n in (16, 208, 768, 3072, 4096, 11008, 32000):
            assert qmm.kernel_splits(k, n) == qmm.splits(k, n), (k, n)


@pytest.mark.parametrize("form", ["w8", "bf16w"])
@pytest.mark.parametrize("k,n", [(4096, 1024), (768, 3072), (11008, 208)])
def test_wq_matmul_row_bits_do_not_depend_on_m(cuda, form, k, n):
    """A row's sum order is fixed by K and N alone: its bits are the same
    in a 1-, 5-, 16-, 37-, 128- and 4096-row call (the decode engine's
    solo = batch)."""
    from paddle_tpu_torch.ops import quant_matmul as qmm

    x, w, s = _wq_operands(4096, k, n, form, seed=1)
    full = qmm.wq_matmul(x, w, s)
    for m in (1, 5, 16, 37, 128):
        assert torch.equal(qmm.wq_matmul(x[:m], w, s), full[:m])
    assert torch.equal(qmm.wq_matmul(x[7:8], w, s)[0], full[7])
    assert torch.equal(qmm.wq_matmul(x[4000:4037], w, s), full[4000:4037])


def test_wq_matmul_refuses_what_it_does_not_take(cuda):
    from paddle_tpu_torch.ops import quant_matmul as qmm

    x, w, s = _wq_operands(4, 64, 48, "w8")
    with pytest.raises(ValueError, match="scale"):
        qmm.wq_matmul(x, w, None)
    with pytest.raises(TypeError):
        qmm.wq_matmul(x, w.to(torch.float16), None)
    with pytest.raises(ValueError, match="N % 16"):
        qmm.wq_matmul(x, w[:, :40].contiguous(), s[:40].contiguous())
    with pytest.raises(ValueError, match="card"):
        qmm.wq_matmul(x, w.cpu(), s.cpu())
    with pytest.raises(ValueError):
        qmm.wq_matmul(x.double(), w, s)


@pytest.mark.parametrize("mode", ["w8", "bf16w"])
def test_quantized_llama_engine_on_the_card_batch_equals_solo(cuda, mode):
    """A small float32 Llama served under ``quant=mode`` on the card, its
    programs captured: sequences decoded together give their solo tokens,
    the eager engine's and the CPU engine's of the same mode; every step
    replay makes 7 wq_matmul launches a layer and one for the head, every
    fill replay 7 a layer, credited by the replays; no weight is held in
    float32 by the quantized model."""
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.ops import quant_matmul as qmm
    from paddle_tpu_torch.text.generation import llama_decode_model
    from paddle_tpu_torch.text.models import LlamaModel

    gpu = _small_llama().eval()
    cpu = LlamaModel(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                     intermediate_size=512, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32) for n in (3, 30, 17, 9, 1)]
    with DecodeEngine(llama_decode_model(gpu, 4, 64), max_prompt_len=32, quant=mode,
                      name=f"q-{mode}") as eng:
        eng.warmup()
        matrices = [t for n, t in eng._model.params.named_tensors() if t.dim() == 2]
        assert matrices and all(t.dtype != torch.float32 for t in matrices)
        before = qmm.launches
        reqs = [eng.submit(p, max_new_tokens=7) for p in prompts]
        together = [r.result(timeout=300) for r in reqs]
        st = eng.stats()
        assert st["quant"] == mode
        assert qmm.launches - before == 15 * st["steps"] + 14 * st["prefix_fill_steps"]
        assert all(v["compiles"] == 1 for v in st["programs"].values())
        alone = [eng.generate(p, max_new_tokens=7, timeout=300) for p in prompts]
    with DecodeEngine(llama_decode_model(gpu, 4, 64), max_prompt_len=32, quant=mode,
                      cuda_graph=False, name=f"q-{mode}-eager") as eng:
        eager = [r.result(timeout=300) for r in [eng.submit(p, max_new_tokens=7)
                                                  for p in prompts]]
    with DecodeEngine(llama_decode_model(cpu, 4, 64), device="cpu", max_prompt_len=32,
                      quant=mode, name=f"q-{mode}-cpu") as eng:
        on_cpu = [eng.generate(p, max_new_tokens=7, timeout=300) for p in prompts]
    for t, a, e, c in zip(together, alone, eager, on_cpu):
        assert t.tolist() == a.tolist() == e.tolist() == c.tolist()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,sq,sk", [(512, 1, 1), (512, 1, 37), (512, 1, 64), (512, 1, 114),
                                      (128, 64, 64)])
def test_k1_translation_forms(cuda, dtype, bh, sq, sk):
    """K1's forms on Transformer-base's translation path, head_dim 64, no
    mask: a decode step's single query over the self-attention cache
    (1..114 rows after the concat) or the cross-attention's 64 source
    rows, and the encoder's [16 * 8, 64, 64]; K/V made by torch.cat and
    reordered by index_select as the decode step makes them."""
    q, k, v = _qkv(bh, sq, sk, 64, dtype, seed=sk)
    order = torch.randperm(bh, device="cuda")
    k, v = (torch.cat([t[:, :0], t], dim=1).index_select(0, order) for t in (k, v))
    before = fa.launches
    o, lse = fa._fwd(q, k, v, 0, 0.125, False, 0.0)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ro, rlse = fa.mha_reference(q, k, v, 0, 0.125, False, 0.0)
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-4


def test_small_translation_on_the_card_matches_the_cpu(cuda):
    """chip_smoke.translate at d_model 64, one head of 64, float32: the
    card's beams equal the CPU run of the same weights, K1 launched once
    per attention (none is masked)."""
    import chip_smoke
    from paddle_tpu_torch import nn as tnn

    gen = torch.Generator(device="cuda").manual_seed(4)
    gpu = tnn.Transformer(64, 1, 2, 2, 128, device="cuda", generator=gen).eval()
    emb = tnn.Embedding(50, 64, device="cuda", generator=gen).eval()
    with torch.no_grad():
        emb.weight.mul_(0.125)
    cpu, cemb = (m.to("cpu") for m in (copy.deepcopy(gpu), copy.deepcopy(emb)))
    pos = torch.from_numpy(chip_smoke.sinusoid_table(64, 64))
    src = torch.from_numpy(np.random.RandomState(2).randint(3, 50, (2, 10)))
    before = fa.launches
    with torch.inference_mode():
        out, _, lens = chip_smoke.translate(tnn, gpu, emb, pos.cuda(), src.cuda(), beam=3,
                                            max_steps=12)
        steps = out.parent_ids.shape[0]
        assert fa.launches == before + 2 + 2 * 2 * steps
        cout, _, clens = chip_smoke.translate(tnn, cpu, cemb, pos, src, beam=3, max_steps=12)
    assert torch.equal(out.predicted_ids.cpu(), cout.predicted_ids)
    assert torch.equal(out.parent_ids.cpu(), cout.parent_ids)
    assert torch.equal(lens.cpu(), clens)
    assert ((out.scores.cpu() - cout.scores).abs() / cout.scores.abs()).max().item() <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,sq,sk,d,causal,p", [
    (64, 2048, 2048, 128, True, 0.0),  # Llama-374M pretraining, batch 8 x 8 heads
    (8, 2048, 2048, 128, True, 0.0),   # its parity step, batch 1
    (512, 64, 64, 64, False, 0.1),     # Transformer-base training: the encoder
    (512, 48, 64, 64, False, 0.1),     # its cross-attention, Sq != Sk
])
def test_training_forms_match_plain_version(cuda, dtype, bh, sq, sk, d, causal, p):
    """K1, K2 and K3 at the forms the two training paths give them (causal
    head_dim 128 at seq 2048; a partial 48-row q tile with the dropout
    hash indexed by 64 keys) against their plain versions."""
    q, k, v = _qkv(bh, sq, sk, d, dtype, seed=11)
    do = torch.randn(bh, sq, d, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(12)).to(dtype)
    o, lse = fa._fwd(q, k, v, 31, d ** -0.5, causal, p)
    ro, rlse = fa.mha_reference(q, k, v, 31, d ** -0.5, causal, p)
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-4
    got = fa._bwd(q, k, v, o, lse, do, 31, d ** -0.5, causal, p)
    want = fa.mha_bwd_reference(q, k, v, o, lse, do, 31, d ** -0.5, causal, p)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_dropout_lands_where_the_hash_keeps_at_sq_ne_sk(cuda, dtype):
    """The cross-attention's form, 48 queries over 64 keys (d = 64): as
    test_dropout_lands_exactly_where_the_hash_keeps, with dO = the first
    48 rows of I (K3's dV then shows the transposed mask in its first 48
    columns and zeros after)."""
    bh, sq, d, p, seed = 6, 48, 64, 0.3, 2025
    q0 = torch.zeros(bh, sq, d, device="cuda", dtype=dtype)
    k0 = torch.zeros(bh, d, d, device="cuda", dtype=dtype)
    eye = torch.eye(d, device="cuda", dtype=dtype).expand(bh, d, d).contiguous()
    o, lse = fa._fwd(q0, k0, eye, seed, d ** -0.5, False, p)
    _, _, dv = fa._bwd(q0, k0, eye, o, lse, eye[:, :sq].contiguous(), seed, d ** -0.5,
                       False, p)
    lse_d = torch.full((bh, sq, 1), float(np.log(d)), device="cuda")
    dq, _, _ = fa._bwd(q0, eye, eye, q0, lse_d, torch.ones_like(q0), seed, d ** -0.5, False, p)
    keep = fa._dropout_keep(seed, bh, torch.arange(sq, device="cuda")[:, None],
                            torch.arange(d, device="cuda")[None, :], d, p)
    assert torch.equal(o != 0, keep)
    assert torch.equal(dq != 0, keep)
    assert torch.equal(dv[:, :, :sq] != 0, keep.transpose(1, 2))
    assert not dv[:, :, sq:].any()


def _step_on(dev, model, loss_fn, opt_fn, x, y, key, **kw):
    from paddle_tpu_torch.distributed import spmd

    step, init = spmd.build_train_step(model, loss_fn, opt_fn(model), **kw)
    params, state = init()
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    loss, params, state = step(params, state, x.to(dev), y.to(dev), key=key)
    launched = tuple(a - b for a, b in zip((fa.launches, fa.dq_launches, fa.dkv_launches),
                                           before))
    return loss, params, state, launched


def _clipped_grads(state, b1=0.9):
    """The gradients one Adam/AdamW step took, clip included: its first
    moments / (1 - beta1)."""
    return {n: (st[0] / (1 - b1)).cpu() for n, st in state.items()}


def _assert_grads_close(got, want, tol, zero=()):
    """Each gradient within ``tol`` of its own max; those named by a suffix
    in ``zero`` (0 but for rounding: the key projection's bias, which
    softmax ignores) within 1e-5 of the model's largest gradient."""
    model_max = max(g.abs().max().item() for g in want.values())
    for n in want:
        scale, t = ((model_max, 1e-5) if n.endswith(zero)
                    else (max(want[n].abs().max().item(), 1e-30), tol))
        assert (got[n] - want[n]).abs().max().item() <= t * scale, n


def test_small_llama_train_step_on_the_card_matches_the_cpu_and_recomputes(cuda):
    """One O0 step of a small Llama (2 heads of head_dim 128, causal, seq
    256) on the card and on the CPU: loss within 1e-4 relative, the clipped
    gradients (AdamW's first moments) within 1e-3 of each tensor's max,
    parameters within 2.5 * lr; on the card ``recompute=True`` gives the
    same loss bits, gradients within 1e-5 of their max, parameters within
    1e-6 and K1 twice a layer."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.text.models import LlamaModel

    cfg = dict(vocab_size=300, hidden_size=256, num_layers=2, num_heads=2,
               intermediate_size=512)
    gpu = LlamaModel(**cfg, device="cuda", generator=torch.Generator().manual_seed(6))
    cpu = copy.deepcopy(gpu).to("cpu")

    def loss_fn(logits, y):
        return -torch.log_softmax(logits.float(), -1).gather(-1, y[..., None].long()).mean()

    def opt_fn(m):
        return optimizer.AdamW(1e-3, parameters=m.parameters(), weight_decay=0.1,
                                grad_clip=nn.ClipGradByGlobalNorm(1.0))

    rng = np.random.RandomState(3)
    x, y = (torch.from_numpy(rng.randint(0, 300, (2, 256))) for _ in range(2))
    key = prandom.PRNGKey(1)
    gl, gp, gs, glaunch = _step_on("cuda", gpu, loss_fn, opt_fn, x, y, key)
    cl, cp, cs, _ = _step_on("cpu", cpu, loss_fn, opt_fn, x, y, key)
    rl, rp, rs, rlaunch = _step_on("cuda", gpu, loss_fn, opt_fn, x, y, key, recompute=True)
    assert glaunch == (2, 2, 2) and rlaunch == (4, 2, 2)
    assert abs(float(gl) - float(cl)) <= 1e-4 * abs(float(cl))
    assert torch.equal(gl, rl)
    _assert_grads_close(_clipped_grads(gs), _clipped_grads(cs), 1e-3)
    _assert_grads_close(_clipped_grads(rs), _clipped_grads(gs), 1e-5)
    for n in cp:
        assert (gp[n].cpu() - cp[n]).abs().max().item() <= 2.5e-3, n
        assert (gp[n] - rp[n]).abs().max().item() <= 1e-6, n


def test_small_translation_train_step_on_the_card_matches_the_cpu(cuda):
    """One O0 step of chip_smoke.translation_model at d_model 64 (one head
    of 64, dropout 0.1 everywhere, 10 source and 7 target tokens) with
    label smoothing under NoamDecay: the card's loss within 1e-4 relative
    of the CPU's, the gradients (Adam's first moments) within 1e-3 of each
    tensor's max, parameters within 2.5 * lr, K1-K3 at every unmasked
    attention (the encoder's and the cross-attention's)."""
    import chip_smoke
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.core import random as prandom

    gpu = chip_smoke.translation_model(torch, nn, "cuda", torch.Generator(
        device="cuda").manual_seed(7), vocab=50, src_len=10, d_model=64, nhead=1,
        num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=128)
    cpu = copy.deepcopy(gpu).to("cpu")
    F = nn.functional

    def loss_fn(logits, y):
        return F.cross_entropy(logits, F.label_smooth(F.one_hot(y, 50)), soft_label=True)

    def opt_fn(m):
        return optimizer.Adam(optimizer.lr.NoamDecay(64, 4000, last_epoch=3999), beta1=0.9,
                              beta2=0.98, epsilon=1e-9, parameters=m.parameters())

    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randint(3, 50, (3, 17)))
    y = torch.from_numpy(rng.randint(3, 50, (3, 7)))
    gl, gp, gs, glaunch = _step_on("cuda", gpu, loss_fn, opt_fn, x, y, prandom.PRNGKey(2))
    cl, cp, cs, _ = _step_on("cpu", cpu, loss_fn, opt_fn, x, y, prandom.PRNGKey(2))
    assert glaunch == (4, 4, 4)
    assert abs(float(gl) - float(cl)) <= 1e-4 * abs(float(cl))
    _assert_grads_close(_clipped_grads(gs), _clipped_grads(cs), 1e-3, zero=("k_proj.bias",))
    lr = 64 ** -0.5 * 4000 ** -0.5
    for n in cp:
        assert (gp[n].cpu() - cp[n]).abs().max().item() <= 2.5 * lr, n


def test_tensor_api_on_the_card(cuda):
    """The eager Tensor API on the card: to_tensor, an op and backward run
    there (the default place is the card) and agree with the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place

    x = np.random.RandomState(0).standard_normal((4, 5)).astype(np.float32)
    res = {}
    prev = place._CURRENT
    try:
        for dev in ("gpu", "cpu"):
            paddle.set_device(dev)
            t = paddle.to_tensor(x, stop_gradient=False)
            y = paddle.matmul(paddle.tanh(t), t, transpose_y=True)
            y.sum().backward()
            assert t.place == (paddle.CUDAPlace(0) if dev == "gpu" else paddle.CPUPlace())
            res[dev] = (y.numpy(), t.grad.numpy())
    finally:
        place._CURRENT = prev
    for a, b in zip(res["gpu"], res["cpu"]):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


# ------------------------------------------------------- the conv path
def test_f32_conv_is_ieee_with_tf32_on(cuda):
    """A float32 convolution of the port is IEEE float32 whatever cuDNN's
    TF32 flag says (set to True here, globally), forward and backward:
    within 1e-5 of a float64 convolution on the CPU; the flag is as the
    caller left it afterwards."""
    from paddle_tpu_torch.nn import functional as F

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(8, 64, 28, 28, generator=g)
        w = torch.randn(128, 64, 3, 3, generator=g) * 0.05
        xc, wc = x.cuda().requires_grad_(), w.cuda().requires_grad_()
        y = F.conv2d(xc, wc, stride=2, padding=1)
        gy = torch.randn(y.shape, generator=g)
        y.backward(gy.cuda())
        assert torch.backends.cudnn.allow_tf32
        x64, w64 = x.double().requires_grad_(), w.double().requires_grad_()
        y64 = torch.nn.functional.conv2d(x64, w64, stride=2, padding=1)
        y64.backward(gy.double())
        for got, want in ((y, y64), (xc.grad, x64.grad), (wc.grad, w64.grad)):
            err = (got.detach().cpu().double() - want.detach()).abs().max()
            assert err <= 1e-5 * want.abs().max(), float(err)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_batchnorm_statistics_on_the_card_equal_the_cpu(cuda):
    """Three training calls of a BatchNorm2D: the running mean and (biased)
    variance on the card within 1e-5 of the CPU's."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place as pplace

    runs = {}
    for dev in ("cuda", "cpu"):
        prev = pplace._CURRENT
        paddle.set_device("gpu" if dev == "cuda" else "cpu")
        try:
            bn = paddle.nn.BatchNorm2D(16)
        finally:
            pplace._CURRENT = prev
        xs = [torch.randn(8, 16, 14, 14, generator=torch.Generator().manual_seed(i)) * 3 + 1
              for i in range(3)]
        for x in xs:
            bn(x.to(dev))
        runs[dev] = (bn._mean.cpu(), bn._variance.cpu())
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_bf16_conv_under_o1_matches_f32(cuda):
    """Under auto_cast O1 a conv runs in bfloat16 (conv2d is on the white
    list) and the BatchNorm after it in float32 (batch_norm_train on the
    black list): the pair within 2e-2 of its float32 run's max."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, 28, 28, generator=g).cuda()
    w = (torch.randn(64, 32, 3, 3, generator=g) * 0.05).cuda()
    gamma, beta = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")

    def run(level):
        with amp.auto_cast(enable=level == "O1", level="O1"):
            y = F.conv2d(x, w, padding=1)
            z = F.batch_norm(y, None, None, gamma, beta, training=True)
        return y, z

    (y1, z1), (y0, z0) = run("O1"), run("O0")
    assert y1.dtype == torch.bfloat16 and z1.dtype == torch.float32
    for got, want in ((y1, y0), (z1, z0)):
        err = (got.float() - want).abs().max()
        assert err <= 2e-2 * want.abs().max(), float(err)


# ---------------------------------------------------- the data path, int8 conv
class _Squares:
    """A map-style dataset of host arrays: (float32 [3], int64 label)."""

    def __getitem__(self, i):
        return np.full(3, i, np.float32), np.int64(i % 5)

    def __len__(self):
        return 24


def test_worker_loader_after_the_card_yields_card_batches(cuda):
    """A 2-worker DataLoader iterated after the parent has allocated on the
    card: the forked workers never touch CUDA, and every batch reaches the
    card (the parent's pinned, asynchronous copy), bitwise the
    single-process loader's (in order: the workers draw their seeds from
    numpy's generator before the sampler's permutation, so a shuffled order
    differs)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place as pplace

    paddle.set_device("gpu")
    ds = type("Squares", (_Squares, paddle.io.Dataset), {})()
    held = torch.ones(1024, device="cuda")  # the parent's context exists
    try:
        got = {}
        for workers in (2, 0):
            got[workers] = list(paddle.io.DataLoader(ds, batch_size=4, num_workers=workers))
        assert len(got[2]) == 6
        for (x, y), (x0, y0) in zip(got[2], got[0]):
            assert x.is_cuda and y.is_cuda and y.dtype == torch.int32
            assert torch.equal(x, x0) and torch.equal(y, y0)
        assert held.sum().item() == 1024
    finally:
        pplace._CURRENT = pplace.CUDAPlace(0)


def test_int8_conv2d_runs_on_the_card(cuda):
    """Int8Conv2D (quantize_weights over a conv net) on CUDA tensors runs
    on the card, within 1e-5 of its max of the same layer on the CPU; the
    QAT conv too."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.quantization import (ImperativeQuantAware, Int8Conv2D,
                                               quantize_weights)

    from paddle_tpu_torch.core import place as pplace

    paddle.set_device("gpu")
    paddle.seed(0)
    net = paddle.nn.Sequential(paddle.nn.Conv2D(3, 8, 3, padding=1), paddle.nn.ReLU(),
                               paddle.nn.Conv2D(8, 4, 3, stride=2))
    pplace._CURRENT = pplace.CUDAPlace(0)
    qat = ImperativeQuantAware().quantize(copy.deepcopy(net))
    quantize_weights(net)
    assert isinstance(net[0], Int8Conv2D) and net[0].qweight.is_cuda
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 16, 16).astype(np.float32))
    for m in (net, qat.eval()):
        cpu = copy.deepcopy(m).to("cpu")
        with torch.no_grad():
            got, want = m(x.cuda()), cpu(x)
        assert got.is_cuda
        assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
