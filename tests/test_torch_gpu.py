"""The port's CUDA kernels on the card: flash_attention_fwd (K1) against
``mha_reference``, flash_attention_bwd_dq/_dkv (K2/K3) against
``mha_bwd_reference``, their refusals, the BERT forward, a training step
and Llama's cached decode through them, and the decode paths captured as
CUDA graphs against their eager runs. Needs a CUDA card (marker ``gpu``; skipped without one).
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
    tokens, and one K1 launch per layer in every prefill and step, credited
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
        assert eng.warmup() == [8, 16, 32]
        st = eng.stats()
        assert st["cuda_graphs"] and st["graph_pool_bytes"] > 0 and st["graph_replays"] == 0
        assert set(st["programs"]) == {"prefill1x8", "prefill1x16", "prefill1x32", "step4x64"}
        assert all(v["compiles"] == 1 and v["capture_ms"] > 0
                   for v in st["programs"].values())
        before = fa.launches
        reqs = [eng.submit(p, max_new_tokens=7) for p in prompts]
        together = [r.result(timeout=300) for r in reqs]
        st = eng.stats()
        assert fa.launches - before == 2 * (st["prefills"] + st["steps"]) == st["k1_launches"]
        assert st["graph_replays"] == st["prefills"] + st["steps"]
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
    assert graph.launches == (1, 0, 0) and graph.capture_ms > 0
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
        assert st["steps"] == 0 and st["graph_replays"] == st["prefills"] == 1
        assert "step4x32" not in st["programs"]
        assert eng.health()["free_slots"] == 4
