"""The port's greedy generation (paddle_tpu_torch/text/generation.py)
against the JAX package's: the KV-cached ``llama_generate`` and the generic
full-width ``generate``, on the JAX models' weights carried across by
``convert.load_numpy_state``, at the prompt seeds tests/test_generation.py
uses. Float32 tokens must be identical; the logits behind them agree
within 1e-5 (tests/test_torch_llama.py), far below any top-2 gap these
seeds give. GPT's forward (float32 within 1e-5) and the square subsequent
mask are held here too."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import Transformer as JTransformer
from paddle_tpu.text import generation as jgen
from paddle_tpu.text import models as jmodels
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.text import generate, llama_generate
from paddle_tpu_torch.text import generation as tgen
from paddle_tpu_torch.text import models as tmodels

torch.set_num_threads(1)

LLAMA = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)
GPT = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4, max_seq_len=64)


def _carry(jm, tm):
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    return tm


@pytest.fixture(scope="module", params=[None, 1], ids=["mha", "gqa1"])
def llama(request):
    paddle.seed(3)
    jm = jmodels.LlamaModel(**LLAMA, num_kv_heads=request.param)
    return jm, _carry(jm, tmodels.LlamaModel(**LLAMA, num_kv_heads=request.param,
                                             device="cpu"))


@pytest.fixture(scope="module")
def gpt():
    paddle.seed(4)
    jm = jmodels.GPTModel(**GPT)
    return jm, _carry(jm, tmodels.GPTModel(**GPT, device="cpu"))


def _prompt(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("prompt,n", [
    (_prompt(1, (2, 4), 97), 6),
    (np.array([[7, 11, 13]], np.int32), 5),
    (np.array([3, 1, 4, 1, 5], np.int32), 4),   # a 1-d prompt
    (np.array([[2, 3]], np.int32), 1),           # one new token: the prefill alone
])
def test_llama_generate_matches_jax(llama, prompt, n):
    jm, tm = llama
    want = jgen.llama_generate(jm, prompt, max_new_tokens=n)
    before = tfa.launches
    got = llama_generate(tm, prompt, max_new_tokens=n)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert tfa.launches == before  # CPU: K1's plain version, no launch
    # the model's dispatch takes the cached path by default
    np.testing.assert_array_equal(tm.generate(prompt, max_new_tokens=n), want)


def test_llama_cached_equals_uncached(llama):
    jm, tm = llama
    prompt = _prompt(1, (2, 4), 97)
    cached = tm.generate(prompt, max_new_tokens=6)
    uncached = tm.generate(prompt, max_new_tokens=6, use_cache=False)
    np.testing.assert_array_equal(cached, uncached)
    np.testing.assert_array_equal(uncached, jm.generate(prompt, max_new_tokens=6,
                                                        use_cache=False))


def test_llama_eos_and_max_length_take_the_generic_path(llama):
    jm, tm = llama
    prompt = np.array([[7, 11, 13], [1, 2, 3]], np.int32)
    full = tm.generate(prompt, max_new_tokens=8)
    eos = int(full[0, 4])  # row 0's second new token
    for kw in (dict(max_new_tokens=8, eos_token_id=eos, pad_token_id=5),
               dict(max_length=7)):
        want = jm.generate(prompt, **kw)
        got = tm.generate(prompt, **kw)
        np.testing.assert_array_equal(got, want)
    assert tm.generate(prompt, max_length=3).tolist() == prompt.tolist()


def test_cached_decode_reads_the_cache_in_place(llama, monkeypatch):
    """Every attention of the cached decode gets K/V as prefix views of the
    per-layer cache buffers (no copy before the kernel), causal, with the
    query's rows bottom-right aligned over the valid prefix."""
    _, tm = llama
    seen = []
    real = tfa.mha

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], k.stride(), kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tgen.flash_attention, "mha", spy)
    prompt = _prompt(1, (2, 4), 97)
    tm.generate(prompt, max_new_tokens=3)
    layers, total, hd = LLAMA["num_layers"], 4 + 3, 64
    assert len(seen) == layers * 3
    assert [(sq, sk) for sq, sk, _, _ in seen[::layers]] == [(4, 4), (1, 5), (1, 6)]
    assert all(causal for *_, causal in seen)
    if tm.layers[0].self_attn.num_kv_heads == tm.layers[0].self_attn.num_heads:
        # [B, KV, n, D] views of [B, KV, total, D]: the head stride is the buffer's
        assert all(stride[1:] == (total * hd, hd, 1) for _, _, stride, _ in seen)


@pytest.mark.parametrize("prompt,kw", [
    (_prompt(0, (2, 5), 61), dict(max_new_tokens=6)),
    (np.array([1, 2, 3], np.int32), dict(max_new_tokens=3)),
    (np.array([[5, 6]], np.int32), dict(max_length=6)),
])
def test_gpt_generate_matches_jax(gpt, prompt, kw):
    jm, tm = gpt
    want = jgen.generate(jm, prompt, **kw)
    got = generate(tm, prompt, **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.generate(prompt, **kw), want)


def test_gpt_eos_early_stop(gpt):
    jm, tm = gpt
    prompt = np.array([[1, 2, 3]], np.int32)
    ref = generate(tm, prompt, max_new_tokens=8)
    eos = int(ref[0, 3])  # the first new token is eos: stop right away
    out = tm.generate(prompt, max_new_tokens=8, eos_token_id=eos)
    assert out.shape == (1, 4) and out[0, 3] == eos
    np.testing.assert_array_equal(out, jm.generate(prompt, max_new_tokens=8,
                                                   eos_token_id=eos))


def test_gpt_forward_matches(gpt):
    jm, tm = gpt
    ids = _prompt(2, (3, 9), 61)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the head is wte used transposed: one parameter, no lm_head
    assert "lm_head.weight" not in dict(tm.named_parameters())


def test_square_subsequent_mask_matches():
    want = np.asarray(JTransformer.generate_square_subsequent_mask(5).numpy())
    got = tnn.Transformer.generate_square_subsequent_mask(5, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", [
    lambda m, p: llama_generate(m, p, max_new_tokens=2, do_sample=True),
    lambda m, p: generate(m, p, max_new_tokens=2, do_sample=True, top_k=5),
    lambda m, p: m.generate(p, max_new_tokens=2, do_sample=True, top_p=0.9),
])
def test_sampling_raises(llama, fn):
    with pytest.raises(NotImplementedError, match="do_sample"):
        fn(llama[1], np.array([[1, 2]], np.int32))


def test_greedy_sample_next_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, -1.0, 5.0, 5.0]])
    assert tgen.sample_next(logits).tolist() == [1, 0]
    assert tgen.sample_next(logits).dtype == torch.int32


def test_generation_restores_training_mode(llama):
    _, tm = llama
    tm.train()
    try:
        tm.generate(np.array([[1, 2]], np.int32), max_new_tokens=2)
        assert tm.training
    finally:
        tm.eval()
