"""The port's generation (paddle_tpu_torch/text/generation.py) against the
JAX package's: the KV-cached ``llama_generate`` and the generic full-width
``generate``, greedy and sampled, on the JAX models' weights carried
across by ``convert.load_numpy_state``, at the prompt seeds
tests/test_generation.py uses. Float32 tokens must be identical; the
logits behind them agree within 1e-5 (tests/test_torch_llama.py), far
below any top-2 gap these seeds give. A sampled token is the first
maximum of the filtered logits plus jax's Gumbel noise: the noise is
bitwise but for each log's last ulp (tests/test_torch_random.py), so
sampled tokens are equal except at a near-tie of those perturbed scores
(below 1e-5, computed on the JAX side), which these seeds never give (the
tests count them). ``sample_next`` is held against the jitted reference
(XLA turns the temperature's division into a product with the
reciprocal). GPT's forward (float32 within 1e-5) and the square
subsequent mask are held here too."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import Transformer as JTransformer
from paddle_tpu.text import generation as jgen
from paddle_tpu.text import models as jmodels
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.core import random as trandom
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
    """Every attention of the cached decode gets K/V as views of the
    per-layer cache buffers (no copy before the kernel), causal: the
    prefill over the cache's first t0 rows, each step over the whole cache
    at the device length ``k_len`` = its position + 1 in every row."""
    _, tm = llama
    seen = []
    real = tfa.mha

    def spy(q, k, v, **kw):
        k_len = kw.get("k_len")
        seen.append((q.shape[2], k.shape[2], k.stride(), kw["causal"],
                     None if k_len is None else k_len.tolist()))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tgen.flash_attention, "mha", spy)
    prompt = _prompt(1, (2, 4), 97)
    tm.generate(prompt, max_new_tokens=3)
    layers, total, hd = LLAMA["num_layers"], 4 + 3, 64
    assert len(seen) == layers * 3
    assert [(sq, sk, k_len) for sq, sk, _, _, k_len in seen[::layers]] == [
        (4, 4, None), (1, total, [5, 5]), (1, total, [6, 6])]
    assert all(causal for *_, causal, _ in seen)
    if tm.layers[0].self_attn.num_kv_heads == tm.layers[0].self_attn.num_heads:
        # [B, KV, n, D] views of [B, KV, total, D]: the head stride is the buffer's
        assert all(stride[1:] == (total * hd, hd, 1) for _, _, stride, _, _ in seen)


@pytest.mark.parametrize("prompt,n", [(_prompt(1, (2, 4), 97), 6), (_prompt(5, (3, 9), 97), 4)])
def test_static_step_gives_the_prefix_loops_tokens(llama, prompt, n):
    """The one-shape step (K1's length form over the whole cache, state on
    the device) against the loop it replaced: each step through the
    prefix form over the cache's first t0 + i rows."""
    _, tm = llama
    b, t0 = prompt.shape
    with torch.inference_mode():
        run = tgen._CachedLlama(tm, b, t0, n)
        tok = tgen.sample_next(run.forward(torch.from_numpy(prompt), 0)[:, -1])
        want = [tok]
        for i in range(1, n):
            tok = tgen.sample_next(run.forward(tok[:, None], t0 + i - 1)[:, -1])
            want.append(tok)
    got = llama_generate(tm, prompt, max_new_tokens=n)[:, t0:]
    np.testing.assert_array_equal(got, torch.stack(want, 1).numpy())


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


# ------------------------------------------------------------------ sampling
NEAR_TIE = 1e-5
_jit_sample_next = jax.jit(jgen.sample_next,
                           static_argnames=("do_sample", "temperature", "top_k", "top_p"))


@jax.jit
def _jax_gap(scores):
    top2 = jax.lax.top_k(scores, 2)[0]
    return top2[..., 0] - top2[..., 1]


@functools.lru_cache(maxsize=None)
def _scores_fn(temperature, top_k, top_p):
    """The reference's sampled scores (its sample_next before the argmax),
    jitted as it runs."""
    @jax.jit
    def scores(lg, key):
        lg = lg.astype(jnp.float32)
        if temperature != 1.0:
            lg = lg / jnp.maximum(temperature, 1e-6)
        if top_k:
            lg = jgen._apply_top_k(lg, top_k)
        if top_p < 1.0:
            lg = jgen._apply_top_p(lg, top_p)
        return jax.random.gumbel(key, lg.shape, jnp.float32) + lg
    return scores


def _perturbed(logits, key, temperature, top_k, top_p):
    return _scores_fn(temperature, top_k, top_p)(logits, key)


def _near_ties(jm, out, t0, keys, cfg):
    """Generated positions of the JAX output ``out`` whose perturbed scores
    (teacher-forced logits of one JAX forward, the step's key) have their
    top two within NEAR_TIE."""
    logits = jnp.asarray(np.asarray(jm(paddle.to_tensor(out)).numpy()))
    ties = 0
    for i, key in enumerate(keys):
        gap = np.asarray(_jax_gap(_perturbed(logits[:, t0 - 1 + i], key, **cfg)))
        ties += int((gap < NEAR_TIE).sum())
    return ties


SAMPLING = [dict(temperature=0.8, top_k=50, top_p=0.9), dict(temperature=1.0, top_k=0, top_p=1.0),
            dict(temperature=1.3, top_k=5, top_p=1.0), dict(temperature=0.6, top_k=0, top_p=0.5)]


@pytest.mark.parametrize("cfg", SAMPLING[:2])
@pytest.mark.parametrize("prompt,n,seed", [(_prompt(1, (2, 4), 97), 6, 0),
                                           (_prompt(6, (3, 5), 97), 5, 11)])
def test_sampled_llama_generate_matches_jax(llama, cfg, prompt, n, seed):
    """The first token draws with PRNGKey(seed) itself, each later step
    with ``sub`` of ``key, sub = split(key)`` on the device."""
    jm, tm = llama
    want = jgen.llama_generate(jm, prompt, max_new_tokens=n, do_sample=True, seed=seed, **cfg)
    got = llama_generate(tm, prompt, max_new_tokens=n, do_sample=True, seed=seed, **cfg)
    key = jax.random.PRNGKey(seed)
    keys = [key]
    for _ in range(1, n):
        key, sub = jax.random.split(key)
        keys.append(sub)
    assert _near_ties(jm, want, prompt.shape[1], keys, cfg) == 0
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the model's dispatch takes the cached path with the sampling options
    np.testing.assert_array_equal(
        tm.generate(prompt, max_new_tokens=n, do_sample=True, seed=seed, **cfg), want)


@pytest.mark.parametrize("cfg", SAMPLING[::2])
@pytest.mark.parametrize("prompt,kw", [(_prompt(0, (2, 5), 61), dict(max_new_tokens=6, seed=3)),
                                       (np.array([[5, 6]], np.int32), dict(max_length=7))])
def test_sampled_gpt_generate_matches_jax(gpt, cfg, prompt, kw):
    """The generic path splits the host key before every step."""
    jm, tm = gpt
    want = jgen.generate(jm, prompt, do_sample=True, **kw, **cfg)
    got = generate(tm, prompt, do_sample=True, **kw, **cfg)
    key = jax.random.PRNGKey(kw.get("seed", 0))
    keys = []
    for _ in range(want.shape[1] - prompt.shape[1]):
        key, sub = jax.random.split(key)
        keys.append(sub)
    assert _near_ties(jm, want, prompt.shape[1], keys, cfg) == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature", [1.0, 0.7, 1e-7])
@pytest.mark.parametrize("top_k", [0, 1, 40])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.3])
def test_sample_next_matches_jitted_reference(temperature, top_k, top_p):
    rng = np.random.RandomState(int(temperature * 10) + top_k + int(top_p * 10))
    logits = (rng.randn(8, 500) * 3).astype(np.float32)
    cfg = dict(do_sample=True, temperature=temperature, top_k=top_k, top_p=top_p)
    for seed in (0, 9):
        want = np.asarray(_jit_sample_next(jnp.asarray(logits), jax.random.PRNGKey(seed), **cfg))
        gap = np.asarray(_jax_gap(_perturbed(jnp.asarray(logits), jax.random.PRNGKey(seed),
                                             temperature, top_k, top_p)))
        assert (gap < NEAR_TIE).sum() == 0
        got = tgen.sample_next(torch.from_numpy(logits), trandom.PRNGKey(seed), **cfg)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # a key on the device gives the same draw
        dev_key = trandom.key_tensor(trandom.PRNGKey(seed), "cpu")
        assert torch.equal(tgen.sample_next(torch.from_numpy(logits), dev_key, **cfg), got)


def test_top_filters_match_the_reference():
    logits = (np.random.RandomState(3).randn(4, 300) * 2).astype(np.float32)
    t = torch.from_numpy(logits)
    for k in (1, 7, 300):
        np.testing.assert_array_equal(tgen._apply_top_k(t, k).numpy(),
                                      np.asarray(jgen._apply_top_k(jnp.asarray(logits), k)))
    for p in (0.05, 0.5, 0.95, 0.999999):
        np.testing.assert_array_equal(tgen._apply_top_p(t, p).numpy(),
                                      np.asarray(jgen._apply_top_p(jnp.asarray(logits), p)))


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
