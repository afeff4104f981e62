"""The port's continuous-batching decode engine
(paddle_tpu_torch/inference/decode.py) and its wire stream, on the CPU.

- A torch twin of tests/decode_worker.py's ``toy_decode_model`` (the same
  ``RandomState`` draws, the same maths, the port's model contract: KV in
  per-slot pools written in place by the step) holds the engine against
  the JAX package's: prefill/step logits within 1e-5 (float32), and the
  port engine's greedy tokens equal to the JAX ``DecodeEngine``'s.
- The reference's engine tests (tests/test_decode.py), mirrored: a
  sequence decoded in a batch emits exactly its solo tokens. "Solo" here
  is the sequence alone in an engine of the same configuration: the port's
  step always runs ``max_slots`` rows, so every product's M is a constant
  of the engine (the reference's solo engine has one slot and floors its
  rows at 2 for the same reason).
- ``llama_decode_model`` over a depth-2 LlamaModel (MHA and GQA): the
  engine's tokens for prompts decoded together equal the JAX
  ``llama_generate``'s for each prompt alone, and the port's own.
- K1's plain version with per-row key lengths, and the server's 0x5C
  stream against the JAX server's bytes.
Widths are multiples of 16 (hidden 16 and 128), so no SIMD tail or edge
block of the CPU's GEMMs splits a row differently in batch and alone.
"""
import socket
import struct
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import wire_spec as ref_spec
from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.inference.server import PredictorServer as JaxServer
from paddle_tpu.text import generation as jgen
from paddle_tpu.text import models as jmodels
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.inference import batching
from paddle_tpu_torch.inference.decode import DecodeEngine, DecodeModel, seq_bucket
from paddle_tpu_torch.inference.server import PredictorServer
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.text import generation as tgen
from paddle_tpu_torch.text import models as tmodels

from decode_worker import toy_decode_model

torch.set_num_threads(1)

HID, VOCAB = 16, 32
PROMPTS = [np.array([1, 2, 3], np.int32),
           np.array([5, 6, 7, 8, 9, 10, 11, 12, 13], np.int32),
           np.array([4], np.int32)]
LONG = np.arange(1, 12, dtype=np.int32)  # 11 tokens: prompt bucket 16, decodes past 16
TOL_LOGITS = 1e-5


# ---------------------------------------------------------------- the twin
def torch_toy_model(hidden=HID, vocab=VOCAB, seed=0, feature_spec=(), eos_token_id=None,
                    step_delay=0.0, fail_steps=0):
    """The torch twin of decode_worker.toy_decode_model: one masked
    attention layer over the KV cache, a tanh MLP and the logits, from the
    same ``RandomState(seed)`` draws. ``step_delay`` slows every step and
    ``fail_steps`` makes the first steps raise (the reference tests use
    chaos sites for both)."""
    rng = np.random.RandomState(seed)

    def mk(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32))

    params = [mk(vocab, hidden), mk(hidden, hidden), mk(hidden, hidden),
              mk(hidden, hidden), mk(hidden, hidden), mk(hidden, vocab)]
    failures = [fail_steps]

    def feat_bias(feats):
        bias = 0.0
        for f in feats:
            ff = f.to(torch.float32)
            bias = bias + ff.reshape(ff.shape[0], -1).mean(dim=-1)
        return bias * 0.1

    def attend(q_scores, mask, v):
        scores = torch.where(mask, q_scores, -torch.inf)
        prob = torch.where(mask, torch.softmax(scores, dim=-1), 0.0)
        return prob, v

    def prefill_fn(p, tokens, lengths, *feats):
        E, Wq, Wk, Wv, Wo, U = p
        emb = E[tokens]
        q, k, v = emb @ Wq, emb @ Wk, emb @ Wv
        pos = torch.arange(tokens.shape[1])
        mask = ((pos[None, :, None] >= pos[None, None, :])
                & (pos[None, None, :] < lengths[:, None, None]))
        prob, _ = attend(torch.einsum("bph,bsh->bps", q, k), mask, v)
        h = torch.tanh(torch.einsum("bps,bsh->bph", prob, v) @ Wo + emb)
        last = h[torch.arange(tokens.shape[0]), lengths.long() - 1]
        if feats:
            last = last + feat_bias(feats)[:, None]
        return (last @ U, k, v)

    def step_fn(p, tokens, positions, kv_k, kv_v, *feats):
        if step_delay:
            time.sleep(step_delay)
        if failures[0] > 0:
            failures[0] -= 1
            raise RuntimeError("boom")
        E, Wq, Wk, Wv, Wo, U = p
        emb = E[tokens]
        q, k, v = emb @ Wq, emb @ Wk, emb @ Wv
        rows, at = torch.arange(tokens.shape[0]), positions.long()
        kv_k[rows, at] = k
        kv_v[rows, at] = v
        mask = torch.arange(kv_k.shape[1])[None, :] <= at[:, None]
        prob, _ = attend(torch.einsum("bh,bsh->bs", q, kv_k), mask, kv_v)
        h = torch.tanh(torch.einsum("bs,bsh->bh", prob, kv_v) @ Wo + emb)
        if feats:
            h = h + feat_bias(feats)[:, None]
        return h @ U

    return DecodeModel(params, prefill_fn, step_fn,
                       kv_spec=(((hidden,), np.float32), ((hidden,), np.float32)),
                       vocab_size=vocab, feature_spec=feature_spec,
                       eos_token_id=eos_token_id, device="cpu")


def make_engine(model, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq_len", 32)
    kw.setdefault("name", "decode-test")
    return DecodeEngine(model, device="cpu", **kw)


def solo(model, prompt, n, features=(), **kw):
    """The sequence alone in a fresh engine of the same configuration."""
    with make_engine(model, **kw) as eng:
        return eng.generate(prompt, max_new_tokens=n, features=features, timeout=60)


def wait_tokens(req, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while len(req.tokens_so_far()) < n:
        assert time.monotonic() < deadline, f"only {len(req.tokens_so_far())}/{n} tokens"
        time.sleep(0.005)


@pytest.fixture(scope="module")
def model():
    return torch_toy_model()


@pytest.fixture(scope="module")
def jax_model():
    return toy_decode_model(hidden=HID, vocab=VOCAB, seed=0)


@pytest.fixture(scope="module")
def jax_engine(jax_model):
    eng = JaxEngine(jax_model, max_slots=4, max_seq_len=32, min_seq_bucket=8,
                    watchdog_interval=0, prefix=False, name="decode-jax")
    yield eng
    eng.close()


# ------------------------------------------------------- against the JAX toy
@pytest.mark.parametrize("n,lo,hi", [(1, 8, 64), (8, 8, 64), (9, 8, 64), (33, 8, 64),
                                     (64, 8, 64), (100, 8, 256), (3, 16, 32)])
def test_seq_bucket_matches_the_reference(n, lo, hi):
    from paddle_tpu.inference.decode import seq_bucket as ref_bucket

    assert seq_bucket(n, lo, hi) == ref_bucket(n, lo, hi)


def test_twin_logits_match_the_jax_toy(model, jax_model):
    tokens = np.array([[5, 6, 7, 8, 9, 0, 0, 0], [4, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    lengths = np.array([5, 1], np.int32)
    jp = jax_model.params
    want = [np.asarray(x) for x in jax_model.prefill_fn(jp, tokens, lengths)]
    got = model.prefill_fn(model.params, torch.from_numpy(tokens).long(),
                           torch.from_numpy(lengths))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL_LOGITS, rtol=0)
    # a step over two rows: the KV of the prefill, each row at its position
    kv = [np.zeros((2, 16, HID), np.float32) for _ in range(2)]
    for buf, src in zip(kv, want[1:]):
        buf[:, :8] = src
    positions = np.array([5, 1], np.int32)
    step_tok = np.array([3, 9], np.int32)
    jlogits, jk, jv = (np.asarray(x) for x in jax_model.step_fn(
        jp, jnp.asarray(step_tok), jnp.asarray(positions), *(jnp.asarray(b) for b in kv)))
    pools = [torch.from_numpy(b.copy()) for b in kv]
    logits = model.step_fn(model.params, torch.from_numpy(step_tok).long(),
                           torch.from_numpy(positions), *pools)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=TOL_LOGITS, rtol=0)
    # the port's step wrote the new entries into the pools in place
    np.testing.assert_allclose(pools[0][[0, 1], [5, 1]].numpy(), jk, atol=TOL_LOGITS)
    np.testing.assert_allclose(pools[1][[0, 1], [5, 1]].numpy(), jv, atol=TOL_LOGITS)


def test_engine_tokens_equal_the_jax_engine(model, jax_engine):
    cases = [(p, 10) for p in PROMPTS] + [(LONG, 18), (np.arange(20, 29, dtype=np.int32), 12)]
    with make_engine(model) as eng:
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in cases]
        got = [r.result(timeout=60) for r in reqs]
    jreqs = [jax_engine.submit(p, max_new_tokens=n) for p, n in cases]
    want = [r.result(timeout=120) for r in jreqs]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tolist() == w.tolist()


# ------------------------------------------------ the bitwise contract
def test_concurrent_batch_equals_solo(model):
    with make_engine(model) as eng:
        reqs = [eng.submit(p, max_new_tokens=10) for p in PROMPTS]
        outs = [r.result(timeout=60) for r in reqs]
    for p, o in zip(PROMPTS, outs):
        assert o.tolist() == solo(model, p, 10).tolist()


def test_join_and_leave_mid_sequence(model):
    slow = torch_toy_model(step_delay=0.01)
    with make_engine(slow) as eng:
        a = eng.submit(PROMPTS[0], max_new_tokens=14)
        wait_tokens(a, 4)  # a is mid-decode
        b = eng.submit(PROMPTS[2], max_new_tokens=3)  # joins...
        b_out = b.result(timeout=60)                  # ...and leaves
        a_out = a.result(timeout=60)
        assert len(a.tokens_so_far()) == 14
    assert a_out.tolist() == solo(model, PROMPTS[0], 14).tolist()
    assert b_out.tolist() == solo(model, PROMPTS[2], 3).tolist()


def test_bucket_crossing_in_batch(model):
    """Sequences whose prompts sit in other prompt buckets and whose steps
    climb past 8, 16 and 32 positions stay equal to solo."""
    with make_engine(model, max_seq_len=48) as eng:
        a = eng.submit(LONG, max_new_tokens=30)
        c = eng.submit(PROMPTS[2], max_new_tokens=30)
        outs = [a.result(timeout=60), c.result(timeout=60)]
    assert outs[0].tolist() == solo(model, LONG, 30, max_seq_len=48).tolist()
    assert outs[1].tolist() == solo(model, PROMPTS[2], 30, max_seq_len=48).tolist()


@pytest.mark.parametrize("dt", ["float32", "int32", "int64", "bool"])
def test_feature_dtypes_bitwise(dt):
    spec = (((3,), np.dtype(dt)),)
    m = torch_toy_model(seed=1, feature_spec=spec)
    if dt == "bool":
        feats, feats2 = [np.array([True, False, True])], [np.array([False, False, True])]
    else:
        feats, feats2 = [np.array([3, 1, 2], np.dtype(dt))], [np.array([7, 0, 5], np.dtype(dt))]
    with make_engine(m) as eng:
        r1 = eng.submit(PROMPTS[0], max_new_tokens=8, features=feats)
        r2 = eng.submit(PROMPTS[2], max_new_tokens=8, features=feats2)
        o1, o2 = r1.result(timeout=60), r2.result(timeout=60)
    assert o1.tolist() == solo(m, PROMPTS[0], 8, features=feats).tolist()
    assert o2.tolist() == solo(m, PROMPTS[2], 8, features=feats2).tolist()


def test_features_steer_decoding():
    m = torch_toy_model(seed=1, feature_spec=(((3,), np.float32),))
    a = solo(m, PROMPTS[0], 10, features=[np.zeros(3, np.float32)])
    b = solo(m, PROMPTS[0], 10, features=[np.full(3, 8.0, np.float32)])
    assert a.tolist() != b.tolist()


def test_i64_prompt_echoes_dtype(model):
    with make_engine(model) as eng:
        out = eng.generate(PROMPTS[0].astype(np.int64), max_new_tokens=5, timeout=60)
    assert out.dtype == np.int64
    assert out.tolist() == solo(model, PROMPTS[0], 5).tolist()


# -------------------------------------------------------------- lifecycle
def test_eos_stops_early(model):
    ref = solo(model, PROMPTS[0], 10).tolist()
    eos = ref[2]  # the first occurrence of this id decides
    stop_at = ref.index(eos) + 1
    assert stop_at < len(ref)
    m = torch_toy_model(eos_token_id=eos)
    with make_engine(m) as eng:
        req = eng.submit(PROMPTS[0], max_new_tokens=10)
        out = req.result(timeout=60)
    assert req.finish_reason == "eos"
    assert out.tolist() == ref[:stop_at]


def test_max_seq_len_retires(model):
    with make_engine(model, max_seq_len=16, max_prompt_len=8) as eng:
        req = eng.submit(PROMPTS[0], max_new_tokens=100)
        out = req.result(timeout=60)
        assert eng.stats()["retired"]["max_seq_len"] == 1
    assert req.finish_reason == "max_seq_len"
    # prompt 3 + first token at position 3 ... the pool full at 16 entries
    assert out.size == 16 - PROMPTS[0].size + 1


def test_queue_full_sheds():
    with make_engine(torch_toy_model(step_delay=0.3), max_queue=1) as eng:
        eng.submit(PROMPTS[0], max_new_tokens=30)
        time.sleep(0.05)  # it joined; the queue is empty
        eng.submit(PROMPTS[2], max_new_tokens=2)  # queued behind the slow step
        with pytest.raises(batching.EngineOverloaded):
            eng.submit(PROMPTS[2], max_new_tokens=2)
        assert eng.stats()["shed_count"] == 1


def test_validation(model):
    with make_engine(model, max_prompt_len=8) as eng:
        bad = [dict(prompt=np.zeros((2, 3), np.int32)),            # 2 rows
               dict(prompt=np.array([0.5], np.float32)),            # float prompt
               dict(prompt=np.arange(9, dtype=np.int32)),           # > max_prompt_len
               dict(prompt=np.array([VOCAB], np.int32)),            # outside the vocab
               dict(prompt=PROMPTS[0], max_new_tokens=0),
               dict(prompt=PROMPTS[0], features=[np.zeros(3)]),     # no feature spec
               dict(prompt=PROMPTS[0], snapshot_every=4)]           # not ported
        for kw in bad:
            with pytest.raises(ValueError):
                eng.submit(**kw)
        # the speculative opt-in is accepted and changes nothing
        out = eng.generate(PROMPTS[0], max_new_tokens=4, speculative=True, timeout=60)
    assert out.tolist() == solo(model, PROMPTS[0], 4).tolist()


@pytest.mark.parametrize("option", [dict(quant="w8"), dict(mesh="tp2"), dict(spec_k=4),
                                    dict(prefix=True), dict(watchdog_interval=0.5),
                                    dict(store="somewhere")])
def test_unported_engine_options_raise(model, option):
    with pytest.raises(NotImplementedError):
        make_engine(model, **option)


def test_engine_device_and_off_values(model):
    # the reference's "off" values of unported options are accepted
    with make_engine(model, prefix=False, watchdog_interval=0) as eng:
        assert eng.health()["ok"] and eng.device == torch.device("cpu")
    with pytest.raises(TypeError):
        make_engine(model, bogus=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            DecodeEngine(model, max_slots=4, max_seq_len=32)  # device="cuda" by default


def test_decode_model_defaults_to_the_card(model):
    """Like every entry point of the port, a DecodeModel runs on the card
    unless the caller asks for the CPU: with no card it raises."""
    args = (model.params, model.prefill_fn, model.step_fn, model.kv_spec, VOCAB)
    if torch.cuda.is_available():
        assert DecodeModel(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            DecodeModel(*args)
    assert DecodeModel(*args, device="cpu").device == torch.device("cpu")


def test_programs_built_once_per_key(model):
    """The reference's program map: one build per (phase, rows, seq) key
    used, then warmup's whole ladder; a CPU engine runs them eagerly."""
    with make_engine(model) as eng:
        for p in (PROMPTS[0], LONG, PROMPTS[2]):
            eng.generate(p, max_new_tokens=4, timeout=60)
        st = eng.stats()
        one = {"compiles": 1, "store_loads": 0}
        assert st["programs"] == {"prefill1x8": one, "prefill1x16": one, "step4x32": one}
        assert (st["cuda_graphs"], st["graph_replays"], st["graph_pool_bytes"]) == (False, 0, 0)
        assert eng.warmup() == [8, 16, 32]
        assert eng.stats()["programs"] == {"prefill1x8": one, "prefill1x16": one,
                                           "prefill1x32": one, "step4x32": one}


def test_program_builds_once_under_concurrent_callers(model, monkeypatch):
    with make_engine(model) as eng:
        real, built = eng._graphs.build, []

        def slow_build(key):
            built.append(key)
            time.sleep(0.05)
            return real(key)

        monkeypatch.setattr(eng._graphs, "build", slow_build)
        key = ("prefill", 1, 16)
        runs = []
        threads = [threading.Thread(target=lambda: runs.append(eng._program(key)))
                   for _ in range(8)]
        threads.append(threading.Thread(target=eng.warmup))
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(interval)
        assert built.count(key) == 1 and len(runs) == 8 and len({id(r) for r in runs}) == 1
        assert all(v["compiles"] == 1 for v in eng.stats()["programs"].values())


def test_close_fails_inflight_retryable():
    eng = make_engine(torch_toy_model(step_delay=0.2))
    req = eng.submit(PROMPTS[0], max_new_tokens=50)
    wait_tokens(req, 1)
    eng.close()
    with pytest.raises(batching.EngineClosed):
        req.result(timeout=10)
    with pytest.raises(batching.EngineClosed):
        eng.submit(PROMPTS[0])
    assert eng.health()["free_slots"] == eng.max_slots


# -------------------------------------------------------------- robustness
def test_step_failure_retryable_and_slots_freed(model):
    with make_engine(torch_toy_model(fail_steps=1)) as eng:
        req = eng.submit(PROMPTS[0], max_new_tokens=6)
        with pytest.raises(batching.RetryableError):
            req.result(timeout=30)
        h = eng.health()
        assert h["active"] == 0 and h["free_slots"] == eng.max_slots
        assert eng.stats()["retired"]["error"] == 1
        # the engine still serves
        out = eng.generate(PROMPTS[0], max_new_tokens=6, timeout=60)
    assert out.tolist() == solo(model, PROMPTS[0], 6).tolist()


def test_cancel_mid_stream_purges_slot():
    with make_engine(torch_toy_model(step_delay=0.05)) as eng:
        req = eng.submit(PROMPTS[0], max_new_tokens=500)
        wait_tokens(req, 2)
        eng.cancel(req)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            h = eng.health()
            if h["active"] == 0 and h["free_slots"] == eng.max_slots:
                break
            time.sleep(0.02)
        h = eng.health()
        assert h["active"] == 0 and h["free_slots"] == eng.max_slots
        assert req.finish_reason == "cancelled"
        assert eng.stats()["retired"]["cancelled"] == 1
        assert len(req.tokens_so_far()) < 50


def test_per_token_deadline_fails_retryable():
    with make_engine(torch_toy_model(step_delay=0.3)) as eng:
        req = eng.submit(PROMPTS[0], max_new_tokens=50, token_budget_s=0.15)
        with pytest.raises(batching.DeadlineExceeded):
            req.result(timeout=30)
        assert eng.health()["free_slots"] == eng.max_slots
        assert eng.stats()["deadline_late"] >= 1


def test_pending_budget_expired_before_join():
    with make_engine(torch_toy_model(step_delay=0.2), max_slots=1) as eng:
        eng.submit(PROMPTS[0], max_new_tokens=30)
        time.sleep(0.05)
        late = eng.submit(PROMPTS[2], max_new_tokens=2, token_budget_s=0.05)
        with pytest.raises(batching.DeadlineExceeded):
            late.result(timeout=30)
        assert eng.stats()["deadline_expired"] >= 1


# ------------------------------------------------------------------ Llama
LLAMA = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)
LLAMA_PROMPTS = [np.random.RandomState(s).randint(0, 128, (n,)).astype(np.int32)
                 for s, n in ((1, 3), (2, 11), (3, 1), (4, 17))]


@pytest.fixture(scope="module", params=[None, 1], ids=["mha", "gqa1"])
def llama(request):
    paddle.seed(5)
    jm = jmodels.LlamaModel(**LLAMA, num_kv_heads=request.param)
    tm = tmodels.LlamaModel(**LLAMA, num_kv_heads=request.param, device="cpu")
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    return jm, tm.eval()


def test_llama_engine_matches_jax_llama_generate(llama):
    jm, tm = llama
    n = 6
    before = tfa.launches
    with DecodeEngine(tgen.llama_decode_model(tm, 4, 32), device="cpu",
                      max_prompt_len=24) as eng:
        reqs = [eng.submit(p, max_new_tokens=n) for p in LLAMA_PROMPTS]
        got = [r.result(timeout=60) for r in reqs]
        st = eng.stats()
    assert tfa.launches == before and st["k1_launches"] == 0  # CPU: the plain version
    assert st["prefills"] == len(LLAMA_PROMPTS) and st["active"] == 0
    for p, g in zip(LLAMA_PROMPTS, got):
        want = jgen.llama_generate(jm, p, max_new_tokens=n)[0, p.size:]
        assert g.tolist() == want.tolist()
        assert g.tolist() == tgen.llama_generate(tm, p, max_new_tokens=n)[0, p.size:].tolist()


def test_llama_decode_model_shape_contract(llama):
    _, tm = llama
    dm = tgen.llama_decode_model(tm, 4, 32)
    attn = tm.layers[0].self_attn
    assert dm.kv_seq_axis == 2 and len(dm.kv_spec) == 2 * LLAMA["num_layers"]
    assert dm.kv_spec[0] == ((attn.num_kv_heads, attn.head_dim), torch.float32)
    with pytest.raises(ValueError, match="built for"):
        DecodeEngine(dm, device="cpu", max_slots=8)
    with DecodeEngine(dm, device="cpu") as eng:
        assert (eng.max_slots, eng.max_seq_len) == (4, 32)
        assert eng._slots.pools[0].shape == (4, attn.num_kv_heads, 32, attn.head_dim)
        assert eng.warmup() == [8, 16, 32]


def test_rope_tables_take_per_row_positions():
    pos = torch.tensor([[0, 5, 9], [3, 4, 200]])
    cos, sin = tmodels._rope_tables(64, pos, torch.float32)
    assert cos.shape == (2, 1, 3, 32)
    for b in range(2):
        c1, s1 = tmodels._rope_tables(64, pos[b], torch.float32)
        assert torch.equal(cos[b:b + 1], c1) and torch.equal(sin[b:b + 1], s1)


# ------------------------------------------------ K1's plain version, k_len
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq", [1, 5])
def test_mha_reference_with_lengths_row_by_row(causal, sq):
    g = torch.Generator().manual_seed(0)
    b, h, sk, d = 4, 3, 40, 64
    q = torch.randn(b * h, sq, d, generator=g)
    k, v = (torch.randn(b * h, sk, d, generator=g) for _ in range(2))
    k_len = torch.tensor([5, 12, 33, sk], dtype=torch.int32)
    o, lse = tfa.mha_reference(q, k, v, causal=causal, k_len=k_len, heads=h)
    for i, n in enumerate(k_len.tolist()):
        rows = slice(i * h, (i + 1) * h)
        # each row against its K/V cut to its length. The causal mask is
        # bottom-right over the operand (row r sees keys <= r + sk - sq): it
        # hides nothing below lengths <= sk - sq + 1, and at n == sk the cut
        # is the whole operand
        ro, rlse = tfa.mha_reference(q[rows], k[rows, :n], v[rows, :n],
                                     causal=causal and n == sk)
        torch.testing.assert_close(o[rows], ro, atol=1e-6, rtol=0)
        torch.testing.assert_close(lse[rows], rlse, atol=1e-6, rtol=0)
    # the operand's width beyond the lengths never enters, NaN rows included
    if not causal:
        pad = torch.full((b * h, 24, d), float("nan"))
        o2, lse2 = tfa.mha_reference(q, torch.cat([k, pad], 1), torch.cat([v, pad], 1),
                                     k_len=k_len, heads=h)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_mha_passes_k_len_and_refuses_dropout():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 4, n, 64, generator=g) for n in (1, 20, 20))
    k_len = torch.tensor([7, 20], dtype=torch.int32)
    out = tfa.mha(q, k, v, causal=True, k_len=k_len)
    want, _ = tfa.mha_reference(q.reshape(8, 1, 64), k.reshape(8, 20, 64),
                                v.reshape(8, 20, 64), causal=True, k_len=k_len, heads=4)
    assert torch.equal(out, want.reshape(2, 4, 1, 64))
    with pytest.raises(ValueError, match="dropout"):
        tfa._fwd(q[0], k[0], v[0], 0, 0.125, False, 0.1, k_len=k_len[:1], heads=4)
    with pytest.raises(ValueError, match="cover"):
        tfa.mha_reference(q[0], k[0], v[0], k_len=k_len, heads=4)


# -------------------------------------------------------------------- wire
def _recv(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("closed")
        buf += chunk
    return buf


def _frame(s):
    (blen,) = struct.unpack("<I", _recv(s, 4))
    body = _recv(s, blen)
    return body[0], body[1:], struct.pack("<I", blen) + body


def _decode_frame(prompt, n, **opts):
    return ref_spec.build_request(
        ref_spec.CMD_INFER, ref_spec.encode_arrays([prompt]) + ref_spec.encode_decode_opts(n, **opts))


def _stream(port, prompt, n, **opts):
    """All frames of one decode request: [(status, payload, raw bytes)]."""
    frames = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(_decode_frame(prompt, n, **opts))
        while True:
            frames.append(_frame(s))
            if frames[-1][0] != ref_spec.STATUS_STREAM:
                return frames


@pytest.fixture(scope="module")
def server(model):
    eng = make_engine(torch_toy_model(step_delay=0.002))
    srv = PredictorServer(lambda *a: list(a), decode_engine=eng, own_decode_engine=True)
    yield srv, eng
    srv.stop()


@pytest.mark.parametrize("speculative", [False, True])
def test_stream_frames_concatenate_to_generate(server, model, speculative):
    srv, eng = server
    prompt = PROMPTS[1].astype(np.int64)
    frames = _stream(srv.port, prompt, 9, speculative=speculative)
    assert all(f[0] == ref_spec.STATUS_STREAM for f in frames[:-1])
    assert frames[-1][0] == ref_spec.STATUS_OK
    chunks = [ref_spec.decode_arrays(f[1])[0] for f in frames]
    assert all(c.dtype == np.int64 for c in chunks)
    assert np.concatenate(chunks).tolist() == solo(model, prompt, 9).tolist()


def test_oneshot_reply_bytes_equal_the_jax_server(server, jax_engine):
    srv, _ = server
    jsrv = JaxServer(lambda *a: list(a), decode_engine=jax_engine)
    try:
        for prompt, n in ((PROMPTS[0], 7), (LONG.astype(np.int64), 12)):
            got = _stream(srv.port, prompt, n, oneshot=True)
            want = _stream(jsrv.port, prompt, n, oneshot=True)
            assert len(got) == len(want) == 1 and got[0][0] == ref_spec.STATUS_OK
            assert got[0][2] == want[0][2]
    finally:
        jsrv.stop()


@pytest.mark.parametrize("opts", [dict(handoff=True), dict(snapshot_every=4)])
def test_unported_decode_bits_answer_status_1(server, opts):
    srv, _ = server
    frames = _stream(srv.port, PROMPTS[0], 4, **opts)
    assert [f[0] for f in frames] == [ref_spec.STATUS_ERROR]


def test_bad_decode_requests_answer_status_1_or_2(server):
    srv, eng = server
    assert _stream(srv.port, np.array([0.5], np.float32), 4)[0][0] == ref_spec.STATUS_ERROR
    with socket.create_connection(("127.0.0.1", srv.port), timeout=60) as s:
        s.sendall(ref_spec.build_request(
            ref_spec.CMD_INFER, ref_spec.encode_arrays([PROMPTS[0]])
            + ref_spec.encode_deadline(0.0) + ref_spec.encode_decode_opts(4)))
        status, _, _ = _frame(s)
        while status == ref_spec.STATUS_STREAM:
            status, _, _ = _frame(s)
    assert status == ref_spec.STATUS_RETRYABLE  # a spent per-token budget


def test_client_closing_mid_stream_frees_its_slot():
    eng = make_engine(torch_toy_model(step_delay=0.02))
    srv = PredictorServer(lambda *a: list(a), decode_engine=eng, own_decode_engine=True)
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        s.sendall(_decode_frame(PROMPTS[0], 28))
        assert _frame(s)[0] == ref_spec.STATUS_STREAM
        s.close()
        deadline = time.monotonic() + 10
        while eng.stats()["retired"]["cancelled"] < 1:
            assert time.monotonic() < deadline, eng.stats()
            time.sleep(0.01)
        h = eng.health()
        assert h["active"] == 0 and h["free_slots"] == eng.max_slots
    finally:
        srv.stop()


def test_health_and_stats_carry_the_engine(server):
    import json

    srv, eng = server
    _stream(srv.port, PROMPTS[0], 3)
    out = {}
    for cmd in (ref_spec.CMD_HEALTH, ref_spec.CMD_STATS):
        with socket.create_connection(("127.0.0.1", srv.port), timeout=60) as s:
            s.sendall(ref_spec.build_request(cmd))
            status, body, _ = _frame(s)
        assert status == ref_spec.STATUS_OK
        out[cmd] = json.loads(body)
    assert out[ref_spec.CMD_HEALTH]["ok"] and out[ref_spec.CMD_HEALTH]["decode"]["ok"]
    st = out[ref_spec.CMD_STATS]["decode"]
    assert st["max_slots"] == 4 and st["tokens"] >= 3 and st["steps"] >= 3
    assert {"active", "queue_depth", "prefills", "retired", "shed_count",
            "deadline_expired", "k1_launches"} <= set(st)
