"""Speculative decoding in the port's decode engine
(paddle_tpu_torch/inference/decode.py) and the per-program circuit
breakers its draft path degrades through (inference/batching.py), on the
CPU.

- The anchored toy pair of the reference's tests (tests/test_prefix_spec.py
  ``spec_model``: a hidden-16 target and a hidden-8 draft sharing the
  ``RandomState(777)`` token-transition anchor), as torch twins
  (tests/test_torch_decode.py ``torch_toy_model``): speculative tokens
  equal plain tokens and the JAX engine's (``spec_k=4``), and a sequence
  decoded alone takes as many bursts and accepts as many proposals as
  there.
- The reference's ``TestSpeculative`` and wire cases, mirrored: off
  without a draft or with k < 2, goodput counted once, bit 61 over the
  wire, solo = batch with sharing and speculation.
- A depth-2 Llama target with a 1-layer layer-skip draft gives the JAX
  package's ``llama_generate`` tokens.
- The breakers: the port's ``_Breaker`` follows the reference's through
  the same calls; a draft, draft fill or verify that raises leaves the
  tokens unchanged and trips its key's breaker after 3 failures; a
  failing step or fill sheds with ``BucketQuarantined`` once open.
- Draft padding: no draft step changes a draft row below any sequence's
  ``draft_pos``, so a caught-up sequence keeps its draft rows while a
  neighbour catches up.
"""
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import batching as ref_batching
from paddle_tpu.inference import wire_spec as ref_spec
from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.text import generation as jgen
from paddle_tpu.text import models as jmodels
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.inference import batching
from paddle_tpu_torch.inference.decode import DecodeEngine
from paddle_tpu_torch.inference.server import PredictorServer
from paddle_tpu_torch.text import generation as tgen
from paddle_tpu_torch.text import models as tmodels

from decode_worker import toy_decode_model
from test_torch_decode import HID, VOCAB, make_engine, torch_toy_model

torch.set_num_threads(1)

K = 4
PREFIX = np.arange(1, 17, dtype=np.int32)  # a two-page shared prefix
SUFFIXES = [np.array([21, 22], np.int32), np.array([23, 24, 25], np.int32),
            np.array([26], np.int32)]
CLOSED = {"state": "closed", "consecutive_failures": 0, "trips": 0, "shed": 0}


def prompt_with(suffix):
    return np.concatenate([PREFIX, np.asarray(suffix, np.int32)])


def spec_model(anchor=4.0, **draft_kw):
    """The reference's ``spec_model`` as torch twins: the draft (hidden 8,
    seed 1) and the target (hidden 16, seed 0) share the anchor."""
    draft = torch_toy_model(hidden=8, seed=1, anchor=anchor, **draft_kw)
    return torch_toy_model(hidden=HID, seed=0, anchor=anchor, draft=draft)


@pytest.fixture(scope="module")
def jax_spec_engine():
    draft = toy_decode_model(hidden=8, vocab=VOCAB, seed=1, anchor=4.0)
    target = toy_decode_model(hidden=HID, vocab=VOCAB, seed=0, anchor=4.0, draft=draft)
    eng = JaxEngine(target, max_slots=4, max_seq_len=32, min_seq_bucket=8, watchdog_interval=0,
                    spec_k=K, name="spec-jax")
    yield eng
    eng.close()


# ------------------------------------------------------ against the JAX engine
def test_spec_tokens_equal_plain_and_the_jax_engine(jax_spec_engine):
    """Speculative greedy = plain greedy on the same engine, token for
    token, and both = the JAX engine's speculative tokens."""
    with make_engine(spec_model(), spec_k=K) as eng:
        assert eng.spec_enabled
        for i, sfx in enumerate(SUFFIXES + [np.array([3, 9, 27, 5, 1], np.int32)]):
            p = prompt_with(sfx)
            spec = eng.generate(p, max_new_tokens=8 + i, speculative=True, timeout=60)
            plain = eng.generate(p, max_new_tokens=8 + i, timeout=60)
            want = jax_spec_engine.generate(p, max_new_tokens=8 + i, speculative=True,
                                            timeout=120)
            assert spec.dtype == want.dtype
            assert spec.tolist() == plain.tolist() == want.tolist()
        st = eng.stats()["spec"]
    assert st["iterations"] >= 1 and st["verify_steps"] >= 1
    assert st["accepted"] >= 1, "anchored draft never accepted"


@pytest.mark.parametrize("prompt,n", [(prompt_with(SUFFIXES[0]), 10),
                                      (prompt_with(SUFFIXES[1]), 13),
                                      (np.array([9, 8, 7], np.int32), 9)])
def test_spec_counts_equal_the_jax_engine(jax_spec_engine, prompt, n):
    """Decoded alone, a sequence takes as many bursts and accepts as many
    proposals as on the JAX engine: the port's draft proposes the
    reference draft's tokens and the accept loop follows the reference."""
    before = jax_spec_engine.stats()["spec"]
    want = jax_spec_engine.generate(prompt, max_new_tokens=n, speculative=True, timeout=120)
    after = jax_spec_engine.stats()["spec"]
    with make_engine(spec_model(), spec_k=K) as eng:
        got = eng.generate(prompt, max_new_tokens=n, speculative=True, timeout=60)
        st = eng.stats()
    assert got.tolist() == want.tolist()
    for key in ("iterations", "accepted", "verify_steps"):
        assert st["spec"][key] == after[key] - before[key], key
    # the burst's draft state: one fill replay a prompt chunk below P-1
    assert st["spec"]["draft_prefills"] == -(-(prompt.size - 1) // 8)
    assert st["tokens"] == n


# ------------------------------------------- the reference's TestSpeculative
@pytest.mark.parametrize("draft,k", [(False, K), (True, 1), (True, None)],
                         ids=["no-draft", "k1", "k-default"])
def test_spec_disabled_without_draft_or_k(draft, k):
    """No draft or k < 2: speculation is quietly off; an opted request
    decodes plainly and the engine builds no speculative program."""
    model = spec_model() if draft else torch_toy_model(anchor=4.0)
    p = prompt_with(SUFFIXES[0])
    with make_engine(model, spec_k=k) as eng:
        assert not eng.spec_enabled
        out = eng.generate(p, max_new_tokens=6, speculative=True, timeout=60)
        st = eng.stats()
    assert st["spec"] == {"enabled": False, "k": 0, "iterations": 0, "accepted": 0,
                          "rejected": 0, "verify_steps": 0, "draft_steps": 0,
                          "draft_prefills": 0}
    assert set(st["programs"]) == {"fill1x8", "fill1x16", "fill1x24", "step4x32"}
    with make_engine(torch_toy_model(anchor=4.0)) as eng:
        assert out.tolist() == eng.generate(p, max_new_tokens=6, timeout=60).tolist()


def test_goodput_counts_accepted_tokens_once():
    with make_engine(spec_model(), spec_k=K) as eng:
        before = eng.stats()["tokens"]
        out = eng.generate(prompt_with(SUFFIXES[0]), max_new_tokens=10, speculative=True,
                           timeout=60)
        st = eng.stats()
    assert st["tokens"] - before == out.size == 10
    assert st["spec"]["accepted"] >= 1


def test_draft_checks_vocab_and_features():
    with pytest.raises(ValueError, match="vocab"):
        make_engine(torch_toy_model(draft=torch_toy_model(vocab=VOCAB * 2)), spec_k=K)
    spec = (((3,), np.dtype(np.float32)),)
    with pytest.raises(ValueError, match="feature_spec"):
        make_engine(torch_toy_model(feature_spec=spec, draft=torch_toy_model()), spec_k=K)
    # the draft's kv_spec and width may differ freely
    with make_engine(spec_model(), spec_k=K) as eng:
        assert eng._draft_slots.pools[0].shape == (4, 32, 8)
        assert eng.stats()["draft_kv_pool_bytes"] == 2 * 4 * 32 * 8 * 4


def test_spec_with_features_and_snapshots():
    """Features reach the draft and the verify alike; a cadence's
    snapshots follow the reference's burst rule (one after a burst whose
    tokens crossed a multiple), and a resume with the opt-in (its draft
    empty, caught up from the prompt) continues the unbroken stream."""
    spec = (((3,), np.dtype(np.float32)),)
    draft = torch_toy_model(hidden=8, seed=1, anchor=4.0, feature_spec=spec)
    target = torch_toy_model(seed=0, anchor=4.0, feature_spec=spec, draft=draft)
    feats = [np.array([3.0, 1.0, 2.0], np.float32)]
    p = prompt_with(SUFFIXES[1])
    with make_engine(target, spec_k=K) as eng:
        plain = eng.generate(p, max_new_tokens=14, features=feats, timeout=60)
        req = eng.submit(p, max_new_tokens=14, features=feats, speculative=True,
                         snapshot_every=5)
        assert req.result(timeout=60).tolist() == plain.tolist()
        n_gen = req.take_snapshot()[1]
        assert 5 <= n_gen < 14
        resumed = eng.resume(req.latest_snapshot(), speculative=True)
        assert resumed.result(timeout=60).tolist() == plain.tolist()
        assert eng.stats()["spec"]["iterations"] >= 2


# --------------------------------------------------------------------- wire
def _recv(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("closed")
        buf += chunk
    return buf


def raw_stream(port, prompt, n, speculative=False):
    """-> (terminal status, tokens) of one 0x5C decode stream."""
    frame = ref_spec.build_request(ref_spec.CMD_INFER, ref_spec.encode_arrays([prompt])
                                   + ref_spec.encode_decode_opts(n, speculative=speculative))
    chunks = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(frame)
        while True:
            (blen,) = struct.unpack("<I", _recv(s, 4))
            body = _recv(s, blen)
            if len(body) > 1 and body[0] in (ref_spec.STATUS_OK, ref_spec.STATUS_STREAM):
                chunks.append(ref_spec.decode_arrays(body[1:])[0])
            if body[0] != ref_spec.STATUS_STREAM:
                toks = np.concatenate(chunks) if chunks else np.zeros(0, prompt.dtype)
                return body[0], toks


def make_server(model, **kw):
    engine = make_engine(model, **kw)
    return PredictorServer(lambda *a: list(a), decode_engine=engine,
                           own_decode_engine=True), engine


def test_spec_opt_in_bitwise_over_wire():
    server, engine = make_server(spec_model(), spec_k=K)
    try:
        p = prompt_with(SUFFIXES[0])
        st_s, spec = raw_stream(server.port, p, 8, speculative=True)
        st_p, plain = raw_stream(server.port, p, 8)
        assert (st_s, st_p) == (ref_spec.STATUS_OK, ref_spec.STATUS_OK)
        assert spec.tolist() == plain.tolist() and spec.size == 8
        assert engine.stats()["spec"]["iterations"] >= 1
    finally:
        server.stop()


def test_solo_vs_batch_contract_with_sharing_and_spec():
    """The determinism contract over the wire with the whole ladder live:
    staggered joins and leaves, shared prefixes, opted and non-opted
    streams, int32/int64 prompts: every stream equals its solo decode."""
    target = spec_model()
    server, engine = make_server(target, spec_k=K)
    jobs = [(prompt_with(SUFFIXES[0]), 4, False, np.int32),
            (prompt_with(SUFFIXES[1]), 12, True, np.int32),
            (prompt_with(SUFFIXES[2]), 9, True, np.int64),
            (np.array([9, 8, 7], np.int32), 6, False, np.int32),
            (prompt_with(SUFFIXES[0]), 11, True, np.int32)]
    results = [None] * len(jobs)

    def run(i, prompt, n, spec, dt):
        time.sleep(0.02 * i)  # staggered joins
        results[i] = raw_stream(server.port, prompt.astype(dt), n, speculative=spec)

    try:
        threads = [threading.Thread(target=run, args=(i, *j)) for i, j in enumerate(jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert engine.stats()["prefix"]["hits"] >= 1
    finally:
        server.stop()
    for (prompt, n, _, dt), res in zip(jobs, results):
        assert res is not None, "stream never finished"
        status, toks = res
        assert status == ref_spec.STATUS_OK and toks.dtype == dt
        with make_engine(target, spec_k=K) as eng:
            assert toks.tolist() == eng.generate(prompt, max_new_tokens=n, timeout=60).tolist()


# -------------------------------------------------------------------- Llama
LLAMA = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)


def test_llama_layer_skip_draft_matches_jax_llama_generate():
    """A depth-2 Llama target with a 1-layer layer-skip draft (its first
    layer, embedding, norm and head shared): the opted streams decoded
    together give the JAX ``llama_generate``'s greedy tokens."""
    paddle.seed(5)
    jm = jmodels.LlamaModel(**LLAMA)
    tm = tmodels.LlamaModel(**LLAMA, device="cpu")
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    tm.eval()
    skip = tgen.llama_layer_skip(tm, 1)
    assert len(skip.layers) == 1 and skip.layers[0] is tm.layers[0]
    assert skip.lm_head.weight is tm.lm_head.weight
    draft = tgen.llama_decode_model(skip, 4, 32)
    prompts = [np.random.RandomState(s).randint(0, 128, (n,)).astype(np.int32)
               for s, n in ((1, 3), (2, 11), (3, 1), (4, 17))]
    n = 8
    with DecodeEngine(tgen.llama_decode_model(tm, 4, 32, draft=draft), device="cpu",
                      max_prompt_len=24, spec_k=K) as eng:
        reqs = [eng.submit(p, max_new_tokens=n, speculative=True) for p in prompts]
        got = [r.result(timeout=60) for r in reqs]
        st = eng.stats()
    assert st["spec"]["iterations"] >= 1 and st["spec"]["draft_steps"] >= 1
    assert st["k1_launches"] == 0  # the CPU runs K1's plain version
    for p, g in zip(prompts, got):
        assert g.tolist() == jgen.llama_generate(jm, p, max_new_tokens=n)[0, p.size:].tolist()


def test_llama_self_draft_accepts_every_proposal():
    """A self-draft (the target's own functions over its own weights, its
    own pools and programs) proposes the target's greedy token every
    time: its rows are made by the target's programs from the same
    tokens, the row at P-1 by its own finishing step. So no burst ends in
    a rejection, and the tokens are plain greedy's."""
    paddle.seed(6)
    jm = jmodels.LlamaModel(**LLAMA)
    tm = tmodels.LlamaModel(**LLAMA, device="cpu")
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    tm.eval()
    dm = tgen.llama_decode_model(tm, 4, 48, draft=tgen.llama_decode_model(tm, 4, 48))
    prompts = [np.random.RandomState(s).randint(0, 128, (n,)).astype(np.int32)
               for s, n in ((5, 2), (6, 9), (7, 20))]
    with DecodeEngine(dm, device="cpu", max_prompt_len=24, spec_k=K) as eng:
        got = [r.result(timeout=60) for r in [eng.submit(p, max_new_tokens=14, speculative=True)
                                              for p in prompts]]
        plain = [eng.generate(p, max_new_tokens=14, timeout=60) for p in prompts]
        st = eng.stats()["spec"]
    assert [g.tolist() for g in got] == [w.tolist() for w in plain]
    assert st["rejected"] == 0 and st["accepted"] >= st["iterations"] >= len(prompts)


# ----------------------------------------------------------------- breakers
_SCRIPTS = [
    # (call, now): allow, success, failure at a clock the test drives
    [("fail", 0.0), ("fail", 0.1), ("allow", 0.2), ("fail", 0.3), ("allow", 0.4),
     ("allow", 5.2), ("allow", 5.3), ("fail", 5.4), ("allow", 9.0), ("allow", 10.5),
     ("ok", 10.6), ("allow", 10.7), ("fail", 11.0)],
    [("allow", 0.0), ("ok", 0.0), ("fail", 1.0), ("ok", 1.1), ("fail", 1.2), ("fail", 1.3),
     ("fail", 1.4), ("fail", 1.5), ("allow", 6.6), ("ok", 6.7), ("allow", 6.8)],
]


@pytest.mark.parametrize("threshold", [3, 1, 0])
@pytest.mark.parametrize("script", range(len(_SCRIPTS)))
def test_breaker_follows_the_reference(threshold, script):
    ours, ref = batching._Breaker(threshold, 5.0), ref_batching._Breaker(threshold, 5.0)
    for call, now in _SCRIPTS[script]:
        if call == "allow":
            assert ours.allow(now) == ref.allow(now)
        elif call == "ok":
            ours.record_success()
            ref.record_success()
        else:
            ours.record_failure(now)
            ref.record_failure(now)
        assert ours.as_dict() == ref.as_dict()
    assert issubclass(batching.BucketQuarantined, batching.RetryableError)
    assert batching.BucketQuarantined.status_code == ref_spec.STATUS_RETRYABLE


def _break_builds(monkeypatch, eng, phase):
    """Make every build of ``phase``'s programs return a function that
    raises."""
    graphs = eng._graphs_of((phase, 0, 0))
    real = graphs.build

    def build(key):
        if key[0] != phase:
            return real(key)

        def boom():
            raise RuntimeError(f"{phase} down")
        return boom

    monkeypatch.setattr(graphs, "build", build)


@pytest.mark.parametrize("broken", ["draft_step", "draft_fill", "verify"])
def test_draft_trouble_degrades_to_plain_steps(monkeypatch, broken):
    """A draft step (a draft whose step_fn raises), draft fill or verify
    that fails never fails a request: the iteration is a plain step, the
    tokens are plain greedy's, and the key's breaker opens after 3
    consecutive failures, after which the path is skipped unprobed."""
    model = spec_model(fail_steps=10 ** 6) if broken == "draft_step" else spec_model()
    p = prompt_with(SUFFIXES[1])
    with make_engine(torch_toy_model(seed=0, anchor=4.0)) as eng:
        want = eng.generate(p, max_new_tokens=12, timeout=60)
    with make_engine(model, spec_k=K, breaker_cooldown=600.0) as eng:
        if broken != "draft_step":
            _break_builds(monkeypatch, eng, broken)
        out = eng.generate(p, max_new_tokens=12, speculative=True, timeout=60)
        st = eng.stats()
    assert out.tolist() == want.tolist()
    assert st["retired"]["error"] == 0 and st["quarantine_shed"] == 0
    assert st["program_failures"] == 3
    assert st["spec"]["iterations"] == st["spec"]["verify_steps"] == 0
    assert st["steps"] == 12
    name = next(n for n in st["programs"] if n.startswith(broken))
    assert st["programs"][name]["breaker"] == {"state": "open", "consecutive_failures": 3,
                                               "trips": 1, "shed": 0}
    assert st["programs"]["step4x32"]["breaker"] == CLOSED


@pytest.mark.parametrize("which", ["step", "fill"])
def test_failing_program_quarantines_and_sheds(which):
    """A step or fill that fails 3 times in a row opens its breaker: the
    next request is shed at once with the retryable BucketQuarantined
    (wire status 2), without a call; after the cooldown one probe runs,
    and its success closes the breaker."""
    kw = {"fail_steps" if which == "step" else "fail_fills": 3}
    p = prompt_with(SUFFIXES[0])
    with make_engine(torch_toy_model(**kw), breaker_cooldown=0.3) as eng:
        for _ in range(3):
            with pytest.raises(batching.RetryableError, match="boom"):
                eng.generate(p, max_new_tokens=4, timeout=60)
        with pytest.raises(batching.BucketQuarantined):
            eng.generate(p, max_new_tokens=4, timeout=60)
        st = eng.stats()
        key = "step4x32" if which == "step" else "fill1x8"
        assert st["programs"][key]["breaker"] == {"state": "open", "consecutive_failures": 3,
                                                  "trips": 1, "shed": 1}
        assert st["quarantine_shed"] == 1 and st["retired"]["error"] == 4
        assert st["program_failures"] == 3
        assert eng.health()["free_slots"] == eng.max_slots
        time.sleep(0.35)
        out = eng.generate(p, max_new_tokens=4, timeout=60)
        assert eng.stats()["programs"][key]["breaker"] == dict(CLOSED, trips=1, shed=1)
    with make_engine(torch_toy_model()) as eng:
        assert out.tolist() == eng.generate(p, max_new_tokens=4, timeout=60).tolist()


# ------------------------------------------------------------- draft padding
def test_draft_step_keeps_every_row_below_draft_pos(monkeypatch):
    """In a draft step, a row that is not catching up repeats its last
    feed (token, draft_pos - 1), a row without draft state feeds position
    0: no draft step changes a draft row below any sequence's draft_pos.
    A fresh opted sequence and a resumed one (12 tokens generated, its
    draft empty) take their first burst in one iteration: the fresh one
    is caught up after 4 draft steps, the resumed one after 15, and the
    fresh one's rows must not move meanwhile."""
    model = spec_model()
    draft = model.draft
    p, q = prompt_with(SUFFIXES[1]), prompt_with(SUFFIXES[2])
    with make_engine(model, spec_k=K, max_seq_len=48) as eng:
        src = eng.submit(q, max_new_tokens=14, snapshot_every=12)
        want_q = src.result(timeout=60)
        blob = src.latest_snapshot()
        checks = {"calls": 0, "repeats": 0, "moved": 0}
        real_step = draft.step_fn

        def checked_step(params, tokens, positions, kv_k, kv_v, *feats):
            held = [(s.slot, s.draft_pos) for s in list(eng._active) if s.draft_pos]
            before = [(kv_k[i, :n].clone(), kv_v[i, :n].clone()) for i, n in held]
            out = real_step(params, tokens, positions, kv_k, kv_v, *feats)
            # counted, not asserted here: the engine would take an
            # exception in a draft step for draft trouble and degrade
            for (i, n), (k, v) in zip(held, before):
                checks["moved"] += not (torch.equal(kv_k[i, :n], k)
                                        and torch.equal(kv_v[i, :n], v))
                checks["repeats"] += int(positions[i]) == n - 1
            checks["calls"] += 1
            return out

        monkeypatch.setattr(draft, "step_fn", checked_step)
        # a joins (its finishing step is a plain one) while b is queued
        # behind it, so both burst first in the next iteration
        with eng._exec_lock:
            a = eng.submit(p, max_new_tokens=24, speculative=True)
            deadline = time.monotonic() + 30
            while not eng._joining:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            b = eng.resume(blob, speculative=True)
        got_a, got_b = a.result(timeout=60), b.result(timeout=60)
        st = eng.stats()["spec"]
        assert eng.stats()["programs"]["draft_step4x48"]["breaker"] == CLOSED
    with make_engine(torch_toy_model(seed=0, anchor=4.0), max_seq_len=48) as eng:
        want_a = eng.generate(p, max_new_tokens=24, timeout=60)
    assert got_a.tolist() == want_a.tolist() and got_b.tolist() == want_q.tolist()
    assert checks["moved"] == 0
    assert checks["calls"] == st["draft_steps"] and checks["repeats"] >= 11
