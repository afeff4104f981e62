"""The port's KV reuse and resume (paddle_tpu_torch/inference/
prefix_cache.py, the chunked fill, kv snapshots and cmds 9/10 of
inference/decode.py and server.py) against the JAX package's, on the CPU.

Mirrors tests/test_prefix_spec.py (TestPrefixEngine) and
tests/test_decode_resume.py (the engine, skew and wire classes) on the
torch twin of the toy decoder (tests/test_torch_decode.py) and on a
depth-2 Llama, MHA and GQA. Tolerances, per test:

- bitwise: chain hashes and feature seeds, kv-snapshot bytes and the
  weights digest against the reference's; the memory tier's stats under
  one seeded insert/lookup/evict sequence; hit = cold tokens; a resumed
  suffix against the unbroken stream; the port's tokens and hit/miss
  counts against the JAX engine's; snapshot prompt, tail and features
  against the JAX engine's;
- 1e-5 absolute (float32): the fill's KV rows against the JAX toy's
  prefill rows (and Llama's fill rows against the cache rows of
  ``llama_generate``'s one-shot prefill, ``_CachedLlama.forward``, which
  tests/test_torch_generation.py holds against the JAX tokens); the
  snapshot's KV rows against the JAX engine's at the same position.
"""
import json
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import prefix_cache as ref_pc
from paddle_tpu.inference import wire_spec as ref_spec
from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.text import models as jmodels
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.inference import prefix_cache as pc
from paddle_tpu_torch.inference import wire_spec as ws
from paddle_tpu_torch.inference.decode import (DecodeEngine, SnapshotRefused, _KVSlots,
                                               _KVStack, _PageStore)
from paddle_tpu_torch.inference.server import PredictorServer
from paddle_tpu_torch.text import generation as tgen
from paddle_tpu_torch.text import models as tmodels

from decode_worker import toy_decode_model
from test_torch_decode import torch_toy_model

torch.set_num_threads(1)

HID, VOCAB, PAGE = 16, 32, 8
PREFIX = np.arange(1, 17, dtype=np.int32)  # two pages: the system-prompt stand-in
SUFFIXES = [np.array([21, 22], np.int32), np.array([23, 24, 25], np.int32),
            np.array([26], np.int32)]
PROMPT = np.array([1, 2, 3], np.int32)
MAX_NEW = 12
TOL_KV = 1e-5
_PREFIX_ENV = ("PADDLE_TPU_PREFIX_DIR", "PADDLE_TPU_PREFIX_DISABLE",
               "PADDLE_TPU_PREFIX_MAX_BYTES")


def prompt_with(suffix):
    return np.concatenate([PREFIX, np.asarray(suffix, np.int32)])


def make_engine(model, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq_len", 32)
    kw.setdefault("min_seq_bucket", PAGE)
    kw.setdefault("name", "prefix-resume-test")
    return DecodeEngine(model, device="cpu", **kw)


@pytest.fixture(scope="module")
def clean_env():
    """The JAX engine's prefix cache reads PADDLE_TPU_PREFIX_* at
    construction (tests/test_prefix_spec.py clears them the same way)."""
    with pytest.MonkeyPatch.context() as mp:
        for k in _PREFIX_ENV:
            mp.delenv(k, raising=False)
        yield


@pytest.fixture(scope="module")
def model():
    return torch_toy_model()


@pytest.fixture(scope="module")
def jax_model():
    return toy_decode_model(hidden=HID, vocab=VOCAB, seed=0)


@pytest.fixture(scope="module")
def jax_engine(clean_env, jax_model):
    eng = JaxEngine(jax_model, max_slots=4, max_seq_len=32, min_seq_bucket=PAGE,
                    watchdog_interval=0, prefix=True, name="prefix-resume-jax")
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def ref_tokens(model):
    with make_engine(model, prefix=False) as eng:
        return eng.generate(PROMPT, max_new_tokens=MAX_NEW, timeout=60).tolist()


def drain(req):
    out = []
    while True:
        toks, done = req.next_tokens(timeout=60)
        out.extend(int(t) for t in toks)
        if done:
            return out


def run_and_snapshot(engine, prompt=PROMPT, max_new=MAX_NEW, every=5, features=()):
    """One whole decode with a cadence -> (tokens, newest snapshot)."""
    req = engine.submit(prompt, max_new_tokens=max_new, snapshot_every=every,
                        features=features)
    toks = [int(t) for t in req.result(timeout=60)]
    snap = req.latest_snapshot()
    assert snap is not None
    return toks, bytes(snap)


# ------------------------------------------------- bitwise: the hashes, the codec
@pytest.mark.parametrize("page", [4, 8, 16])
def test_chain_hashes_and_feature_seed_bitwise(page):
    rng = np.random.RandomState(page)
    feats = [rng.randn(3).astype(np.float32), np.array([1, 0, 2], np.int64),
             np.array([True, False])]
    for n in (1, 7, 8, 33, 64):
        prompt = rng.randint(0, 32000, n).astype(np.int32)
        for f in ((), feats[:1], feats):
            seed = pc.feature_seed(f)
            assert seed == ref_pc.feature_seed(f)
            assert pc.prefix_hashes(prompt, page, seed) == ref_pc.prefix_hashes(prompt, page,
                                                                                 seed)
            # int64 prompts hash as their int32 bytes, as the reference's do
            assert pc.prefix_hashes(prompt.astype(np.int64), page, seed) == \
                ref_pc.prefix_hashes(prompt, page, seed)


def test_kv_snapshot_codec_bytes_equal_the_reference():
    rng = np.random.RandomState(0)
    header = {"fingerprint": "f" * 64, "weights": "w" * 64, "quant": "f32",
              "mesh": "single", "pos": 9, "last_token": 5, "n_generated": 3,
              "prompt_len": 7, "max_new_tokens": 12, "eos_token_id": None, "n_kv": 2}
    arrays = [rng.randint(0, 99, 7).astype(np.int32), np.array([4, 2, 5], np.int64),
              rng.randn(9, 2, 4).astype(np.float32), rng.randn(9, 2, 4).astype(np.float32),
              np.array([True, False])]
    blob = ws.encode_kv_snapshot(header, arrays)
    assert blob == ref_spec.encode_kv_snapshot(header, arrays)
    assert ws.is_kv_snapshot(blob) and not ws.is_kv_snapshot(ws.encode_arrays(arrays[:1]))
    hdr, got, end = ws.decode_kv_snapshot_off(blob)
    assert hdr == ref_spec.decode_kv_snapshot_header(blob) == ws.decode_kv_snapshot_header(blob)
    assert end == len(blob)
    for g, w in zip(got, arrays):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    tail = ws.encode_decode_opts(12, snapshot_every=4) + ws.encode_deadline(250.0)
    ours = ws.decode_kv_resume(blob + tail)
    theirs = ref_spec.decode_kv_resume(blob + tail)
    assert ours[0] == theirs[0] and ours[2:] == theirs[2:]
    with pytest.raises(ValueError, match="magic"):
        ws.decode_kv_snapshot_off(b"\x00" + blob[1:])
    with pytest.raises(ValueError, match="missing"):
        ws.encode_kv_snapshot({"pos": 1}, arrays)


def test_weights_digest_equals_the_jax_engine(model, jax_engine):
    assert model.weights_digest()[0] == jax_engine._programs._weights_digest()


# ---------------------------------------------------------- the memory tier
class _Refs:
    """A page pool of refcounts only: what the cache needs of one."""

    page_len, kv_spec = PAGE, ()

    def __init__(self):
        self.rc = {}

    def page_bytes(self):
        return 100

    def retain_page(self, pid):
        self.rc[pid] = self.rc.get(pid, 0) + 1

    def drop_page(self, pid):
        self.rc[pid] -= 1
        if not self.rc[pid]:
            del self.rc[pid]


def test_prefix_cache_stats_equal_the_reference(clean_env, tmp_path):
    """One seeded sequence of lookups and inserts (chains sharing pages,
    duplicates, evictions under a 12-page budget) through both memory
    tiers: the same answers, stats and page references after every op."""
    ours_refs, ref_refs = _Refs(), _Refs()
    ours = pc.PrefixCache(ours_refs, max_bytes=1200)
    ref = ref_pc.PrefixCache(ref_refs, max_bytes=1200)
    rng = np.random.RandomState(11)
    heads = [np.arange(8), np.arange(8) + 1, np.arange(8) * 2]  # three first pages
    next_page = 0
    for _ in range(60):
        prompt = np.concatenate([heads[rng.randint(3)], rng.randint(0, 2, 8),
                                 rng.randint(0, 50, rng.randint(0, 20))])
        hashes = pc.prefix_hashes(prompt.astype(np.int32), PAGE)
        if not hashes:
            continue
        assert ours.lookup(hashes) == ref.lookup(hashes)
        pages = list(range(next_page, next_page + len(hashes)))
        next_page += len(hashes)
        for n_tok, hx in hashes:
            assert ours.insert(hx, n_tok, pages[:n_tok // PAGE]) == \
                ref.insert(hx, n_tok, pages[:n_tok // PAGE])
        assert ours.stats() == ref.stats()
        assert ours_refs.rc == ref_refs.rc
    st = ours.stats()
    assert st["evictions"] > 0 and st["hits"] > 0 and st["misses"] > 0
    assert (st["store_hits"], st["store_refused"], st["persistent"]) == (0, 0, False)
    ours.clear()
    assert ours_refs.rc == {}
    tiered = pc.PrefixCache(ours_refs, store_dir=str(tmp_path))
    assert tiered.stats()["persistent"] and tiered.needs_publish("0" * 64)


@pytest.mark.parametrize("seq_axis,trailing", [(1, (3,)), (2, (2, 4))])
def test_page_store_round_trip(seq_axis, trailing):
    """Pages published from staging rows and installed back give the same
    rows; refcounts drain; the store grows past its first capacity."""
    spec = ((trailing, torch.float32), (trailing, torch.float32), ((5,), torch.float32))
    axis = [seq_axis, seq_axis, 1]
    if seq_axis != 1:
        spec, axis = spec[:2], axis[:2]
    staging = _KVStack(spec, seq_axis - 1, 1, 48, "cpu")
    g = torch.Generator().manual_seed(0)
    for v in staging.views:
        v.copy_(torch.randn(v.shape, generator=g))
    want = [v.clone() for v in staging.views]
    store = _PageStore(spec, seq_axis, 4, "cpu")
    pages = store.publish(staging, 0, 12)  # 48 rows, past the first 8-page capacity
    assert store.capacity() == 16 and store.live_pages() == 12
    for v in staging.views:
        v.zero_()
    store.install(pages[:5], staging)
    for v, w in zip(staging.views, want):
        ax = seq_axis
        assert torch.equal(v.narrow(ax, 0, 20), w.narrow(ax, 0, 20))
        assert not v.narrow(ax, 20, 4).any()
    store.retain_page(pages[0])
    assert store.shared_pages() == 1
    for p in pages + pages[:1]:
        store.drop_page(p)
    assert store.live_pages() == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_counts_follow_the_refcounts(seed):
    """The live and shared counts the store keeps (what ``stats`` reads
    without walking the refcounts) equal a count over the refcounts after
    every publish, retain and drop of a seeded sequence."""
    spec = (((2,), torch.float32),)
    staging = _KVStack(spec, 0, 1, 16, "cpu")
    store = _PageStore(spec, 1, 4, "cpu")
    rng = np.random.RandomState(seed)
    held = []  # one entry per reference the test holds
    for _ in range(200):
        op = rng.randint(3)
        if op == 0 or not held:
            held += store.publish(staging, 0, int(rng.randint(1, 5)))
        elif op == 1:
            pid = held[rng.randint(len(held))]
            store.retain_page(pid)
            held.append(pid)
        else:
            store.drop_page(held.pop(rng.randint(len(held))))
        rcs = list(store._rc.values())
        assert store.live_pages() == len(rcs) == len(set(held))
        assert store.shared_pages() == sum(rc > 1 for rc in rcs)
    for pid in held:
        store.drop_page(pid)
    assert (store.live_pages(), store.shared_pages()) == (0, 0)


class _SlowWalk(dict):
    """A refcount map that pauses at every entry a walk yields and before
    every page it adds or drops, so a reader that walked it while the
    scheduler publishes or evicts pages would see it change under it."""

    def values(self):
        for v in super().values():
            time.sleep(1e-4)
            yield v

    def __setitem__(self, pid, rc):
        if pid not in self:
            time.sleep(1e-4)
        super().__setitem__(pid, rc)

    def __delitem__(self, pid):
        time.sleep(1e-4)
        super().__delitem__(pid)


def test_stats_while_shared_prefix_fills_run(model):
    """cmd-5 stats read the page counts while the scheduler publishes,
    shares and evicts pages (a small budget), from two threads at a tiny
    switch interval: never an error (stats never walks the refcount map,
    which here pauses at every entry it yields), and the counts match the
    refcounts once the engine is idle."""
    page_bytes = PAGE * HID * 4 * 2
    with make_engine(model, prefix_max_bytes=40 * page_bytes) as eng:
        eng._pages._rc = _SlowWalk(eng._pages._rc)
        stop, errors, reads = threading.Event(), [], [0]

        def hammer():
            while not stop.is_set():
                try:
                    st = eng.stats()
                    assert st["live_pages"] >= st["shared_pages"] >= 0
                    reads[0] += 1
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)
                    return

        threads = [threading.Thread(target=hammer) for _ in range(2)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            rng = np.random.RandomState(11)
            for _ in range(12):
                reqs = [eng.submit(prompt_with(rng.randint(1, VOCAB, n).astype(np.int32)),
                                   max_new_tokens=1) for n in (1, 8, 9, 3)]
                for r in reqs:
                    r.result(timeout=60)
        finally:
            stop.set()
            for t in threads:
                t.join(30)
            sys.setswitchinterval(interval)
        assert not errors and reads[0] > 0
        st, rcs = eng.stats(), list(eng._pages._rc.values())
        assert st["live_pages"] == len(rcs) > 0
        assert st["shared_pages"] == sum(rc > 1 for rc in rcs) > 0
        assert st["prefix"]["evictions"] > 0


# ------------------------------------------------------------ hit = cold
def test_hit_vs_cold_bitwise(model):
    """A hit emits exactly the cold tokens (the reference's
    test_hit_vs_cold_bitwise at its defaults)."""
    with make_engine(model) as hot, make_engine(model, prefix=False) as cold:
        for sfx in SUFFIXES:
            p = prompt_with(sfx)
            a = hot.generate(p, max_new_tokens=6, timeout=60)
            b = cold.generate(p, max_new_tokens=6, timeout=60)
            assert a.tolist() == b.tolist()
        st = hot.stats()
        assert st["prefix"]["hits"] == len(SUFFIXES) - 1 and st["prefix"]["misses"] == 1
        assert cold.stats()["prefix"] is None
        # a hit fills only its suffix: 3 chunks cold, 1 a hit
        assert st["prefix_fill_steps"] == 3 + 1 + 1
        assert st["live_pages"] == 2 and st["shared_pages"] == 1


# ------------------------------------------------------ the persistent tier
def test_persistent_tier_second_engine_hits_bitwise_the_cold(model, tmp_path):
    """An engine fills a prompt and publishes its longest boundary to its
    ``prefix_dir``; a second engine (a respawned replica) on the same
    directory misses its memory tier, loads the block, fills only the
    suffix and emits exactly the cold tokens; the block is the
    reference's format, its KV rows those of the cold fill."""
    p = prompt_with(SUFFIXES[1])
    with make_engine(model, prefix=False) as cold:
        want = cold.generate(p, max_new_tokens=6, timeout=60).tolist()
    with make_engine(model, prefix_dir=str(tmp_path), name="tier-a") as first:
        assert first.generate(p, max_new_tokens=6, timeout=60).tolist() == want
        st = first.stats()["prefix"]
        assert st["persistent"] and st["store_hits"] == 0
    blocks = [n for n in sorted(tmp_path.iterdir()) if n.name.startswith("art-")]
    assert len(blocks) == 1
    blob = (blocks[0] / "program.jaxexport").read_bytes()
    header, arrays, _ = ref_spec.decode_kv_snapshot_off(blob)  # the reference reads it
    assert header["pos"] == 16 and header["page_len"] == PAGE
    assert arrays[0].tolist() == PREFIX.tolist() and arrays[1].size == 0
    with make_engine(model, prefix_dir=str(tmp_path), name="tier-b") as second:
        assert second.generate(p, max_new_tokens=6, timeout=60).tolist() == want
        st = second.stats()
        assert st["prefix"]["store_hits"] == 1 and st["prefix"]["misses"] == 1
        assert st["prefix_fill_steps"] == 1  # the suffix's chunk only
        # the loaded block became a memory entry: a third prompt hits in memory
        assert second.generate(prompt_with(SUFFIXES[2]), max_new_tokens=4,
                               timeout=60).size == 4
        assert second.stats()["prefix"]["hits"] == 1


def test_persistent_tier_skewed_identity_misses_cleanly(model, tmp_path):
    """Other weights are another key (a clean miss, nothing refused); a
    block under this replica's key whose tokens do not match is refused
    (counted) and never installed: the stream is the cold one."""
    p = prompt_with(SUFFIXES[0])
    with make_engine(model, prefix_dir=str(tmp_path), name="skew-a") as first:
        first.generate(p, max_new_tokens=4, timeout=60)
    other = torch_toy_model(seed=1)
    with make_engine(other, prefix=False) as cold:
        want = cold.generate(p, max_new_tokens=4, timeout=60).tolist()
    with make_engine(other, prefix_dir=str(tmp_path), name="skew-b") as eng:
        assert eng.generate(p, max_new_tokens=4, timeout=60).tolist() == want
        st = eng.stats()["prefix"]
        assert (st["store_hits"], st["store_refused"]) == (0, 0)
    # forge: this model's key, another prompt's block
    with make_engine(model, prefix_dir=str(tmp_path / "forged"), name="skew-c") as eng:
        cache = eng._prefix
        hashes = pc.prefix_hashes(p, PAGE, pc.feature_seed(()))
        n_tok, hx = hashes[-1]
        wrong = np.array(p[:n_tok], np.int32)
        wrong[0] += 1
        kv = [np.zeros((n_tok, HID), np.float32)] * 2
        cache._published.discard(hx)
        assert cache.publish(hx, n_tok, wrong, kv)  # published under hx's key
        with make_engine(model, prefix=False) as cold:
            want = cold.generate(p, max_new_tokens=4, timeout=60).tolist()
        assert eng.generate(p, max_new_tokens=4, timeout=60).tolist() == want
        st = eng.stats()["prefix"]
        assert st["store_refused"] >= 1 and st["store_hits"] == 0


def test_concurrent_shared_prefix_bitwise(model):
    with make_engine(model) as eng, make_engine(model, prefix=False) as cold:
        eng.generate(prompt_with(SUFFIXES[0]), max_new_tokens=2, timeout=60)  # seed it
        reqs = [eng.submit(prompt_with(sfx), max_new_tokens=6 + i)
                for i, sfx in enumerate(SUFFIXES)]
        outs = [r.result(timeout=60) for r in reqs]
        for i, (sfx, out) in enumerate(zip(SUFFIXES, outs)):
            assert out.tolist() == cold.generate(prompt_with(sfx), max_new_tokens=6 + i,
                                                 timeout=60).tolist()
        assert eng.stats()["prefix"]["hits"] >= len(SUFFIXES)


def test_eviction_under_pressure(model):
    with make_engine(model, prefix_max_bytes=3 * (PAGE * HID * 4 * 2)) as eng, \
            make_engine(model, prefix=False) as ref:
        rng = np.random.RandomState(3)
        for _ in range(4):
            p = rng.randint(1, VOCAB, size=17).astype(np.int32)
            a = eng.generate(p, max_new_tokens=4, timeout=60)
            b = ref.generate(p, max_new_tokens=4, timeout=60)
            assert a.tolist() == b.tolist()
        st = eng.stats()["prefix"]
        assert st["evictions"] >= 1 and st["pages"] <= st["max_pages"] == 3
    assert eng._pages.live_pages() == 0  # close drained the cache


def test_tokens_and_counts_equal_the_jax_engine(model, jax_engine):
    """The same prompts one after another through the port's engine and
    the JAX engine, both with the prefix cache: the same tokens, and the
    same hits and misses."""
    prompts = [prompt_with(SUFFIXES[0]), prompt_with(SUFFIXES[1]), PREFIX[:8],
               np.arange(5, 22, dtype=np.int32), prompt_with(SUFFIXES[2]), PROMPT]
    before = jax_engine.stats()["prefix"]
    with make_engine(model) as eng:
        for p in prompts:
            got = eng.generate(p, max_new_tokens=7, timeout=60)
            want = jax_engine.generate(p, max_new_tokens=7, timeout=120)
            assert got.tolist() == want.tolist()
        ours = eng.stats()["prefix"]
    theirs = jax_engine.stats()["prefix"]
    assert (ours["hits"], ours["misses"]) == (theirs["hits"] - before["hits"],
                                              theirs["misses"] - before["misses"])
    assert (ours["hits"], ours["misses"]) == (3, 2)


def test_fill_rows_match_the_jax_prefill(model, jax_model):
    """The toy's staging rows after a cold fill (two chunks, the second
    padded) against the JAX prefill's kv rows."""
    p = prompt_with(SUFFIXES[1])
    with make_engine(model, prefix=False) as eng:
        eng.generate(p, max_new_tokens=1, timeout=60)
        rows = [v[0, :p.size].numpy() for v in eng._staging.views]
    tokens = np.zeros((1, 24), np.int32)
    tokens[0, :p.size] = p
    _, k, v = jax_model.prefill_fn(jax_model.params, tokens, np.array([p.size], np.int32))
    for got, want in zip(rows, (k, v)):
        np.testing.assert_allclose(got, np.asarray(want)[0, :p.size], atol=TOL_KV, rtol=0)


# ------------------------------------------------------------------ Llama
LLAMA = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)


@pytest.fixture(scope="module", params=[None, 1], ids=["mha", "gqa1"])
def llama(request):
    paddle.seed(5)
    jm = jmodels.LlamaModel(**LLAMA, num_kv_heads=request.param)
    tm = tmodels.LlamaModel(**LLAMA, num_kv_heads=request.param, device="cpu")
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    return tm.eval()


def test_llama_hit_vs_cold_and_resume_bitwise(llama):
    """Depth-2 Llama: prompts sharing a 16-token prefix, decoded together,
    hit and emit their cold tokens; the fill's rows agree with
    ``llama_generate``'s one-shot prefill rows within 1e-5; a stream resumed from its snapshot
    on a second engine emits the unbroken suffix."""
    rng = np.random.RandomState(9)
    shared = rng.randint(0, 128, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 128, n).astype(np.int32)])
               for n in (2, 5, 8)]
    dm = tgen.llama_decode_model(llama, 4, 40)
    with DecodeEngine(dm, device="cpu", max_prompt_len=24, name="hot") as hot, \
            DecodeEngine(dm, device="cpu", max_prompt_len=24, prefix=False, name="cold") as cold:
        hot.generate(prompts[0], max_new_tokens=2, timeout=60)
        reqs = [hot.submit(p, max_new_tokens=8) for p in prompts]
        got = [r.result(timeout=60) for r in reqs]
        want = [cold.generate(p, max_new_tokens=8, timeout=60) for p in prompts]
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        assert hot.stats()["prefix"]["hits"] == 3
        # the fill's rows of the last cold prompt against the one-shot prefill
        p = prompts[-1]
        with torch.inference_mode():
            run = tgen._CachedLlama(llama, 1, p.size, 1)
            run.forward(torch.from_numpy(p[None].astype(np.int64)), 0)
        kv = [c[li, 0] for li in range(LLAMA["num_layers"]) for c in (run.k, run.v)]
        for st, one in zip(cold._staging.views, kv):
            torch.testing.assert_close(st[0, :, :p.size], one[:, :p.size], atol=TOL_KV,
                                       rtol=0)
        # resume on the other engine from a cadence-3 snapshot
        toks, snap = run_and_snapshot(hot, prompts[1], max_new=8, every=3)
        n_gen = ws.decode_kv_snapshot_header(snap)["n_generated"]
        assert toks == want[1].tolist() and n_gen == 6
        req = cold.resume(snap)
        assert drain(req) == toks[n_gen:]


def test_bf16_llama_snapshot_widens_and_resumes_bitwise():
    """bf16 KV rows travel as f32 (the wire has no bf16) and narrow back
    exactly: the resumed suffix is the unbroken stream's."""
    tm = tmodels.LlamaModel(**LLAMA, device="cpu").to(torch.bfloat16).eval()
    dm = tgen.llama_decode_model(tm, 2, 32)
    prompt = np.random.RandomState(4).randint(0, 128, 11).astype(np.int32)
    with DecodeEngine(dm, device="cpu", max_prompt_len=16) as a, \
            DecodeEngine(dm, device="cpu", max_prompt_len=16, name="b") as b:
        toks, snap = run_and_snapshot(a, prompt, max_new=9, every=4)
        hdr, arrays, _ = ws.decode_kv_snapshot_off(snap)
        assert all(x.dtype == np.float32 and x.shape == (hdr["pos"], 2, 64)
                   for x in arrays[2:])
        assert drain(b.resume(snap)) == toks[hdr["n_generated"]:]


# ---------------------------------------------------------- snapshot, resume
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_axis,trailing", [(1, (3,)), (2, (2, 4))])
def test_slot_snapshot_copy_layout(dtype, seq_axis, trailing):
    """A slot's snapshot copy gives each kv entry's first ``length`` rows
    in the reference's ``[length, *trailing]`` layout and its wire dtype
    (bf16 widened to f32, exactly), and is a copy: the slot's later writes
    do not reach it."""
    spec = ((trailing, dtype), (trailing, dtype), ((5,), torch.float32))
    slots = _KVSlots(2, 8, spec, seq_axis, torch.device("cpu"))
    g = torch.Generator().manual_seed(1)
    for pool in slots.pools:
        pool.copy_(torch.randn(pool.shape, generator=g))
    ax = seq_axis - 1
    want = [pool[1].narrow(ax, 0, 5).movedim(ax, 0).float().numpy().copy()
            for pool in slots.pools]
    arrays = slots.snapshot(1, 5)
    for pool in slots.pools:
        pool.fill_(7.0)
    got = arrays()
    assert [a.dtype for a in got] == [np.dtype(np.float32)] * 3
    for a, w in zip(got, want):
        assert a.shape == w.shape and np.array_equal(a, w)


def test_snapshot_blocks_are_built_off_the_scheduler(model, monkeypatch):
    """A cadence-1 stream's blocks are built on its consumer's thread, so
    an encode slower than the neighbours' per-token budget (0.3 s here)
    never stalls the steps: a budgeted stream beside it keeps every
    token, and no block is built on the scheduler."""
    real, builders = ws.encode_kv_snapshot, []

    def slow_encode(header, arrays):
        builders.append(threading.current_thread().name)
        time.sleep(0.3)
        return real(header, arrays)

    monkeypatch.setattr(ws, "encode_kv_snapshot", slow_encode)
    with make_engine(torch_toy_model(step_delay=0.01), name="snappy") as eng:
        snappy = eng.submit(PROMPT, max_new_tokens=MAX_NEW, snapshot_every=1)
        budgeted = eng.submit(PREFIX, max_new_tokens=MAX_NEW, token_budget_s=0.25)
        taken = []
        while not snappy._done or snappy._snap_fresh:
            got = snappy.take_snapshot()
            if got is not None:
                taken.append(got)
            time.sleep(0.001)
        assert budgeted.result(timeout=60).size == MAX_NEW
        toks = snappy.result(timeout=60).tolist()
        last = snappy.latest_snapshot()
        st = eng.stats()
    assert st["deadline_late"] == 0 and st["retired"]["max_tokens"] == 2
    # a snapshot per token but the last (the stream retires there)
    assert st["snapshots"] == MAX_NEW - 1 and taken
    assert builders and "snappy-scheduler" not in builders
    assert set(st["snapshot_costs"]) == {"copy_ms", "encode_ms", "bytes"}
    assert st["snapshot_costs"]["encode_ms"] >= 300 > st["snapshot_costs"]["copy_ms"]
    for blob, n in taken + [(last, MAX_NEW - 1)]:
        hdr = ws.decode_kv_snapshot_header(blob)
        assert hdr["n_generated"] == n and hdr["pos"] == PROMPT.size + n - 1
        assert hdr["last_token"] == toks[n - 1]

def test_snapshot_arrays_against_the_jax_engine(clean_env):
    """The same sequence, with features, snapshotted at the same position
    by both engines: prompt, tail and features bitwise, KV within 1e-5,
    the header's geometry equal."""
    spec = (((3,), np.dtype(np.float32)),)
    feats = [np.array([0.5, -1.0, 2.0], np.float32)]
    ours_m = torch_toy_model(feature_spec=spec)
    theirs_m = toy_decode_model(hidden=HID, vocab=VOCAB, seed=0, feature_spec=spec)
    with make_engine(ours_m) as eng:
        toks, snap = run_and_snapshot(eng, prompt_with(SUFFIXES[1]), features=feats)
    jeng = JaxEngine(theirs_m, max_slots=4, max_seq_len=32, min_seq_bucket=PAGE,
                     watchdog_interval=0, prefix=True, name="snap-jax")
    try:
        req = jeng.submit(prompt_with(SUFFIXES[1]), max_new_tokens=MAX_NEW, snapshot_every=5,
                          features=feats)
        jtoks = [int(t) for t in req.result(timeout=120)]
        jsnap = req.latest_snapshot()
        jdigest = jeng._programs._weights_digest()
    finally:
        jeng.close()
    assert toks == jtoks
    hdr, arrays, _ = ws.decode_kv_snapshot_off(snap)
    jhdr, jarrays, _ = ref_spec.decode_kv_snapshot_off(jsnap)
    for key in ("pos", "last_token", "n_generated", "prompt_len", "max_new_tokens",
                "eos_token_id", "n_kv", "quant", "mesh", "v"):
        assert hdr[key] == jhdr[key], key
    assert hdr["weights"] == jdigest and hdr["fingerprint"] != jhdr["fingerprint"]
    assert len(arrays) == len(jarrays) == 5
    for i in (0, 1, 4):
        assert arrays[i].dtype == jarrays[i].dtype and np.array_equal(arrays[i], jarrays[i])
    for i in (2, 3):
        assert arrays[i].shape == jarrays[i].shape == (hdr["pos"], HID)
        np.testing.assert_allclose(arrays[i], jarrays[i], atol=TOL_KV, rtol=0)


def test_resume_suffix_bitwise_identical(model, ref_tokens):
    with make_engine(model) as a, make_engine(model, name="b") as b:
        toks, snap = run_and_snapshot(a)
        assert toks == ref_tokens
        g = int(ws.decode_kv_snapshot_header(snap)["n_generated"])
        assert 0 < g < MAX_NEW
        req = b.resume(snap, max_new_tokens=MAX_NEW)
        assert drain(req) == ref_tokens[g:]  # nothing before the snapshot
        assert [int(t) for t in req.result(timeout=60)] == ref_tokens
        st = b.stats()
        assert st["resumes"] == {"ok": 1, "refused": 0} and st["resume_queue_depth"] == 0
        assert a.stats()["snapshots"] == MAX_NEW // 5


def test_snapshot_header_identity(model, ref_tokens):
    with make_engine(model) as eng:
        _, snap = run_and_snapshot(eng)
        eng.warmup()
        assert eng.stats()["weights_digest_ms"] >= 0
    hdr = ws.decode_kv_snapshot_header(snap)
    g = int(hdr["n_generated"])
    assert hdr["v"] == ws.KV_SNAPSHOT_VERSION and hdr["prompt_len"] == PROMPT.size
    assert hdr["pos"] == PROMPT.size + g - 1 and hdr["last_token"] == ref_tokens[g - 1]
    assert (hdr["quant"], hdr["mesh"]) == ("f32", "single")
    assert hdr["fingerprint"] == model.fingerprint(PAGE) != model.fingerprint(16)
    assert hdr["weights"] == model.weights_digest()[0]


def test_boundary_snapshot_resumes_to_clean_finish(model, ref_tokens):
    with make_engine(model) as eng:
        _, snap = run_and_snapshot(eng)
        g = int(ws.decode_kv_snapshot_header(snap)["n_generated"])
        free = eng.health()["free_slots"]
        req = eng.resume(snap, max_new_tokens=g)
        assert drain(req) == []
        assert [int(t) for t in req.result(timeout=60)] == ref_tokens[:g]
        assert eng.health()["free_slots"] == free


def test_weights_skew_refused(model):
    with make_engine(model) as a, make_engine(torch_toy_model(seed=1), name="skew") as b:
        _, snap = run_and_snapshot(a)
        with pytest.raises(SnapshotRefused, match="weights"):
            b.resume(snap)
        assert b.stats()["resumes"] == {"ok": 0, "refused": 1}


def test_fingerprint_skew_refused(model):
    with make_engine(model) as a, make_engine(torch_toy_model(vocab=16), name="skew") as b:
        _, snap = run_and_snapshot(a)
        with pytest.raises(SnapshotRefused, match="fingerprint"):
            b.check_snapshot(snap)


@pytest.mark.parametrize("field,value", [("quant", "w8"), ("mesh", "tp2")])
def test_header_skew_refused(model, field, value):
    with make_engine(model) as eng:
        _, snap = run_and_snapshot(eng)
        hdr, arrays, _ = ws.decode_kv_snapshot_off(snap)
        hdr[field] = value
        with pytest.raises(SnapshotRefused, match=field):
            eng.check_snapshot(ws.encode_kv_snapshot(hdr, arrays))


def test_inconsistent_snapshot_is_a_request_error(model):
    """A block whose own fields disagree (pos against its prompt and
    tail) is malformed, wire status 1, never a refusal."""
    with make_engine(model) as eng:
        _, snap = run_and_snapshot(eng)
        hdr, arrays, _ = ws.decode_kv_snapshot_off(snap)
        hdr["pos"] += 1
        with pytest.raises(ValueError, match="position"):
            eng.check_snapshot(ws.encode_kv_snapshot(hdr, arrays))


def test_seed_check_capacity_and_cancelled_resume(model):
    """With its one slot busy, an engine queues a resume (it holds its
    position), refuses to seed a handoff while one waits (kv_put's
    capacity half), and drops a cancelled resume from the queue."""
    from paddle_tpu_torch.inference.batching import EngineOverloaded

    with make_engine(model) as a:
        _, snap = run_and_snapshot(a)
    with make_engine(torch_toy_model(step_delay=0.02), max_slots=1) as eng:
        busy = eng.submit(PROMPT, max_new_tokens=25)
        busy.next_tokens(timeout=60)  # running: the slot is taken
        eng.seed_check(snap)  # a free queue: a handoff may seed here
        req = eng.resume(snap)
        assert eng.stats()["resume_queue_depth"] == 1
        with pytest.raises(EngineOverloaded, match="no free KV slot"):
            eng.seed_check(snap)
        eng.cancel(req)
        assert eng.stats()["resume_queue_depth"] == 0 and req.finish_reason == "cancelled"
        assert busy.result(timeout=60).size == 25
        assert eng.stats()["resumes"] == {"ok": 0, "refused": 0}


# -------------------------------------------------------------------- wire
def _recv(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("closed")
        buf += chunk
    return buf


def _exchange(port, frame):
    """Send one request frame; -> [(status, payload)] up to the terminal."""
    frames = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(frame)
        while True:
            (blen,) = struct.unpack("<I", _recv(s, 4))
            body = _recv(s, blen)
            frames.append((body[0], body[1:]))
            if body[0] != ws.STATUS_STREAM:
                return frames


def _split(frames):
    tokens, snaps = [], []
    for status, payload in frames:
        if payload and ws.is_kv_snapshot(payload):
            assert status == ws.STATUS_STREAM
            snaps.append(payload)
        elif payload:
            tokens.extend(int(t) for t in ws.decode_arrays(payload)[0])
    return frames[-1][0], tokens, snaps


def _decode(prompt, n, **opts):
    return ws.build_request(ws.CMD_INFER, ws.encode_arrays([prompt])
                            + ws.encode_decode_opts(n, **opts))


@pytest.fixture(scope="module")
def servers():
    """Two replicas of the toy (the same identity) and one of other
    weights. Steps take 10 ms, so a snapshot frame (sent between token
    frames, once its tokens are on the wire) has tokens left to follow."""
    made = [PredictorServer(None, decode_engine=make_engine(
        torch_toy_model(step_delay=0.01), name=f"wire-{i}"), own_decode_engine=True)
        for i in range(2)]
    other = PredictorServer(None, decode_engine=make_engine(
        torch_toy_model(seed=1, step_delay=0.01), name="wire-skew"), own_decode_engine=True)
    yield made + [other]
    for s in made + [other]:
        s.stop()


def test_stream_emits_covered_snapshots_and_kv_put_ok(servers, ref_tokens):
    frames = _exchange(servers[0].port, _decode(PROMPT, MAX_NEW, snapshot_every=4))
    status, tokens, snaps = _split(frames)
    assert (status, tokens) == (0, ref_tokens) and snaps
    assert {ws.decode_kv_snapshot_header(b)["n_generated"] for b in snaps} <= {4, 8}
    seen = 0
    for st, payload in frames:  # a snapshot frame only after the tokens it covers
        if ws.is_kv_snapshot(payload):
            assert ws.decode_kv_snapshot_header(payload)["n_generated"] <= seen
        else:
            seen += ws.decode_arrays(payload)[0].size
    (status, body), = _exchange(servers[1].port, ws.build_request(ws.CMD_KV_PUT, snaps[-1]))
    assert status == ws.STATUS_OK
    assert json.loads(body) == ws.decode_kv_snapshot_header(snaps[-1])


def test_kv_resume_streams_only_the_suffix_and_oneshot_the_whole(servers, ref_tokens):
    _, _, snaps = _split(_exchange(servers[0].port, _decode(PROMPT, MAX_NEW,
                                                            snapshot_every=5)))
    g = ws.decode_kv_snapshot_header(snaps[-1])["n_generated"]
    payload = snaps[-1] + ws.encode_decode_opts(MAX_NEW) + ws.encode_deadline(5000.0)
    status, tokens, more = _split(_exchange(servers[1].port,
                                            ws.build_request(ws.CMD_KV_RESUME, payload)))
    assert (status, tokens, more) == (0, ref_tokens[g:], [])
    payload = snaps[-1] + ws.encode_decode_opts(MAX_NEW, oneshot=True)
    frames = _exchange(servers[1].port, ws.build_request(ws.CMD_KV_RESUME, payload))
    assert len(frames) == 1 and _split(frames)[:2] == (0, ref_tokens)


def test_handoff_then_resume_gives_the_rest_bitwise(servers, ref_tokens):
    frames = _exchange(servers[0].port, _decode(PROMPT, MAX_NEW, handoff=True))
    assert [f[0] for f in frames] == [ws.STATUS_STREAM, ws.STATUS_OK]
    status, tokens, snaps = _split(frames)
    assert tokens == ref_tokens[:1] and len(snaps) == 1
    assert ws.decode_kv_snapshot_header(snaps[0])["n_generated"] == 1
    body = snaps[0] + ws.encode_decode_opts(MAX_NEW)
    assert _exchange(servers[1].port, ws.build_request(ws.CMD_KV_PUT, snaps[0]))[0][0] == 0
    status, rest, _ = _split(_exchange(servers[1].port, ws.build_request(ws.CMD_KV_RESUME,
                                                                         body)))
    assert (status, tokens + rest) == (0, ref_tokens)


def test_wire_skew_refusal_is_status2_never_tokens(servers):
    _, _, snaps = _split(_exchange(servers[0].port, _decode(PROMPT, MAX_NEW,
                                                            snapshot_every=5)))
    skewed = servers[2].port
    assert _exchange(skewed, ws.build_request(ws.CMD_KV_PUT, snaps[-1]))[0][0] == \
        ws.STATUS_RETRYABLE
    frames = _exchange(skewed, ws.build_request(ws.CMD_KV_RESUME,
                                                snaps[-1] + ws.encode_decode_opts(MAX_NEW)))
    assert _split(frames)[:2] == (ws.STATUS_RETRYABLE, [])
    hdr, arrays, _ = ws.decode_kv_snapshot_off(snaps[-1])
    hdr["pos"] = 99  # past this engine's max_seq_len, consistent with nothing
    bad = ws.encode_kv_snapshot(hdr, arrays)
    assert _exchange(servers[1].port, ws.build_request(ws.CMD_KV_PUT, bad))[0][0] == \
        ws.STATUS_ERROR
    assert _exchange(servers[1].port, ws.build_request(ws.CMD_KV_PUT, b"\x01"))[0][0] == \
        ws.STATUS_ERROR
