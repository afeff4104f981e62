"""The port's serving robustness on the CPU: scheduler watchdogs and
restarts, per-bucket quarantine, and the chaos harness, against the JAX
package's behaviour.

- Chaos (paddle_tpu_torch/resilience/chaos.py): visit counting and fault
  windows give the reference's outcomes, visit for visit.
- ``BatchingEngine``: a scheduler killed at ``serving.scheduler.loop``
  fails only its group in flight with ``SchedulerRestarted`` and the
  replacement serves the parked requests; a bucket failing at
  ``serving.execute.bucket2`` is quarantined while the other bucket keeps
  serving; each scenario gives the JAX engine's outcomes. A wedged
  execute is restarted and its late result is never delivered.
- ``DecodeEngine``: a scheduler killed at ``serving.decode.loop`` fails
  its sequences in flight with ``SchedulerRestarted`` (the tokens they
  had are a prefix of their unbroken tokens) and a depth-2 Llama then
  decodes exactly the JAX ``llama_generate``'s tokens, its programs built
  once; a wedged step is restarted and the superseded thread ends at its
  next call without touching the device; a restart sweep leaves the
  prefix cache's pages alone (also with a joiner in the middle of a
  multi-chunk fill), and a restart in the middle of a speculative burst
  leaves the retried streams equal to plain greedy.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import batching as ref_batching
from paddle_tpu.resilience import chaos as ref_chaos
from paddle_tpu.text import generation as jgen
from paddle_tpu.text import models as jmodels
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.inference import batching
from paddle_tpu_torch.inference.decode import DecodeEngine
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.text import generation as tgen
from paddle_tpu_torch.text import models as tmodels

from test_torch_decode import LLAMA, PROMPTS, make_engine, solo, torch_toy_model, wait_tokens
from test_torch_spec import prompt_with, spec_model

torch.set_num_threads(1)

# fast watchdogs, their wedge timeout well above any program call of these
# small models on a loaded CPU; every wedge below sleeps WEDGE_S, well above
# the timeout, so that the watchdog's restart always comes first
FAST = dict(watchdog_interval=0.02, wedge_timeout=2.5)
WEDGE_S = 6.0


def wait_until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


@pytest.fixture(autouse=True)
def clean_chaos():
    chaos.reset()
    ref_chaos.reset()
    yield
    chaos.reset()
    ref_chaos.reset()


# ------------------------------------------------------------------ chaos
def _chaos_script(mod):
    """One fixed script of arming and visits -> what each visit did."""
    monkey = mod.ChaosMonkey()
    monkey.arm("a", at=2, times=2, exc=RuntimeError("boom"))
    monkey.arm("b", at=1, exc=ValueError)
    monkey.arm("c", at=3, nan=True)
    out = []
    for site in "aaaabbcccc":
        try:
            out.append((site, monkey.hit(site)))
        except Exception as e:  # noqa: BLE001 - recorded
            out.append((site, type(e).__name__, str(e)))
    out.append([np.isnan(monkey.poison("c", np.ones(2, np.float32))).all() for _ in range(2)])
    out.append([monkey.visits(s) for s in "abcd"])
    out.append((monkey.armed(), monkey.armed("a"), monkey.armed("d"), list(monkey.log)))
    monkey.reset()
    out.append((monkey.armed(), monkey.visits("a")))
    with mod.fault("x", exc=KeyError("k"), at=mod.visits("x") + 2) as f:
        out.append(mod.hit("x") - mod.visits("x"))
        with pytest.raises(KeyError):
            mod.hit("x")
        out.append(f.fired)
    out.append(mod.armed("x"))
    with pytest.raises(ValueError):
        mod.Fault("y", at=0)
    return out


def test_chaos_visits_and_windows_equal_the_reference():
    assert _chaos_script(chaos) == _chaos_script(ref_chaos)


# ----------------------------------------------------------- batching engine
def _echo(x):
    return [np.asarray(x)]


def _batching_restart(mod, ch):
    """Six 1-row requests parked behind a scheduler that dies at its first
    loop: exactly the group in flight fails, the others are served."""
    eng = mod.BatchingEngine.for_callable(_echo, max_batch_size=1, max_wait_ms=1.0, **FAST)
    try:
        eng.warmup(signature=[("float32", (2,))])
        ch.arm("serving.scheduler.loop", exc=RuntimeError("die"))
        results, errors = {}, []

        def worker(i):
            try:
                results[i] = eng.infer([np.full((1, 2), float(i), np.float32)], timeout=20)
            except Exception as e:  # noqa: BLE001 - sorted below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads), "a client hung"
        assert all(out[0][0, 0] == i for i, out in results.items())
        st, h = eng.stats(), eng.health()
        return ([type(e).__name__ for e in errors], [e.status_code for e in errors],
                len(results), st["scheduler_restarts"], st["queue_depth"],
                h["scheduler_alive"], h["ok"])
    finally:
        eng.close()


def test_batching_restart_equals_the_reference():
    got = _batching_restart(batching, chaos)
    assert got == _batching_restart(ref_batching, ref_chaos)
    assert got == (["SchedulerRestarted"], [2], 5, 1, 0, True, True)


def _batching_quarantine(mod, ch):
    """Bucket 2 poisoned for ever, bucket 4 healthy: bucket 2 trips after
    two failures and sheds fast; bucket 4 keeps serving."""
    eng = mod.BatchingEngine.for_callable(_echo, max_batch_size=4, max_wait_ms=1.0,
                                          breaker_threshold=2, breaker_cooldown=30.0, **FAST)
    try:
        eng.warmup(signature=[("float32", (2,))])
        ch.arm("serving.execute.bucket2", exc=RuntimeError("poisoned"), times=1000)
        sick, healthy = np.ones((2, 2), np.float32), np.arange(8, dtype=np.float32).reshape(4, 2)
        outcomes = []
        for _ in range(5):
            try:
                eng.infer([sick], timeout=10)
                outcomes.append("ok")
            except Exception as e:  # noqa: BLE001 - recorded
                outcomes.append((type(e).__name__, getattr(e, "status_code", None)))
            out = eng.infer([healthy], timeout=10)
            outcomes.append(out[0].tobytes() == healthy.tobytes())
        st, h = eng.stats(), eng.health()
        sick_st = st["buckets"]["2"][0] if "2" in st["buckets"] else {}
        return (outcomes, st["breaker"], st["quarantine_shed"],
                st["buckets"]["4"][0]["batches"], sick_st.get("batches", 0),
                h["quarantined_buckets"], st["scheduler_restarts"])
    finally:
        eng.close()


def test_batching_quarantine_equals_the_reference():
    got = _batching_quarantine(batching, chaos)
    assert got == _batching_quarantine(ref_batching, ref_chaos)
    quarantined = ("BucketQuarantined", 2)
    assert got[0] == [("RuntimeError", None), True, ("RuntimeError", None), True,
                      quarantined, True, quarantined, True, quarantined, True]
    assert got[1]["open"] == 1 and got[2] == 3 and got[3] == 5 and got[5] == [2]


def test_batching_wedge_restarts_and_drops_the_late_result():
    eng = batching.BatchingEngine.for_callable(_echo, max_batch_size=4, max_wait_ms=1.0,
                                               name="wedge-batch", **FAST)
    try:
        eng.warmup(signature=[("float32", (2,))])
        x = np.ones((2, 2), np.float32)
        chaos.arm("serving.execute.bucket2", delay=WEDGE_S)
        t0 = time.monotonic()
        with pytest.raises(batching.SchedulerRestarted):
            eng.infer([x], timeout=20)
        assert time.monotonic() - t0 < WEDGE_S - 0.1, "the watchdog missed the wedge"
        assert eng.infer([x * 3], timeout=10)[0].tobytes() == (x * 3).tobytes()
        # the superseded thread wakes, drops its result and ends
        wait_until(lambda: not any(t.name == f"{eng.name}-scheduler" and t.is_alive()
                                   for t in threading.enumerate()))
        st = eng.stats()
        assert st["scheduler_restarts"] == 1 and st["buckets"]["2"][0]["batches"] == 1
        assert eng.health()["scheduler_alive"]
    finally:
        eng.close()


# ------------------------------------------------------------- decode engine
@pytest.fixture(scope="module")
def llama():
    paddle.seed(5)
    jm = jmodels.LlamaModel(**LLAMA)
    tm = tmodels.LlamaModel(**LLAMA, device="cpu")
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    return jm, tm.eval()


def _results(reqs):
    out = []
    for r in reqs:
        try:
            out.append(r.result(timeout=60).tolist())
        except batching.SchedulerRestarted:
            out.append(None)
    return out


def test_dead_decode_scheduler_restarts_and_serves_the_jax_tokens(llama):
    """Three Llama streams in flight when the scheduler dies at
    ``serving.decode.loop``: each fails retryable with the tokens it had a
    prefix of its unbroken tokens, nothing leaks, and the retries give
    the JAX llama_generate's tokens from the programs already built."""
    jm, tm = llama
    prompts = [np.random.RandomState(s).randint(0, 128, (n,)).astype(np.int32)
               for s, n in ((1, 3), (2, 11), (4, 17))]
    n = 8
    with DecodeEngine(tgen.llama_decode_model(tm, 4, 32), device="cpu", max_prompt_len=24,
                      name="robust-llama", **FAST) as eng:
        first = [eng.submit(p, max_new_tokens=n) for p in prompts]
        unbroken = [r.result(timeout=60).tolist() for r in first]
        programs = eng.stats()["programs"]
        chaos.arm("serving.decode.loop", exc=RuntimeError("die"),
                  at=chaos.visits("serving.decode.loop") + 3)
        reqs = [eng.submit(p, max_new_tokens=n) for p in prompts]
        assert _results(reqs) == [None] * 3
        for r, want in zip(reqs, unbroken):
            had = r.tokens_so_far()
            assert 0 < len(had) < n and had == want[:len(had)]
            assert isinstance(r._error, batching.SchedulerRestarted) and r._error.status_code == 2
        retried = [eng.generate(p, max_new_tokens=n, timeout=60).tolist() for p in prompts]
        st, h = eng.stats(), eng.health()
    assert retried == unbroken
    assert retried[1] == jgen.llama_generate(jm, prompts[1], max_new_tokens=n)[0, 11:].tolist()
    assert st["scheduler_restarts"] == 1 and st["retired"]["error"] == 3
    assert st["programs"] == programs and st["compiles"] == len(programs)
    assert st["active"] == 0 and h["free_slots"] == 4 and h["scheduler_alive"]


def test_wedged_decode_scheduler_is_restarted():
    """A step wedged at ``serving.decode.step`` (outside the exec lock):
    the watchdog restarts the scheduler, the running sequence fails, the
    queued one is served bitwise by the replacement, and the superseded
    thread ends at its next program call (``stale_unwinds``), no step
    applied after its generation ended."""
    model = torch_toy_model()
    want = [solo(model, p, 6, max_slots=1).tolist() for p in PROMPTS[:2]]
    with make_engine(model, max_slots=1, **FAST) as eng:
        eng.generate(PROMPTS[0], max_new_tokens=2, timeout=60)
        steps = eng.stats()["steps"]
        chaos.arm("serving.decode.step", delay=WEDGE_S,
                  at=chaos.visits("serving.decode.step") + 3)
        a = eng.submit(PROMPTS[0], max_new_tokens=6)
        wait_tokens(a, 2)
        b = eng.submit(PROMPTS[1], max_new_tokens=6)  # queued behind a's slot
        got = _results([a, b])
        wait_until(lambda: eng.stats()["stale_unwinds"] == 1)  # it wakes in its step call
        st = eng.stats()
    assert got[0] is None and got[1] == want[1] and a.tokens_so_far() == want[0][:2]
    assert st["scheduler_restarts"] == 1 and st["stale_unwinds"] == 1
    assert st["steps"] == steps + 2 + 6 and st["tokens"] == 2 + 2 + 6


def _cache_pages(eng):
    return {pid for _, pages, _ in eng._prefix._entries.values() for pid in pages}


@pytest.mark.parametrize("site", ["serving.decode.loop", "serving.decode.prefill"])
def test_restart_sweep_keeps_the_prefix_cache_pages(site):
    """The port's case of the reference's refcount sweep (its
    test_prefix_spec.py:243): streams sharing a cached two-page prefix and
    a cold three-chunk prompt are in flight when the scheduler dies
    (``loop``), or when the cold joiner wedges between its first and
    second fill chunk, its pages not yet published (``prefill``); after
    the restart no slot leaks, every live page is the cache's (none freed
    twice: a double drop raises), and the retried streams hit and equal
    their cold tokens."""
    model = torch_toy_model()
    prompts = [np.arange(5, 25, dtype=np.int32)]
    prompts += [prompt_with(s) for s in ([21, 22], [23, 24, 25], [26])]
    cold = [solo(model, p, 6, prefix=False).tolist() for p in prompts]
    with make_engine(model, **FAST) as eng:
        eng.generate(prompt_with([30]), max_new_tokens=2, timeout=60)  # caches the prefix
        hits = eng.stats()["prefix"]["hits"]
        if site == "serving.decode.loop":
            chaos.arm(site, exc=RuntimeError("die"), at=chaos.visits(site) + 2)
        else:
            chaos.arm(site, delay=WEDGE_S, at=chaos.visits(site) + 2)
        got = _results([eng.submit(p, max_new_tokens=6) for p in prompts])
        if site == "serving.decode.prefill":  # it wakes before its second chunk
            wait_until(lambda: eng.stats()["stale_unwinds"] == 1)
        st, h = eng.stats(), eng.health()
        assert st["scheduler_restarts"] == 1 and got[0] is None
        assert h["free_slots"] == eng.max_slots and st["active"] == 0
        assert st["live_pages"] == len(_cache_pages(eng)) >= 2
        retried = [eng.generate(p, max_new_tokens=6, timeout=60).tolist() for p in prompts]
        st = eng.stats()
        assert st["prefix"]["hits"] >= hits + 3
        assert st["live_pages"] == len(_cache_pages(eng))
    assert retried == cold
    assert all(g is None or g == c for g, c in zip(got, cold))


def test_restart_mid_speculative_burst_keeps_plain_greedy():
    """The draft's step wedges inside a burst (the exec lock held): the
    watchdog restarts the scheduler, the opted streams fail, and the
    superseded thread ends at its next program call; the retried streams,
    opted again, equal plain greedy. The wedge is the first draft step
    after a burst was applied, chosen by the scheduler's own thread: a
    burst gives at most k tokens, so every stream is still running then
    (armed from the test's thread, a loaded CPU could let every stream
    finish first)."""
    model = spec_model()
    plain = [solo(model, p, 10, prefix=False).tolist() for p in PROMPTS]
    draft_step = model.draft.step_fn
    wedged = []

    def slow_draft_step(*args):
        if not wedged and eng.stats()["spec"]["iterations"] > 0:
            wedged.append(True)
            time.sleep(WEDGE_S)
        return draft_step(*args)

    model.draft.step_fn = slow_draft_step
    try:
        with make_engine(model, spec_k=4, prefix=False, **FAST) as eng:
            eng.warmup()
            reqs = [eng.submit(p, max_new_tokens=10, speculative=True) for p in PROMPTS]
            got = _results(reqs)
            wait_until(lambda: eng.stats()["stale_unwinds"] == 1)
            st = eng.stats()
            assert wedged and st["scheduler_restarts"] == 1 and st["stale_unwinds"] == 1
            assert st["spec"]["iterations"] > 0 and None in got
            retried = [eng.generate(p, max_new_tokens=10, speculative=True,
                                    timeout=60).tolist() for p in PROMPTS]
            assert all(v["compiles"] == 1 for v in eng.stats()["programs"].values())
    finally:
        model.draft.step_fn = draft_step
    assert retried == plain
    assert all(g is None or g == p for g, p in zip(got, plain))
