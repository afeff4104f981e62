"""The port's telemetry (paddle_tpu_torch/obs) against the JAX package's
(paddle_tpu/obs), on the CPU.

- Exposition: the same sequence of instrument operations, on a registry
  of each package, renders byte-identical Prometheus text (escaping,
  float formatting, histogram triplets, merged families, collectors).
- Tracing: spans, observations, the summary table and the trace-id
  filter keep the reference's schema.
- ``MetricsServer`` serves the registry's text at /metrics.
- The decode engine's instruments equal the JAX engine's in family name,
  type, label names, const labels and bucket bounds, and for the same
  traffic its counts of requests, tokens, first tokens, gaps,
  retirements by reason and sheds equal the JAX engine's.
- The server answers cmd 6 with the decode, batching and server
  families, and a 0x1D trace id yields the reference's span names under
  that id (one ``serving.decode.token`` span per token).
"""
import socket
import struct
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.inference import wire_spec as ref_spec
from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.obs import metrics as ref_metrics
from paddle_tpu.obs import prometheus as ref_prometheus
from paddle_tpu.obs import tracing as ref_tracing
from paddle_tpu.resilience import chaos as ref_chaos
from paddle_tpu_torch import obs
from paddle_tpu_torch.inference.batching import BatchingEngine
from paddle_tpu_torch.inference.server import PredictorServer
from paddle_tpu_torch.obs import metrics, prometheus, tracing
from paddle_tpu_torch.resilience import chaos

from decode_worker import toy_decode_model
from test_torch_decode import HID, PROMPTS, VOCAB, make_engine, torch_toy_model

torch.set_num_threads(1)


# ------------------------------------------------------------- exposition
def _drive(M, registry):
    """One fixed script of instrument operations against module ``M``
    (the port's or the reference's obs.metrics) and ``registry``."""
    c = registry.counter("app_requests_total", "Requests served\nsecond line \\ end",
                         ("route", "code"))
    c.inc(route="/a", code="200")
    c.inc(2.5, route='/b"quoted"', code="500")
    c.inc(route="new\nline\\", code="200")
    g = registry.gauge("app_queue_depth", "Queue depth")
    g.set(-3.25)
    g.inc(0.5)
    registry.gauge("app_untouched", "")  # no labels, no samples: one 0 sample
    h = registry.histogram("app_latency_seconds", "Latency", ("phase",),
                           buckets=M.log_buckets(0.0001, 4.0, 10))
    for v in (0.00005, 0.0001, 0.003, 1.0, 7.5, 1e6):
        h.observe(v, phase="step")
    h.observe(0.25, phase="fill")
    h2 = registry.histogram("app_ratio", "Ratio", buckets=(0.0, 0.25, 0.5, 1.0, float("inf")))
    for v in (0.0, 0.3, 1.0, 2.0):
        h2.observe(v)
    big = registry.counter("app_big_total", "Large and tiny values")
    big.inc(1e20)
    big.inc(1e-7)
    # standalone instruments behind collectors, two "engines" contributing
    # to one family (merged under one header, same-key samples summed)
    for name in ("e1", "e2"):
        own = M.Counter("app_engine_tokens_total", "Tokens", ("kind",),
                        const_labels={"engine": name, "mesh": "single"})
        own.inc(3, kind="plain")
        own.inc(1, kind="spec")
        registry.register_collector(lambda own=own: [own.collect()])
    dup = M.Counter("app_engine_tokens_total", "Tokens", ("kind",),
                    const_labels={"engine": "e1", "mesh": "single"})
    dup.inc(10, kind="plain")
    registry.register_collector(lambda: [dup.collect()])
    assert registry.counter("app_requests_total", "", ("route", "code")) is c
    with pytest.raises(ValueError):
        registry.gauge("app_requests_total")
    with pytest.raises(ValueError):
        registry.counter("bad name")
    with pytest.raises(ValueError):
        c.inc(-1, route="/a", code="200")
    return c, h


def test_render_is_byte_identical_to_the_reference():
    ours, theirs = metrics.Registry(), ref_metrics.Registry()
    c, h = _drive(metrics, ours)
    rc, rh = _drive(ref_metrics, theirs)
    text = prometheus.render(ours)
    assert text == ref_prometheus.render(theirs)
    assert text.count("# TYPE app_engine_tokens_total counter") == 1
    assert 'app_engine_tokens_total{engine="e1",kind="plain",mesh="single"} 13' in text
    assert ours.snapshot() == theirs.snapshot()
    assert h.value(phase="step") == rh.value(phase="step")
    assert c.value(route="/a", code="200") == rc.value(route="/a", code="200") == 1.0
    assert prometheus.CONTENT_TYPE == ref_prometheus.CONTENT_TYPE
    assert metrics.log_buckets() == ref_metrics.log_buckets()


@pytest.mark.parametrize("value", [0.0, 1.0, -2.0, 0.1, 1e-7, 123456789.0, 1e15, 2.5e16,
                                   float("inf"), float("-inf"), 3.0000000000000004])
def test_float_formatting_equals_the_reference(value):
    assert metrics._format_float(value) == ref_metrics._format_float(value)


def test_dead_collector_unregisters_and_empty_registry_renders_nothing():
    for M, P in ((metrics, prometheus), (ref_metrics, ref_prometheus)):
        reg = M.Registry()
        assert P.render(reg) == ""
        calls = []
        reg.register_collector(lambda: calls.append(1))  # returns None: dead
        assert P.render(reg) == "" and calls == [1]
        assert P.render(reg) == "" and calls == [1]


# ---------------------------------------------------------------- tracing
@pytest.fixture
def clean_spans():
    tracing.reset()
    yield
    tracing.reset()


def test_spans_keep_the_reference_schema(clean_spans):
    tid = tracing.new_trace_id()
    assert 0 < tid < 2 ** 64 and tracing.format_trace_id(255) == "00000000000000ff"
    with tracing.trace(tid):
        assert tracing.current_trace_id() == tid
        with tracing.span("a.outer", note=1) as sp:
            inner = tracing.start_span("a.inner")
        inner.finish(extra=2)
        inner.finish()  # idempotent
    assert tracing.current_trace_id() is None
    tracing.record_span("a.recorded", 0.25, trace_id=tid, rows=3)
    tracing.observe("a.recorded", 0.75)
    tracing.record_span("a.other", 0.5, trace_id=7)
    spans = tracing.finished(trace_id=tid)
    assert [s["name"] for s in spans] == ["a.outer", "a.inner", "a.recorded"]
    assert set(spans[0]) == set(ref_tracing.Span("x").as_dict())
    assert spans[1]["attrs"] == {"extra": 2} and spans[0]["attrs"] == sp.attrs == {"note": 1}
    assert tracing.finished(name="a.other")[0]["trace_id"] == 7
    rows = {r["name"]: r for r in tracing.summary_rows()}
    assert rows["a.recorded"]["calls"] == 2 and rows["a.recorded"]["total"] == 1.0
    assert set(rows["a.recorded"]) == {"name", "calls", "total", "avg", "max", "min"}
    tracing.reset()
    assert tracing.finished() == [] and tracing.summary_rows() == []


def test_metrics_server_serves_the_registry():
    reg = metrics.Registry()
    reg.counter("app_hits_total", "Hits").inc(4)
    with obs.MetricsServer(registry=reg) as srv:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"] == prometheus.CONTENT_TYPE
        assert body == prometheus.render(reg)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nothing", timeout=30)


# ------------------------------------------------- the decode engine's metrics
def _schema(eng):
    return [(m.name, m.kind, m.labelnames, sorted(m.const_labels),
             {k: v for k, v in m.const_labels.items() if k != "engine"},
             getattr(m, "buckets", None), m.help if m.name != "paddle_decode_compiles_total"
             else None) for m in eng._instruments]


def _counts(eng):
    m = eng._m_retired
    return {
        "requests": eng._m_requests.value(), "tokens": eng._m_tokens.value(),
        "first_tokens": eng._m_ttft.value()["count"],
        "gaps": eng._m_intertoken.value()["count"],
        "retired": {r: m.value(reason=r) for r in ("eos", "max_tokens", "max_seq_len",
                                                   "deadline", "error", "cancelled")},
        "shed": {r: eng._m_shed.value(reason=r) for r in ("queue_full", "quarantine")},
    }


def _traffic(eng, hit):
    """Requests that retire by max_tokens and max_seq_len, then a queue
    shed: the scheduler is held in the ``loop`` site (``hit`` arms the
    engine's own chaos module) while a request waits and one more
    arrives."""
    outs = [eng.generate(p, max_new_tokens=n, timeout=120).tolist()
            for p, n in ((PROMPTS[0], 6), (PROMPTS[1], 40), (PROMPTS[2], 3))]
    hit()
    first = eng.submit(PROMPTS[0], max_new_tokens=2)
    deadline = time.monotonic() + 30
    while eng.stats()["queue_depth"]:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    waiting = eng.submit(PROMPTS[2], max_new_tokens=2)
    with pytest.raises(Exception) as shed:
        eng.submit(PROMPTS[1], max_new_tokens=2)
    outs += [first.result(timeout=120).tolist(), waiting.result(timeout=120).tolist()]
    return outs, type(shed.value).__name__


def test_decode_metrics_equal_the_jax_engine():
    ours = make_engine(torch_toy_model(), max_queue=1, prefix=False, name="obs-port")
    theirs = JaxEngine(toy_decode_model(hidden=HID, vocab=VOCAB, seed=0), max_slots=4,
                       max_seq_len=32, min_seq_bucket=8, max_queue=1, watchdog_interval=0,
                       prefix=False, name="obs-jax")
    try:
        assert _schema(ours) == _schema(theirs)
        for mod in (chaos, ref_chaos):
            mod.reset()
        got = _traffic(ours, lambda: chaos.arm(
            "serving.decode.loop", delay=0.5, at=chaos.visits("serving.decode.loop") + 1))
        want = _traffic(theirs, lambda: ref_chaos.arm(
            "serving.decode.loop", delay=0.5, at=ref_chaos.visits("serving.decode.loop") + 1))
        assert got == want and got[1] == "EngineOverloaded"
        assert _counts(ours) == _counts(theirs)
        st = ours.stats()
        assert st["shed_count"] == 1 and st["retired"]["max_seq_len"] == 1
        # the program calls, by phase, against the stats view
        assert ours._m_steps.value(phase="fill") == st["prefix_fill_steps"]
        assert ours._m_step_exec.value(phase="step")["count"] == st["steps"]
        assert ours._m_compiles.value(phase="step", source="inline") == 1 == sum(
            v["compiles"] for k, v in st["programs"].items() if k.startswith("step"))
    finally:
        ours.close()
        theirs.close()
        for mod in (chaos, ref_chaos):
            mod.reset()
    assert ours._obs_collector not in metrics.REGISTRY._collectors


# ------------------------------------------------------- cmd 6 and 0x1D
def _recv(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("server closed")
        buf += chunk
    return buf


def _frames(port, frame):
    """Send one frame; -> [(status, payload)] up to the terminal frame."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(frame)
        while True:
            (blen,) = struct.unpack("<I", _recv(s, 4))
            body = _recv(s, blen)
            out.append((body[0], body[1:]))
            if body[0] != ref_spec.STATUS_STREAM:
                return out


def _decode_frame(prompt, n, trace_id=None):
    tail = b"" if trace_id is None else ref_spec.encode_trace(trace_id)
    return ref_spec.build_request(ref_spec.CMD_INFER, ref_spec.encode_arrays([prompt]) + tail
                                  + ref_spec.encode_decode_opts(n))


def test_cmd6_and_wire_trace_ids(clean_spans):
    batch = BatchingEngine.for_callable(lambda x: [x * 2], max_batch_size=4, max_wait_ms=1.0,
                                        name="obs-batch")
    dec = make_engine(torch_toy_model(), name="obs-decode")
    srv = PredictorServer(None, engine=batch, own_engine=True, decode_engine=dec,
                          own_decode_engine=True)
    try:
        tid = 0x1234ABCD
        traced = _frames(srv.port, _decode_frame(PROMPTS[1], 7, trace_id=tid))
        plain = _frames(srv.port, _decode_frame(PROMPTS[0], 5))
        assert [st for st, _ in traced][-1] == [st for st, _ in plain][-1] == ref_spec.STATUS_OK
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        (st, body), = _frames(srv.port, ref_spec.build_request(
            ref_spec.CMD_INFER, ref_spec.encode_arrays([x]) + ref_spec.encode_trace(tid + 1)))
        assert st == ref_spec.STATUS_OK and np.array_equal(ref_spec.decode_arrays(body)[0],
                                                           x * 2)
        (st, text), = _frames(srv.port, ref_spec.build_request(ref_spec.CMD_METRICS))
        text = text.decode()
        assert st == ref_spec.STATUS_OK
        for family in ("paddle_decode_tokens_total", "paddle_decode_ttft_seconds",
                       "paddle_serving_requests_total", "paddle_serving_batch_exec_seconds",
                       "paddle_server_frames_total", "paddle_server_connections_open"):
            assert f"# TYPE {family} " in text, family
        assert 'paddle_decode_tokens_total{engine="obs-decode"} 12' in text
        assert f'paddle_server_frames_total{{cmd="1",port="{srv.port}"}} 3' in text
        assert f'paddle_server_responses_total{{port="{srv.port}",status="0"}} 3' in text
        tokens = tracing.finished(trace_id=tid, name="serving.decode.token")
        assert [s["attrs"]["index"] for s in tokens] == list(range(7))
        assert [s["attrs"]["first"] for s in tokens] == [True] + [False] * 6
        # the first stream paid for the programs' builds: its compile spans
        names = {s["name"] for s in tracing.finished(trace_id=tid)}
        assert names == {"serving.decode.token", "serving.decode.request", "serving.reply",
                         "serving.decode.compile"}
        assert {s["name"] for s in tracing.finished(trace_id=tid + 1)} == {
            "serving.request", "serving.queue", "serving.execute", "serving.reply"}
        # the untraced stream left no span, only the summary table
        assert all(s["trace_id"] in (tid, tid + 1) for s in tracing.finished())
        rows = {r["name"]: r["calls"] for r in tracing.summary_rows()}
        assert rows["serving.decode.step"] >= 11 and rows["serving.decode.fill"] == 3
    finally:
        srv.stop()
    # stop() closed both engines and the server: their families are gone
    # (the fleet router's paddle_decode_resume* families are module-level,
    # as in the reference, and stay once inference/router.py is imported)
    text = obs.render()
    assert not any(line.startswith(("paddle_decode_", "# TYPE paddle_decode_"))
                   and "resume" not in line for line in text.splitlines())
    assert "paddle_server_" not in text
    assert 'engine="obs-decode"' not in text and 'engine="obs-batch"' not in text
    assert batch.health()["closed"] and dec.health()["closed"]
