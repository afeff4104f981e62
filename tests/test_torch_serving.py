"""The port's serving stack (paddle_tpu_torch/inference: PredictorServer over
BatchingEngine.for_callable) serving the small port BERT on the CPU.
Clients speak the wire protocol through the JAX package's
``paddle_tpu.inference.wire_spec``, the protocol's source of truth; the
replies are held against the JAX BertModel within 1e-4."""
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import wire_spec as ref_spec
from paddle_tpu.text.models import BertModel as JaxBert
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.inference import wire_spec
from paddle_tpu_torch.inference.batching import (BatchingEngine, DeadlineExceeded,
                                                  EngineClosed, EngineOverloaded,
                                                  bucket_rows)
from paddle_tpu_torch.inference.server import PredictorServer
from paddle_tpu_torch.text.models import BertModel

torch.set_num_threads(1)

SMOKE = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=256)
SEQ = 32
TOL = 1e-4


def _recv(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("server closed")
        buf += chunk
    return buf


def _call(port, frame):
    """Send one raw request frame; returns (status, payload)."""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(frame)
        (blen,) = struct.unpack("<I", _recv(s, 4))
        body = _recv(s, blen)
    return body[0], body[1:]


def _infer(port, arrays, tail=b""):
    return _call(port, ref_spec.build_request(
        ref_spec.CMD_INFER, ref_spec.encode_arrays(arrays) + tail))


def _ids(rows, seed):
    return np.random.RandomState(seed).randint(0, SMOKE["vocab_size"],
                                               (rows, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def bert():
    paddle.seed(0)
    jm = JaxBert(**SMOKE)
    jm.eval()
    tm = BertModel(**SMOKE, device="cpu")
    tm.eval()
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})

    def run(ids):
        with torch.inference_mode():
            return list(tm(torch.tensor(ids)))

    def reference(ids):
        seq, pooled = jm(paddle.to_tensor(ids))
        return np.asarray(seq.numpy()), np.asarray(pooled.numpy())

    return run, reference


@pytest.fixture(scope="module")
def server(bert):
    run, _ = bert
    engine = BatchingEngine.for_callable(run, max_batch_size=8, max_wait_ms=200.0)
    assert engine.warmup(signature=[("int32", (SEQ,))]) == [1, 2, 4, 8]
    srv = PredictorServer(run, engine=engine, own_engine=True)
    yield srv, engine
    srv.stop()


def test_replies_match_jax_bert(server, bert):
    srv, _ = server
    _, reference = bert
    for rows, seed in [(1, 0), (3, 1)]:
        ids = _ids(rows, seed)
        status, payload = _infer(srv.port, [ids])
        assert status == ref_spec.STATUS_OK
        seq, pooled = ref_spec.decode_arrays(payload)
        js, jp = reference(ids)
        assert seq.shape == (rows, SEQ, SMOKE["hidden_size"]) and seq.dtype == np.float32
        np.testing.assert_allclose(seq, js, rtol=0, atol=TOL)
        np.testing.assert_allclose(pooled, jp, rtol=0, atol=TOL)


def test_concurrent_one_row_requests_coalesce(server, bert):
    srv, engine = server
    _, reference = bert
    before = engine.stats()
    n = 6
    ids = [_ids(1, 100 + i) for i in range(n)]
    replies = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait()
        replies[i] = _infer(srv.port, [ids[i]])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    after = engine.stats()
    for i, (status, payload) in enumerate(replies):
        assert status == ref_spec.STATUS_OK
        seq, pooled = ref_spec.decode_arrays(payload)
        assert seq.shape[0] == 1 and pooled.shape[0] == 1  # padding sliced off
        np.testing.assert_allclose(seq, reference(ids[i])[0], rtol=0, atol=TOL)

    def total(stats, key):
        return sum(d[key] for ds in stats["buckets"].values() for d in ds)

    d_batches = total(after, "batches") - total(before, "batches")
    d_requests = total(after, "requests") - total(before, "requests")
    assert d_requests == n
    assert d_batches < d_requests  # coalesced
    assert total(after, "rows") - total(before, "rows") == n
    assert total(after, "padded_rows") >= total(before, "padded_rows")


def test_coalesced_multi_row_requests_are_bitwise_their_direct_calls(server, bert):
    """The reference's determinism contract (paddle_tpu/inference/
    batching.py:88-99) for requests of >= 2 rows, held for the callable
    engine on the CPU: a 2-row and a 3-row request coalesced into one
    batch (bucket 8, padded) give exactly the bits of the callable's
    direct call on each request alone. (On the card the engine cannot fix
    the M of the caller's direct call, whose cuBLAS kernel may differ: the
    loaded-program path holds the contract by slabs instead.)"""
    _, engine = server
    run, _ = bert
    reqs = [_ids(2, 300), _ids(3, 301)]
    before = engine.stats()
    replies = [None, None]
    barrier = threading.Barrier(2)

    def client(i):
        barrier.wait()
        replies[i] = engine.infer([reqs[i]], timeout=60)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    after = engine.stats()

    def total(stats, key):
        return sum(d[key] for ds in stats["buckets"].values() for d in ds)

    assert total(after, "requests") - total(before, "requests") == 2
    assert total(after, "batches") - total(before, "batches") == 1  # coalesced
    for ids, got in zip(reqs, replies):
        want = [o.numpy() for o in run(ids)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_health_and_stats_commands(server):
    srv, _ = server
    status, body = _call(srv.port, ref_spec.build_request(ref_spec.CMD_HEALTH))
    assert status == ref_spec.STATUS_OK
    health = json.loads(body)
    assert health["ok"] and health["engine"]["scheduler_alive"]
    status, body = _call(srv.port, ref_spec.build_request(ref_spec.CMD_STATS))
    assert status == ref_spec.STATUS_OK
    stats = json.loads(body)
    assert stats["max_batch_size"] == 8 and stats["declared_buckets"] == [1, 2, 4, 8]
    for ds in stats["buckets"].values():
        for d in ds:
            assert {"batches", "requests", "padded_rows"} <= set(d)


# cmd 4 (reload) answers 1 on a server without a model loader, as the
# reference's does; cmd 8 (drain) is served (tests/test_torch_serve_model.py)
@pytest.mark.parametrize("cmd", [ref_spec.CMD_RELOAD, 2,
                                 ref_spec.CMD_KV_PUT,
                                 ref_spec.CMD_KV_RESUME, 99])
def test_unserved_commands_answer_status_1(server, cmd):
    srv, _ = server
    status, _ = _call(srv.port, struct.pack("<IB", 1, cmd))
    assert status == ref_spec.STATUS_ERROR


def test_bad_requests_answer_status_1(server):
    srv, _ = server
    # a streaming decode request: no decode engine in this slice
    status, _ = _infer(srv.port, [_ids(1, 0)], ref_spec.encode_decode_opts(4))
    assert status == ref_spec.STATUS_ERROR
    # a body that is not an array block
    status, _ = _call(srv.port, ref_spec.build_request(ref_spec.CMD_INFER, b"\x01\x09"))
    assert status == ref_spec.STATUS_ERROR
    # a shape the model cannot take (its signature has no warm bucket, and
    # the model rejects it): an error, never a hang
    status, _ = _infer(srv.port, [np.zeros((1, SEQ, 2), np.float32)])
    assert status == ref_spec.STATUS_ERROR


def test_spent_deadline_answers_status_2_and_trailing_fields_parse(server):
    srv, _ = server
    status, _ = _infer(srv.port, [_ids(1, 0)], ref_spec.encode_deadline(0.0))
    assert status == ref_spec.STATUS_RETRYABLE
    tail = (ref_spec.encode_trace(7) + ref_spec.encode_tenant(3)
            + ref_spec.encode_deadline(60_000.0))
    status, payload = _infer(srv.port, [_ids(1, 0)], tail)
    assert status == ref_spec.STATUS_OK
    assert ref_spec.decode_arrays(payload)[0].shape == (1, SEQ, SMOKE["hidden_size"])


def test_overload_sheds_with_status_2():
    entered, release = threading.Event(), threading.Event()

    def slow(x):
        entered.set()
        assert release.wait(30)
        return x * 2

    engine = BatchingEngine.for_callable(slow, max_batch_size=1, max_wait_ms=0.0,
                                         max_queue=1)
    srv = PredictorServer(slow, engine=engine, own_engine=True)
    replies = {}
    x = np.arange(4, dtype=np.float32).reshape(1, 4)
    try:
        ta = threading.Thread(target=lambda: replies.setdefault("a", _infer(srv.port, [x])))
        ta.start()
        assert entered.wait(30)  # the scheduler is busy with request a
        tb = threading.Thread(target=lambda: replies.setdefault("b", _infer(srv.port, [x])))
        tb.start()
        t_end = time.monotonic() + 30
        while engine.stats()["queue_depth"] < 1:  # b holds the only slot
            assert time.monotonic() < t_end
            time.sleep(0.005)
        status, _ = _infer(srv.port, [x])
        assert status == ref_spec.STATUS_RETRYABLE
        assert engine.stats()["shed_count"] == 1
    finally:
        release.set()
        for t in (ta, tb):
            t.join(30)
        srv.stop()
    for key in ("a", "b"):
        status, payload = replies[key]
        assert status == ref_spec.STATUS_OK
        np.testing.assert_array_equal(ref_spec.decode_arrays(payload)[0], x * 2)


def test_stop_command_stops_the_server():
    engine = BatchingEngine.for_callable(lambda x: x, max_batch_size=2)
    srv = PredictorServer(lambda x: x, engine=engine, own_engine=True)
    status, _ = _call(srv.port, ref_spec.build_request(ref_spec.CMD_STOP))
    assert status == ref_spec.STATUS_OK
    srv._thread.join(10)
    assert not srv._thread.is_alive()
    with pytest.raises(OSError):
        _call(srv.port, ref_spec.build_request(ref_spec.CMD_HEALTH))
    t_end = time.monotonic() + 10
    while not engine.health()["closed"]:
        assert time.monotonic() < t_end
        time.sleep(0.01)
    with pytest.raises(EngineClosed):
        engine.infer([np.zeros((1, 2), np.float32)])


def test_server_without_engine_runs_the_callable():
    srv = PredictorServer(lambda x: torch.tensor(x) + 1)
    try:
        x = np.ones((2, 3), np.float32)
        status, payload = _infer(srv.port, [x])
        assert status == ref_spec.STATUS_OK
        np.testing.assert_array_equal(ref_spec.decode_arrays(payload)[0], x + 1)
        status, body = _call(srv.port, ref_spec.build_request(ref_spec.CMD_STATS))
        # the reference's body: no engine, the replica's phase
        assert json.loads(body) == {"engine": None, "phase": "both"}
    finally:
        srv.stop()


def test_wire_spec_copy_equals_the_reference():
    for name in ("DTYPES", "COMMANDS", "STATUSES", "MARKERS", "FIELD_SIZE",
                 "NUMPY_BY_CODE", "CODE_BY_NUMPY", "WIDEN_TO_F32", "SPEC_VERSION",
                 "DECODE_ONESHOT_BIT", "DECODE_HANDOFF_BIT", "DECODE_SPEC_BIT"):
        assert getattr(wire_spec, name) == getattr(ref_spec, name), name
    for name in dir(ref_spec):
        if name.startswith(("CMD_", "STATUS_")) or name.endswith("_MARKER"):
            assert getattr(wire_spec, name) == getattr(ref_spec, name), name
    arrays = [np.arange(6, dtype=np.int64).reshape(2, 3),
              np.ones((1,), np.bool_), np.zeros((2, 0, 4), np.float32),
              np.arange(3, dtype=np.float16)]
    blob = ref_spec.encode_arrays(arrays)
    assert wire_spec.encode_arrays(arrays) == blob
    tail = ref_spec.encode_deadline(12.5) + ref_spec.encode_trace(9) \
        + ref_spec.encode_tenant(4) + ref_spec.encode_decode_opts(5, oneshot=True)
    got, want = wire_spec.decode_request(blob + tail), ref_spec.decode_request(blob + tail)
    assert got[1:] == want[1:]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        wire_spec.encode_arrays([np.zeros(2, np.float64)])
    assert wire_spec.build_request(3) == ref_spec.build_request(3)
    assert wire_spec.build_reply(2, b"x") == ref_spec.build_reply(2, b"x")


@pytest.mark.parametrize("n,cap,want", [(1, 8, 1), (2, 8, 2), (3, 8, 4), (5, 8, 8),
                                        (8, 8, 8), (9, 8, 8), (3, 6, 4), (5, 6, 6)])
def test_bucket_rows(n, cap, want):
    assert bucket_rows(n, cap) == want


def test_oversized_request_splits_and_rejoins_in_order():
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return x + 1

    with BatchingEngine.for_callable(fn, max_batch_size=4, max_wait_ms=0.0) as engine:
        x = np.arange(11 * 2, dtype=np.float32).reshape(11, 2)
        (out,) = engine.infer([x], timeout=30)
        np.testing.assert_array_equal(out, x + 1)
        # chunks of 4, 4 and 3 rows; the 3-row tail pads to its bucket of 4
        assert sorted(seen) == [4, 4, 4]
        with pytest.raises(ValueError):
            engine.infer([x[:2], x[:3]])


def test_expired_deadline_is_dropped_before_dispatch():
    with BatchingEngine.for_callable(lambda x: x, max_batch_size=2) as engine:
        with pytest.raises(DeadlineExceeded):
            engine.infer([np.zeros((1, 2), np.float32)], deadline=time.monotonic() - 1)
        assert engine.stats()["deadline_expired"] == 1
        with pytest.raises(EngineOverloaded):
            BatchingEngine.for_callable(lambda x: x, max_queue=0).infer(
                [np.zeros((1, 2), np.float32)])
