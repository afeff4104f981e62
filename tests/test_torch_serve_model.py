"""serve_model over the wire on the CPU: the port's server against the
reference's for cmds 1 (infer), 3 (health), 4 (reload), 5 (stats) and 8
(drain): the same status codes and JSON keys for the same requests, on a
model both packages save with the same weights (a Linear net, which both
export batch-polymorphic). Then the port's own: a hot reload under load
drops nothing and every reply is bitwise one model's Predictor.run, a
declared quant mode refuses an f32 save at load and at reload, drain
admits no new request (status 2, the port's documented difference), and
the knobs the port does not serve raise."""
import json
import socket
import struct
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.inference.server import serve_model as ref_serve
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.inference import wire_spec as ws
from paddle_tpu_torch.inference.server import serve_model
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.text.models import BertModel

torch.set_num_threads(1)

SEQ = 16
TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _call(port, frame):
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(frame)
        (n,) = struct.unpack("<I", s.recv(4, socket.MSG_WAITALL))
        body = b""
        while len(body) < n:
            chunk = s.recv(n - len(body))
            if not chunk:
                raise ConnectionError("closed")
            body += chunk
    return body[0], body[1:]


def _infer(port, arrays):
    return _call(port, ws.build_request(ws.CMD_INFER, ws.encode_arrays(arrays)))


def net(pkg):
    class Net(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pkg.nn.Linear(8, 3)

        def forward(self, x):
            return self.fc(x)

    return Net()


@pytest.fixture(scope="module")
def linear_saves(tmp_path_factory):
    d = tmp_path_factory.mktemp("wire")
    jp.seed(1)
    jm = net(jp)
    jm.eval()
    tm = net(tp).eval()
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    ref, port = str(d / "ref"), str(d / "port")
    jp.jit.save(jm, ref, input_spec=[jp.static.InputSpec([None, 8], "float32")])
    tjit.save(tm, port, input_spec=[InputSpec([None, 8], "float32")])
    return ref, port


def _session(srv):
    """cmds 1, 3, 5, 4, 8 (with a budget), 1 again, 8 undrain -> a list of
    (cmd, status, JSON body or decoded arrays)."""
    x = np.linspace(-1, 1, 16, dtype=np.float32).reshape(2, 8)
    out = []
    st, body = _infer(srv.port, [x])
    out.append(("infer", st, ws.decode_arrays(body)[0]))
    for name, cmd in (("health", ws.CMD_HEALTH), ("stats", ws.CMD_STATS)):
        st, body = _call(srv.port, ws.build_request(cmd))
        out.append((name, st, json.loads(body)))
    st, body = _call(srv.port, ws.build_request(ws.CMD_RELOAD))
    out.append(("reload", st, json.loads(body)))
    st, body = _call(srv.port, ws.build_request(ws.CMD_RELOAD, b"/nowhere/model"))
    out.append(("reload missing", st, None))
    st, body = _call(srv.port, ws.build_request(ws.CMD_DRAIN, struct.pack("<d", 5.0)))
    out.append(("drain", st, json.loads(body)))
    st, body = _infer(srv.port, [x])
    out.append(("infer draining", st, None))
    st, body = _call(srv.port, ws.build_request(ws.CMD_DRAIN, struct.pack("<d", -1.0)))
    out.append(("undrain", st, json.loads(body)))
    return out


def test_wire_statuses_and_json_keys_match_the_reference(linear_saves):
    ref, port = linear_saves
    sessions = {}
    for name, serve, path in (("ref", ref_serve, ref), ("port", serve_model, port)):
        srv = serve(path, dynamic_batching=True, max_batch_size=4)
        try:
            sessions[name] = _session(srv)
        finally:
            srv.stop()
    for (label, st_r, body_r), (_, st_p, body_p) in zip(sessions["ref"], sessions["port"]):
        if label == "infer draining":
            # the reference keeps serving new requests while it drains; the
            # port admits none (status 2: retry another replica)
            assert (st_r, st_p) == (ws.STATUS_OK, ws.STATUS_RETRYABLE)
            continue
        assert st_r == st_p, label
        if label == "infer":
            np.testing.assert_allclose(body_p, body_r, rtol=0, atol=1e-6)
        elif body_r is not None:
            assert set(body_p) == set(body_r), label
            if body_r.get("engine") and label != "stats":
                assert set(body_p["engine"]) == set(body_r["engine"]), label
    by = {lab: body for lab, _, body in sessions["port"]}
    assert by["drain"]["draining"] and not by["drain"]["accepting"]
    assert 0 < by["drain"]["draining_deadline_s"] <= 5.0
    assert by["undrain"]["accepting"] and not by["undrain"]["draining"]
    assert by["reload"]["reloaded"] and by["reload"]["reloads"] == 1
    assert by["reload"]["warm_buckets"] == [1, 2, 4]
    assert by["stats"]["phase"] == "both" and by["stats"]["quant"] == "f32"


@pytest.fixture(scope="module")
def bert_saves(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert")
    paths = []
    for seed in (0, 1):
        m = BertModel(**TINY, device="cpu", generator=torch.Generator().manual_seed(seed)).eval()
        paths.append(str(d / f"p{seed}"))
        tjit.save(m, paths[-1], input_spec=[InputSpec([None, SEQ], "int32")])
    w8 = BertModel(**TINY, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    paths.append(str(d / "w8"))
    tjit.save(w8, paths[-1], input_spec=[InputSpec([None, SEQ], "int32")], quant="w8")
    return paths


def _predictor(path):
    cfg = tinf.Config(path)
    cfg.disable_gpu()
    return tinf.create_predictor(cfg)


def test_hot_reload_under_load_drops_nothing(bert_saves):
    p1, p2, _ = bert_saves
    preds = [_predictor(p) for p in (p1, p2)]
    srv = serve_model(p1, dynamic_batching=True, max_batch_size=8, max_wait_ms=5.0)
    rng = np.random.RandomState(3)
    work = [rng.randint(0, 128, (2, SEQ)).astype(np.int32) for _ in range(4)]
    want = [[p.run([ids]) for p in preds] for ids in work]
    stop = threading.Event()
    tally = [dict(p1=0, p2=0, other=0) for _ in work]

    def sender(i):
        while not stop.is_set():
            st, body = _infer(srv.port, [work[i]])
            outs = ws.decode_arrays(body) if st == 0 else None
            key = "other"
            for name, w in zip(("p1", "p2"), want[i]):
                if outs is not None and all(np.array_equal(a, b) for a, b in zip(outs, w)):
                    key = name
            tally[i][key] += 1

    threads = [threading.Thread(target=sender, args=(i,)) for i in range(len(work))]
    try:
        for t in threads:
            t.start()
        while sum(d["p1"] for d in tally) < 8:
            threading.Event().wait(0.01)
        st, body = _call(srv.port, ws.build_request(ws.CMD_RELOAD, p2.encode()))
        assert st == ws.STATUS_OK and json.loads(body)["prefix"] == p2
        n = sum(d["p2"] for d in tally)
        while sum(d["p2"] for d in tally) < n + 8:
            threading.Event().wait(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join()
        srv.stop()
    assert sum(d["other"] for d in tally) == 0, tally
    assert srv.last_reload_s["load"] > 0 and srv.last_reload_s["warm"] > 0


def test_declared_quant_refuses_an_f32_save_at_load_and_reload(bert_saves, monkeypatch):
    p1, _, w8 = bert_saves
    with pytest.raises(ValueError, match="quant mode 'f32'"):
        serve_model(p1, quant="w8", dynamic_batching=True)
    with pytest.raises(ValueError, match="unknown quant mode"):
        serve_model(w8, quant="int8")
    monkeypatch.setenv("PADDLE_TPU_SERVING_QUANT", "w8")
    srv = serve_model(w8, dynamic_batching=True, max_batch_size=4)  # the environment's mode
    try:
        ids = np.zeros((2, SEQ), np.int32)
        assert _infer(srv.port, [ids])[0] == ws.STATUS_OK
        st, body = _call(srv.port, ws.build_request(ws.CMD_RELOAD, p1.encode()))
        assert st == ws.STATUS_ERROR and b"does not match" in body
        assert _infer(srv.port, [ids])[0] == ws.STATUS_OK  # the old model still serves
        stats = json.loads(_call(srv.port, ws.build_request(ws.CMD_STATS))[1])
        assert stats["quant"] == "w8"
    finally:
        srv.stop()


def test_direct_serving_and_the_unserved_knobs(bert_saves):
    p1, _, _ = bert_saves
    srv = serve_model(p1)  # no engine: the loaded layer answers directly
    try:
        ids = np.random.RandomState(4).randint(0, 128, (3, SEQ)).astype(np.int32)
        st, body = _infer(srv.port, [ids])
        want = _predictor(p1).run([ids])
        assert st == 0 and all(np.array_equal(a, b) for a, b in
                               zip(ws.decode_arrays(body), want))
        assert json.loads(_call(srv.port, ws.build_request(ws.CMD_STATS))[1])["engine"] is None
    finally:
        srv.stop()
    # a sharded mesh needs the batching engine (tests/test_torch_serving_mesh.py)
    with pytest.raises(ValueError, match="mesh 'tp2' needs the batching engine"):
        serve_model(p1, mesh="tp2")
    srv = serve_model(p1, phase="prefill")  # a pool of a disaggregated fleet
    try:
        health = json.loads(_call(srv.port, ws.build_request(ws.CMD_HEALTH))[1])
        assert health["phase"] == "prefill" and health["accepting"]
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="phase"):
        serve_model(p1, phase="prefil")
    with pytest.raises(FileNotFoundError):
        serve_model("/nowhere/model")
