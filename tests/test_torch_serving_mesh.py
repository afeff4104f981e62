"""Meshed serving against the JAX package: inference/sharding.py (the
descriptor, the placement rule, ShardedWeight), the engines' ``mesh``
(BatchingEngine.for_layer, DecodeEngine), ``jit.save(mesh=)``,
``serve_model(mesh=)``, the launcher-rank backing, and obs/ledger.py.

The reference's meshed engines need several jax devices and the tier-1
parent has one, so they run in a subprocess with a forced host device
count (tests/torch_serving_mesh_worker.py ``reference``). The port's
meshes run here over ``mesh_devices=["cpu"] * n``, and over two launcher
ranks (gloo) in the worker's ``rank`` mode. f32 replies are held to
``SHARDED_FLOAT_TOL`` (a column block is another GEMM shape, so tp is
not promised bitwise; whether it was is printed); integer and bool
replies, and decode solo-vs-batch under one mesh, are held bitwise.
"""
import json
import os
import socket
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from paddle_tpu.inference import sharding as jsharding  # noqa: E402
from paddle_tpu.obs import ledger as jledger  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.core import place as tplace  # noqa: E402
from paddle_tpu_torch.inference import sharding  # noqa: E402
from paddle_tpu_torch.inference import wire_spec as ws  # noqa: E402
from paddle_tpu_torch.inference.batching import BatchingEngine  # noqa: E402
from paddle_tpu_torch.inference.decode import DecodeEngine, SnapshotRefused  # noqa: E402
from paddle_tpu_torch.inference.server import serve_model  # noqa: E402
from paddle_tpu_torch.obs import ledger  # noqa: E402
from paddle_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from paddle_tpu_torch.obs import prometheus, tracing  # noqa: E402
from paddle_tpu_torch.ops.quant_matmul import wmatmul  # noqa: E402
from paddle_tpu_torch.static import InputSpec  # noqa: E402
from paddle_tpu_torch.text import generation as tgen  # noqa: E402
from paddle_tpu_torch.text import models as tmodels  # noqa: E402

from test_torch_decode import torch_toy_model  # noqa: E402
import torch_dist_worker as W  # noqa: E402

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_serving_mesh_worker.py")
TOL = sharding.SHARDED_FLOAT_TOL
MESHED = ("tp2", "fsdp2xtp2")
DTYPES = ("f32", "i32", "i64", "bool")
NUMPY = {"f32": np.float32, "i32": np.int32, "i64": np.int64, "bool": np.bool_}
TORCH = {"f32": "float32", "i32": "int32", "i64": "int64", "bool": "bool"}
ROWS = (2, 3, 5)  # 5 splits into 4 + a 1-row tail padded to bucket 2


def cpus(mesh):
    return None if mesh in (None, "single") else ["cpu"] * sharding.ServingMesh.parse(mesh).n_shards


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def request_inputs():
    """The reference contract's requests (sharded_worker.run_contract):
    rows 2, 3, 5 of each wire dtype from RandomState(3)."""
    rng = np.random.RandomState(3)
    out = {}
    for name in DTYPES:
        for i, rows in enumerate(ROWS):
            if name == "f32":
                a = rng.randn(rows, 8).astype(np.float32)
            elif name == "bool":
                a = rng.rand(rows, 8) > 0.5
            else:
                a = rng.randint(-9, 9, (rows, 8)).astype(NUMPY[name])
            out[f"{name}_{i}"] = a
    return out


# -------------------------------------------------------------- descriptor
DESCRIPTORS = [None, "", "single", "tp2", "TP4", " fsdp2 ", "fsdp2xtp2", "mp4", "fsdp2xtp4"]
BAD = ["bogus", "tp0", "tp", "fsdp0", "tp2xfsdp2", "dp2", "tp2x", "f32", "nope"]
SHAPES = [(), (32,), (17,), (16, 32), (7, 32), (16, 9), (7, 9), (4, 5, 8), (30522, 768)]


def _spec(ref_spec, shape):
    """The reference's PartitionSpec as the port's tuple: one entry a dim."""
    t = tuple(ref_spec)
    return t + (None,) * (len(shape) - len(t))


@pytest.mark.parametrize("spec", DESCRIPTORS)
def test_descriptor_and_placement_rule_match_the_reference(spec):
    mine, ref = sharding.ServingMesh.parse(spec), jsharding.ServingMesh.parse(spec)
    assert (mine.descriptor, mine.is_single, mine.n_shards, mine.fsdp, mine.tp) == (
        ref.descriptor, ref.is_single, ref.n_shards, ref.fsdp, ref.tp)
    assert sharding.ServingMesh.parse(mine) is mine
    again = sharding.ServingMesh.parse(mine.descriptor)
    assert again == mine and hash(again) == hash(mine) and repr(again) == repr(mine)
    for shape in SHAPES:
        assert mine.param_spec(shape) == _spec(ref.param_spec(shape), shape), shape
        assert mine.shard_fraction(shape) == ref.shard_fraction(shape), shape
    arrays = [np.zeros(s, np.float32) for s in SHAPES[:-1]] + [np.zeros((4, 6), np.int8)]
    assert mine.per_shard_bytes(arrays) == ref.per_shard_bytes(arrays)
    assert mine.per_shard_bytes([torch.from_numpy(a) for a in arrays]) == \
        ref.per_shard_bytes(arrays)


@pytest.mark.parametrize("bad", BAD)
def test_bad_descriptors_raise_in_both_packages(bad):
    with pytest.raises(ValueError):
        jsharding.ServingMesh.parse(bad)
    with pytest.raises(ValueError):
        sharding.ServingMesh.parse(bad)


def test_resolve_reads_the_argument_then_the_environment(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_SERVING_MESH", raising=False)
    assert sharding.resolve(None).is_single and jsharding.resolve(None).is_single
    monkeypatch.setenv("PADDLE_TPU_SERVING_MESH", "mp2")
    assert sharding.resolve(None).descriptor == jsharding.resolve(None).descriptor == "tp2"
    assert sharding.resolve("fsdp2").descriptor == jsharding.resolve("fsdp2").descriptor
    assert sharding.SHARDED_FLOAT_TOL == jsharding.SHARDED_FLOAT_TOL
    assert sharding.SINGLE == jsharding.SINGLE


def test_check_nr_devices_gates_skew():
    with pytest.raises(ValueError, match="mesh skew"):
        sharding.check_nr_devices(4, None)
    sharding.check_nr_devices(4, "tp4")
    sharding.check_nr_devices("fsdp2xtp2", "tp4")
    sharding.check_nr_devices(None, "tp2")  # nothing recorded
    with pytest.raises(ValueError, match="mesh skew"):
        sharding.check_nr_devices("tp2", sharding.ServingMesh.parse("fsdp2xtp2"))


def test_build_fails_fast_and_never_picks_the_cpu():
    # no card here: the default device list cannot be met, and nothing
    # falls back to the CPU or to the single mesh
    with pytest.raises(ValueError, match="device"):
        sharding.ServingMesh.parse("tp2").build()
    with pytest.raises(ValueError, match="needs 2 devices"):
        sharding.ServingMesh.parse("tp2").build(["cpu"] * 3)
    with pytest.raises(ValueError, match="single"):
        sharding.ServingMesh.parse(None).build(["cpu"])
    placement = sharding.ServingMesh.parse("fsdp2xtp2").build(["cpu"] * 4)
    assert not placement.ranks and placement.describe() == ["cpu"] * 4


def test_rank_backing_takes_the_current_place_and_never_the_cpu(monkeypatch):
    """In a job of the mesh's size, with no device list, the rank backing
    serves on the current place: with no card and no set_device("cpu") it
    raises before it builds a group; on the CPU only when asked."""
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import topology

    class Groups:
        def rank_in(self, axis):
            return 0

    built = []
    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(topology, "build_mesh", lambda **axes: built.append(axes) or Groups())
    prev = tplace._CURRENT
    try:
        tplace._CURRENT = tplace.CUDAPlace(0)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            sharding.ServingMesh.parse("tp2").build()
        assert built == []
        tp.set_device("cpu")
        placement = sharding.ServingMesh.parse("tp2").build()
        assert placement.ranks and placement.first == torch.device("cpu")
        assert built == [{"sharding": 1, "mp": 2}]
    finally:
        tplace._CURRENT = prev


@pytest.mark.parametrize("mesh", ["tp2", "fsdp2", "fsdp2xtp2", "tp4"])
@pytest.mark.parametrize("shape", [(16, 24), (12, 8), (7, 8), (16, 9)])
def test_sharded_weight_products_rows_and_joins(mesh, shape):
    m = sharding.ServingMesh.parse(mesh)
    placement = m.build(cpus(mesh))
    rng = np.random.RandomState(sum(shape))
    w = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    sw = placement.shard(w)
    if not any(m.param_spec(shape)):
        assert isinstance(sw, torch.Tensor) and torch.equal(sw, w)
        return
    assert isinstance(sw, sharding.ShardedWeight) and sw.shape == w.shape
    assert torch.equal(sw.joined(), w)
    idx = torch.from_numpy(rng.randint(0, shape[0], (3, 5)))
    assert torch.equal(sw[idx], w[idx]) and torch.equal(sw.rows(idx), w[idx])
    x = torch.from_numpy(rng.randn(3, 4, shape[0]).astype(np.float32))
    want = x @ w
    for got in (sw.matmul(x), x @ sw, torch.matmul(x, sw), wmatmul(x, sw)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= TOL * max(1.0, float(want.abs().max()))
    with pytest.raises(TypeError):
        torch.add(x, sw)
    # the block a shard holds is its slice
    f_split, t_split = (a is not None for a in (m.param_spec(shape)[0], m.param_spec(shape)[-1]))
    blk = sw.blocks[(0, 0)]
    assert blk.shape == (shape[0] // (m.fsdp if f_split else 1),
                         shape[1] // (m.tp if t_split else 1))
    assert m.per_shard_bytes([w]) == blk.numel() * 4


# ------------------------------------------------------- save, serve, fail
class _MLP(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(8, 16)
        self.fc2 = tnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(tnn.functional.relu(self.fc1(x)))


class _IntOps(tnn.Layer):
    def forward(self, x):
        return x * 3 + 1


class _BoolOps(tnn.Layer):
    def forward(self, x):
        return tp.logical_not(x)


def _save(model, path, dtype="float32", mesh=None):
    tjit.save(model.eval(), path, input_spec=[InputSpec([None, 8], dtype)], mesh=mesh)
    return path


def _mlp_save(tmp_path, name="m", mesh=None, weights=None):
    tp.seed(0)
    m = _MLP()
    if weights is not None:
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(torch.from_numpy(weights[n]))
    return _save(m, str(tmp_path / name), mesh=mesh)


def test_save_records_the_mesh_and_load_exposes_it(tmp_path):
    prefix = _mlp_save(tmp_path, "a", mesh="mp2")
    assert json.load(open(prefix + ".pdmeta.json"))["mesh"] == "tp2"  # canonical
    assert tjit.load(prefix, device="cpu")._serving_mesh == "tp2"
    plain = _mlp_save(tmp_path, "b")
    assert json.load(open(plain + ".pdmeta.json"))["mesh"] is None
    assert tjit.load(plain, device="cpu")._serving_mesh is None
    with pytest.raises(ValueError):
        _mlp_save(tmp_path, "c", mesh="nope")


def test_serve_model_fails_fast(tmp_path):
    """The reference's TestFailFast: a typo'd mesh fails at entry, before
    the load; a recorded mesh that differs from the declared one, a
    sharded mesh without the batching engine, and an engine whose mesh
    has too few devices all raise."""
    with pytest.raises(ValueError, match="descriptor"):
        serve_model(str(tmp_path / "nonexistent"), mesh="bogus", device="cpu")
    prefix = _mlp_save(tmp_path, mesh="tp2")
    with pytest.raises(ValueError, match="serving mesh"):
        serve_model(prefix, dynamic_batching=True, mesh="single", device="cpu")
    with pytest.raises(ValueError, match="dynamic_batching"):
        serve_model(prefix, device="cpu")  # the save's recorded mesh, no engine
    with pytest.raises(ValueError, match="device"):
        serve_model(prefix, dynamic_batching=True, device="cpu", watchdog_interval=0)
    with pytest.raises(ValueError, match="device"):
        BatchingEngine.for_layer(tjit.load(prefix, device="cpu"), mesh="tp2")
    with pytest.raises(ValueError, match="mesh skew"):
        BatchingEngine.for_layer(tjit.load(prefix, device="cpu"), mesh="fsdp2xtp2",
                                 mesh_devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="device"):
        DecodeEngine(torch_toy_model(hidden=8, vocab=16), device="cpu", mesh="tp2",
                     watchdog_interval=0)


def test_hot_reload_cannot_flip_the_mesh(tmp_path):
    """A reload whose save records another mesh than the one pinned at the
    first load is refused, and the server keeps serving the old engine."""
    prefix_a = _mlp_save(tmp_path, "a")
    prefix_b = _mlp_save(tmp_path, "b", mesh="tp2")
    server = serve_model(prefix_a, dynamic_batching=True, warmup=False, watchdog_interval=0,
                         device="cpu")
    try:
        with pytest.raises(ValueError, match="serving mesh"):
            server.reload(prefix_b)
        out = server._engine.infer([np.ones((2, 8), np.float32)], timeout=60)
        assert out[0].shape == (2, 4) and server._engine.stats()["mesh"] == "single"
    finally:
        server.stop(drain=False)


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


@pytest.mark.parametrize("mesh", MESHED)
def test_wire_replies_and_views_report_the_mesh(tmp_path, mesh):
    """serve_model(mesh=) on the wire: cmd-1 replies sit within the
    tolerance of the single engine's, cmd-3 health and cmd-5 stats name
    the mesh, and a reload of another save keeps it."""
    prefix = _mlp_save(tmp_path, mesh=mesh)
    rng = np.random.RandomState(5)
    xs = [rng.randn(rows, 8).astype(np.float32) for rows in (2, 4, 3)]
    with BatchingEngine.for_layer(tjit.load(prefix, device="cpu"), mesh=mesh,
                                  mesh_devices=cpus(mesh), max_batch_size=4,
                                  watchdog_interval=0) as eng:
        eng.warmup()
        meshed = [eng.infer([x], timeout=60)[0] for x in xs]
    single = tjit.load(prefix, device="cpu")  # the direct call, whole weights
    server = serve_model(prefix, dynamic_batching=True, max_batch_size=4, device="cpu",
                         mesh_devices=cpus(mesh), watchdog_interval=0)
    try:
        for x, want in zip(xs, meshed):
            st, body = _call(server.port, ws.build_request(ws.CMD_INFER, ws.encode_arrays([x])))
            got = ws.decode_arrays(body)[0]
            assert st == 0 and np.array_equal(got, want)  # the meshed engine's bytes
            direct = single(x).numpy()
            assert np.abs(got - direct).max() <= TOL * max(1.0, np.abs(direct).max())
        health = json.loads(_call(server.port, ws.build_request(ws.CMD_HEALTH))[1])
        stats = json.loads(_call(server.port, ws.build_request(ws.CMD_STATS))[1])
        assert health["engine"]["mesh"] == stats["mesh"] == mesh
        server.reload(_mlp_save(tmp_path, "again", mesh=mesh))
        stats = json.loads(_call(server.port, ws.build_request(ws.CMD_STATS))[1])
        assert stats["mesh"] == mesh
    finally:
        server.stop(drain=False)


# --------------------------------------------- the batching contract (4 dtypes)
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's engines over the four toy models (module
    docstring): their replies per mesh, the MLP's weights, ledger events."""
    d = tmp_path_factory.mktemp("mesh_ref")
    np.savez(d / "inputs.npz", **request_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in ("PADDLE_TPU_ARTIFACT_DIR", "PADDLE_TPU_SERVING_MESH", "PADDLE_TPU_SERVING_QUANT"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, WORKER, "reference", str(d / "ref"),
                        str(d / "inputs.npz")], capture_output=True, text=True, timeout=600,
                       env=env, cwd=os.path.dirname(HERE))
    assert r.returncode == 0, r.stderr[-4000:]
    arrays = dict(np.load(d / "ref.npz"))
    with open(d / "ref.json") as f:
        record = json.load(f)
    weights = {n: arrays.pop(f"w_{n}") for n in record["weight_names"]}
    return dict(arrays=arrays, record=record, weights=weights, dir=d)


@pytest.fixture(scope="module")
def port_contract(reference, tmp_path_factory):
    """The port's engines over twins of the four toy models (the MLP with
    the reference's weights), each mesh on ``["cpu"] * n``: the replies,
    the stats' mesh, a live exposition and the ledger's serving events."""
    d = tmp_path_factory.mktemp("mesh_port")
    prefixes = {"f32": _mlp_save(d, "m-f32", weights=reference["weights"])}
    for name in ("i32", "i64"):
        prefixes[name] = _save(_IntOps(), str(d / f"m-{name}"), TORCH[name])
    prefixes["bool"] = _save(_BoolOps(), str(d / "m-bool"), "bool")
    inputs = request_inputs()
    out = dict(replies={}, stats={}, events={}, prefixes=prefixes, inputs=inputs)
    for mesh in ("single",) + MESHED:
        ledger.LEDGER.reset()
        for name in DTYPES:
            with BatchingEngine.for_layer(tjit.load(prefixes[name], device="cpu"), mesh=mesh,
                                          mesh_devices=cpus(mesh), max_batch_size=4,
                                          watchdog_interval=0, name=f"{mesh}-{name}") as eng:
                eng.warmup()
                for i in range(len(ROWS)):
                    out["replies"][f"{mesh}_{name}_{i}"] = eng.infer(
                        [inputs[f"{name}_{i}"]], timeout=60)[0]
                out["stats"][f"{mesh}_{name}"] = (eng.stats()["mesh"], eng.health()["mesh"])
                if name == "f32":
                    out[f"exposition_{mesh}"] = prometheus.render(obs_metrics.REGISTRY)
        out["events"][mesh] = ledger.LEDGER.events("serving/")
    return out


@pytest.mark.parametrize("mesh", MESHED)
def test_integer_and_bool_replies_are_bitwise(port_contract, reference, mesh):
    for name in ("i32", "i64", "bool"):
        for i in range(len(ROWS)):
            got = port_contract["replies"][f"{mesh}_{name}_{i}"]
            single = port_contract["replies"][f"single_{name}_{i}"]
            ref = reference["arrays"][f"{mesh}_{name}_{i}"]
            assert got.dtype == single.dtype and got.tobytes() == single.tobytes()
            assert np.array_equal(got, ref), (name, i)
        assert port_contract["stats"][f"{mesh}_{name}"] == (mesh, mesh)
        assert reference["record"]["stats_mesh"][f"{mesh}_{name}"] == mesh


@pytest.mark.parametrize("mesh", MESHED)
def test_f32_replies_within_tolerance_of_single_and_reference(port_contract, reference, mesh):
    bitwise = []
    for i in range(len(ROWS)):
        got = port_contract["replies"][f"{mesh}_f32_{i}"]
        for want in (port_contract["replies"][f"single_f32_{i}"],
                     reference["arrays"][f"{mesh}_f32_{i}"],
                     reference["arrays"][f"single_f32_{i}"]):
            assert got.shape == want.shape and got.dtype == np.float32
            assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())
        bitwise.append(got.tobytes() == port_contract["replies"][f"single_f32_{i}"].tobytes())
    print(f"{mesh} f32 replies bitwise the single engine's: {bitwise}")


@pytest.mark.parametrize("mesh", MESHED)
def test_metrics_carry_the_mesh_const_label(port_contract, mesh):
    lines = [line for line in port_contract[f"exposition_{mesh}"].splitlines()
             if line.startswith("paddle_serving_compiles_total")
             and f'engine="{mesh}-f32"' in line]
    assert lines and all(f'mesh="{mesh}"' in line for line in lines)


@pytest.mark.parametrize("mesh", ("single",) + MESHED)
def test_ledger_bucket_events_match_the_reference(port_contract, reference, mesh):
    """The same engine work gives the reference's ledger keys, kinds,
    buckets and tags: one ``serving/bucket{b}`` event a warmed bucket,
    ``mesh`` where the mesh is not single, no ``quant`` for f32."""
    fields = ("key", "kind", "bucket", "phase", "mesh", "quant")
    mine = [{k: e.get(k) for k in fields} for e in port_contract["events"][mesh]]
    assert mine == reference["record"]["serving"][mesh]
    tags = {e.get("mesh") for e in port_contract["events"][mesh]}
    assert tags == ({None} if mesh == "single" else {mesh})
    for e in port_contract["events"][mesh]:
        assert e["n_ops"] == sum(e["op_counts"].values()) and len(e["fingerprint"]) == 16


def test_ledger_shape_matches_the_reference(port_contract, reference):
    """``events``/``totals`` have the reference's keys, less the XLA cost
    analysis's (flops, bytes_accessed, typed_op_counts in an event)."""
    mine = port_contract["events"]["tp2"][0]
    assert set(reference["record"]["event_keys"]) - set(mine) == {
        "flops", "bytes_accessed", "typed_op_counts"}
    assert set(mine) <= set(reference["record"]["event_keys"])
    assert sorted(ledger.LEDGER.totals()) == reference["record"]["totals_keys"]
    # the sharded program's products are the pass's, the single's ATen's
    assert "sharded_matmul" in mine["op_counts"]
    single = port_contract["events"]["single"][0]
    assert "sharded_matmul" not in single["op_counts"] and "aten.matmul.default" in \
        single["op_counts"]


def test_compile_ledger_records_like_the_reference():
    mine, ref = ledger.CompileLedger(cap=3), jledger.CompileLedger(cap=3)
    g = torch.fx.symbolic_trace(torch.nn.Linear(2, 3)).graph
    for i in range(5):
        a = mine.record(f"serving/bucket{i}", duration_s=0.25, kind="aot",
                        extra={"bucket": i, "mesh": "tp2"}, graph=g if i else None)
        b = ref.record(f"serving/bucket{i}", duration_s=0.25, kind="aot",
                       extra={"bucket": i, "mesh": "tp2"})
        assert {k: v for k, v in a.items() if k in b and k != "ts"} == \
            {k: v for k, v in b.items() if k != "ts"}
    assert [e["key"] for e in mine.events()] == [e["key"] for e in ref.events()] == [
        "serving/bucket2", "serving/bucket3", "serving/bucket4"]
    assert len(mine.events("serving/bucket4")) == 1
    t = mine.totals()
    assert sorted(t) == sorted(ref.totals()) and t["compiles"] == 3
    assert t["n_ops"] == 3 * a["n_ops"] and a["fingerprint"] == mine.events()[0]["fingerprint"]
    assert any(r["name"] == "compile:serving/bucket4" for r in tracing.summary_rows())
    text = prometheus.render(obs_metrics.REGISTRY)
    assert 'paddle_compile_events_total{kind="aot"}' in text
    assert "paddle_compile_seconds_bucket" in text
    mine.reset()
    assert mine.events() == [] and mine.totals()["compiles"] == 0


# -------------------------------------------------------------------- decode
LLAMA = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
PROMPTS = [np.random.RandomState(s).randint(0, 128, (n,)).astype(np.int32)
           for s, n in ((0, 5), (1, 8), (2, 11))]
NEW = 8
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def llama():
    torch.manual_seed(0)
    return tmodels.LlamaModel(**LLAMA, device="cpu").eval()


def _engine(llama, mesh, name, slots=4):
    return DecodeEngine(tgen.llama_decode_model(llama, slots, 32), device="cpu", mesh=mesh,
                        mesh_devices=cpus(mesh), watchdog_interval=0, name=name)


def _near_tie(dm, prompt, got, want):
    """The first position where two greedy streams part is a near-tie of
    the single mesh's logits there."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            logits = tgen.llama_prompt_logits(dm, np.concatenate([prompt, want[:i]]))
            return abs(float(logits[a] - logits[b])) <= NEAR_TIE * float(logits.abs().max())
    return True


def test_meshed_decode_solo_equals_batch_and_the_single_mesh(llama):
    ledger.LEDGER.reset()
    with _engine(llama, None, "single") as eng:
        single = [eng.generate(p, max_new_tokens=NEW, timeout=60) for p in PROMPTS]
    solos = []
    for i, p in enumerate(PROMPTS):
        with _engine(llama, "tp2", f"solo{i}") as eng:
            solos.append(eng.generate(p, max_new_tokens=NEW, timeout=60))
    with _engine(llama, "tp2", "batch") as eng:
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        batch = [r.result(timeout=60) for r in reqs]
        assert eng.stats()["mesh"] == eng.health()["mesh"] == "tp2"
    for s, b in zip(solos, batch):
        assert s.tolist() == b.tolist()
    dm = tgen.llama_decode_model(llama, 4, 32)
    for p, s, w in zip(PROMPTS, solos, single):
        assert s.tolist() == w.tolist() or _near_tie(dm, p, s.tolist(), w.tolist())
    # the whole streams, teacher-forced on the single mesh's tokens: tp2's
    # logits at every position within the tolerance, its top token the
    # single mesh's or a near-tie
    meshed = sharding.shard_decode_model(dm, sharding.ServingMesh.parse("tp2").build(cpus("tp2")))
    for p, w in zip(PROMPTS, single):
        ids = np.concatenate([p, w[:-1]])
        want = tgen.llama_sequence_logits(dm, ids, p.size - 1)
        got = tgen.llama_sequence_logits(meshed, ids, p.size - 1)
        assert got.shape == (NEW, LLAMA["vocab_size"])
        for i, (lt, ls) in enumerate(zip(got, want)):
            top = float(ls.abs().max())
            assert float((lt - ls).abs().max()) <= TOL * top, i
            a = int(lt.argmax())
            assert a == int(w[i]) or abs(float(ls[a] - ls[int(w[i])])) <= NEAR_TIE * top, i
    events = ledger.LEDGER.events("decode/")
    assert {e.get("mesh") for e in events} == {None, "tp2"}
    assert all(e["kind"] == "eager" and e["key"] == f"decode/{e['phase']}{e['bucket']}x"
               f"{e['seq']}" for e in events)


def test_meshed_decode_tags_like_the_reference(reference):
    """The reference's toy decoder under tp2 and the port's twin: the same
    tokens, the stats' mesh, and ledger events keyed
    ``decode/{phase}{rows}x{seq}`` and tagged with the mesh (the programs
    differ by design: the port fills in chunks and steps at max_seq_len)."""
    ledger.LEDGER.reset()
    with DecodeEngine(torch_toy_model(hidden=32, vocab=64, seed=0), max_slots=4,
                      max_seq_len=32, device="cpu", mesh="tp2", mesh_devices=["cpu"] * 2,
                      watchdog_interval=0, name="toy-tp2") as eng:
        out = eng.generate(np.array([3, 1, 4, 1, 5], np.int32), max_new_tokens=6, timeout=60)
        assert eng.stats()["mesh"] == reference["record"]["decode_stats_mesh"] == "tp2"
    assert out.tolist() == reference["arrays"]["decode_tp2"].tolist()
    mine, ref = ledger.LEDGER.events("decode/"), reference["record"]["decode"]
    assert {e["mesh"] for e in ref} == {e["mesh"] for e in mine} == {"tp2"}
    assert {e["quant"] for e in ref} == {e.get("quant") for e in mine} == {None}
    for e in ref + mine:
        assert e["key"] == f"decode/{e['phase']}{e['bucket']}x{e['key'].rsplit('x', 1)[1]}"
    assert "step" in {e["phase"] for e in ref} & {e["phase"] for e in mine}


@pytest.mark.parametrize("mesh", ["tp2", "mp2", "fsdp2", "fsdp2xtp2"])
def test_every_descriptor_serves_both_engines(tmp_path, mesh):
    """The four descriptors the entry points take: the toy decoder's
    tokens are the single mesh's, and a saved MLP's replies sit within
    the tolerance of its direct call, with the canonical descriptor in
    the stats."""
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    canonical = sharding.ServingMesh.parse(mesh).descriptor
    outs = {}
    for m in (None, mesh):
        with DecodeEngine(torch_toy_model(hidden=32, vocab=64, seed=0), max_slots=4,
                          max_seq_len=32, device="cpu", mesh=m, mesh_devices=cpus(m),
                          watchdog_interval=0, name=f"every-{m}") as eng:
            outs[m] = eng.generate(prompt, max_new_tokens=8, timeout=60).tolist()
            assert eng.stats()["mesh"] == (canonical if m else "single")
    assert outs[mesh] == outs[None]
    prefix = _mlp_save(tmp_path, mesh=mesh)
    x = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    want = tjit.load(prefix, device="cpu")(x).numpy()
    server = serve_model(prefix, dynamic_batching=True, max_batch_size=4, device="cpu",
                         mesh=mesh, mesh_devices=cpus(mesh), watchdog_interval=0)
    try:
        got = server._engine.infer([x], timeout=60)[0]
        assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())
        assert server._engine.stats()["mesh"] == canonical
    finally:
        server.stop(drain=False)


def test_snapshots_are_refused_across_meshes(llama):
    with _engine(llama, None, "snap-single") as single, \
            _engine(llama, "tp2", "snap-tp2") as meshed:
        blobs, unbroken = {}, {}
        for name, eng in (("single", single), ("tp2", meshed)):
            req = eng.submit(PROMPTS[1], max_new_tokens=8, snapshot_every=3)
            unbroken[name] = req.result(timeout=60).tolist()
            blobs[name] = bytes(req.latest_snapshot())
        assert ws.decode_kv_snapshot_off(blobs["tp2"])[0]["mesh"] == "tp2"
        with pytest.raises(SnapshotRefused, match="mesh 'single' != 'tp2'"):
            meshed.check_snapshot(blobs["single"])
        with pytest.raises(SnapshotRefused, match="mesh 'tp2' != 'single'"):
            single.check_snapshot(blobs["tp2"])
        # a snapshot of its own mesh resumes to the unbroken tokens
        assert ws.decode_kv_snapshot_off(blobs["tp2"])[0]["n_generated"] == 6
        assert meshed.resume(blobs["tp2"]).result(timeout=60).tolist() == unbroken["tp2"]


def test_meshed_decode_refuses_what_it_does_not_serve(llama):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(tgen.llama_decode_model(llama, 4, 32), device="cpu", mesh="tp2",
                     mesh_devices=["cpu"] * 2, quant="w8", watchdog_interval=0)
    with pytest.raises(ValueError, match="first device"):
        DecodeEngine(tgen.llama_decode_model(llama, 4, 32), device="cpu", mesh="tp2",
                     mesh_devices=["meta", "cpu"], watchdog_interval=0)


# --------------------------------------------------------------------- ranks
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=16)


@pytest.mark.parametrize("mesh", MESHED)
def test_launcher_ranks_reply_as_the_single_engine(reference, tmp_path, mesh):
    """Backing (b): the ranks of a launcher job of the mesh's size (gloo)
    each hold their own blocks and serve the same requests in lockstep:
    the reference's MLP (tp2) and a 2-layer BERT (its embedding rows,
    fused QKV, biases and norms read joined). Rank 0's replies are the
    single engine's within the tolerance (bitwise printed)."""
    tp.seed(0)
    bert = tmodels.BertModel(**BERT, device="cpu").eval()
    tjit.save(bert, str(tmp_path / "bert"), input_spec=[InputSpec([None, 8], "int32")])
    prefixes = [str(tmp_path / "bert")]
    rng = np.random.RandomState(7)
    inputs = {f"0_{i}": rng.randint(0, BERT["vocab_size"], (rows, 8)).astype(np.int32)
              for i, rows in enumerate((2, 3))}
    if mesh == "tp2":
        prefixes.append(_mlp_save(tmp_path, "ranks", weights=reference["weights"]))
        inputs.update({f"1_{k}": v for k, v in request_inputs().items() if k.startswith("f32")})
    np.savez(tmp_path / "inputs.npz", **inputs)
    single = {}
    for j, prefix in enumerate(prefixes):
        with BatchingEngine.for_layer(tjit.load(prefix, device="cpu"), max_batch_size=4,
                                      watchdog_interval=0, name=f"ranks-single{j}") as eng:
            eng.warmup()
            for k in sorted(k for k in inputs if k.startswith(f"{j}_")):
                for i, o in enumerate(eng.infer([inputs[k]], timeout=60)):
                    single[f"{k}_{i}"] = o
    out = tmp_path / "out"
    out.mkdir()
    n = sharding.ServingMesh.parse(mesh).n_shards
    rc, text = W.run_ranks("rank", str(out), mesh, str(tmp_path / "inputs.npz"), *prefixes,
                           nproc=n, worker=WORKER)
    assert rc == 0, text[-4000:]
    rec = json.load(open(out / "rank0.json"))
    assert rec["world"] == n
    # before set_device("cpu") the rank's place is the card, which is not there
    assert "no CUDA card" in (rec["no_card"] or ""), rec["no_card"]
    for prog in rec["programs"]:
        assert prog["mesh"] == mesh and "rank f0 t0" in prog["devices"]
        # a rank holds one block of each weight the rule splits
        assert {tuple(b) for b in prog["blocks"]} <= {("ShardedWeight", 1), ("Tensor", 0),
                                                     ("Parameter", 0)}
        assert ["ShardedWeight", 1] in prog["blocks"]
    got = dict(np.load(out / "rank0.npz"))
    assert sorted(got) == sorted(single)
    bitwise = []
    for k, want in single.items():
        assert np.abs(got[k] - want).max() <= TOL * max(1.0, np.abs(want).max()), k
        bitwise.append(got[k].tobytes() == want.tobytes())
    print(f"rank 0's {mesh} replies bitwise the single engine's: {bitwise}")
