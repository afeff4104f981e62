"""The port's fleet tier (paddle_tpu_torch/inference/router.py,
registry.py, fleet.py, obs/goodput.py's ServingGoodput) against the
reference's (paddle_tpu/inference/...), on the CPU.

Everything is bitwise: the router and the registry decide and relay
bytes. Held equal to the reference for the same inputs: ``tenant_id``
and the wire's tenant field, the fair gate's grant order for a scripted
arrival sequence (driven by the grants themselves, not by sleeping),
``Autoscaler.decide`` over a grid, ``ServingGoodput.report``, the
registry's state sequence under scripted health replies, and the
router's request splitting. Over in-process replicas: shed-aware retry
on another replica, a dead replica ejected and routed around, every
replica gone answering status 2, a drain with zero drops (and the race
of the port's refusing drain), the ``fleet.route`` chaos site shedding,
tenant accounting in the serving ledger. Across the packages: the
port's router in front of the reference's replicas gives the client the
bytes the reference's router gives, and the reference's router in front
of the port's replicas the bytes the port's gives. The supervisor
respawns a dead replica, in-process and as a subprocess_spawner process
killed by SIGKILL.
"""
import json
import signal
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.inference import fleet as rfleet
from paddle_tpu.inference import registry as rreg
from paddle_tpu.inference import router as rrouter
from paddle_tpu.inference import wire_spec as rws
from paddle_tpu.inference.batching import RetryableError as RefRetryable
from paddle_tpu.inference.server import PredictorServer as RefServer
from paddle_tpu.obs import goodput as rgood
from paddle_tpu.resilience import chaos as rchaos
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference import registry as treg
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import wire_spec as ws
from paddle_tpu_torch.inference.batching import RetryableError
from paddle_tpu_torch.inference.server import PredictorServer, _read_all
from paddle_tpu_torch.obs import goodput as tgood
from paddle_tpu_torch.resilience import chaos as tchaos

from test_torch_disagg import (PROMPT, decode_body, make_pooled, settled, split_stream,
                               stop_all, stream_request, wait_routable)

torch.set_num_threads(1)

X = np.arange(6, dtype=np.float32).reshape(1, 6)
ROUTERS = {"port": (trouter, treg, tfleet), "ref": (rrouter, rreg, rfleet)}


@pytest.fixture(autouse=True)
def _clean_chaos():
    for c in (tchaos, rchaos):
        c.reset()
    yield
    for c in (tchaos, rchaos):
        c.reset()


def _frame(arrays, *tail):
    return ws.build_request(ws.CMD_INFER, ws.encode_arrays(arrays) + b"".join(tail))


def _request(port, frame, timeout=30):
    """-> the reply's raw body (status byte + payload)."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(frame)
        (blen,) = struct.unpack("<I", _read_all(s, 4))
        return _read_all(s, blen)


def _wire_cmd(port, cmd, payload=b""):
    return _request(port, ws.build_request(cmd, payload))


def _until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


# --------------------------------------------------------------- the wire
@pytest.mark.parametrize("name", ["default", "polite", "noisy", "", "tenant-ü", 12345])
def test_tenant_id_and_field_bitwise(name):
    assert trouter.tenant_id(name) == rrouter.tenant_id(name)
    assert ws.encode_tenant(trouter.tenant_id(name)) == rws.encode_tenant(rrouter.tenant_id(name))


def test_replica_phases_equal_the_reference():
    assert ws.REPLICA_PHASES == rws.REPLICA_PHASES


@pytest.mark.parametrize("tail", [
    (ws.encode_tenant(7), ws.encode_deadline(250.0)),
    (ws.encode_deadline(5.0), ws.encode_trace(99), ws.encode_tenant(3)),
    (ws.encode_decode_opts(8, snapshot_every=4), ws.encode_tenant(1), b"\x42tail-bytes"),
    (),
])
def test_split_meta_strips_the_tenant_and_keeps_the_rest(tail):
    """The router's request splitting, equal to the reference's: the
    tenant field is cut out of what is forwarded, every other field (and
    an unknown tail) kept in wire order."""
    body = _frame([X], *tail)[4:]
    ours, ref = trouter._split_meta(body), rrouter._split_meta(body)
    assert ours == ref
    arrays_bytes, fields, rest, tid, _, _ = ours
    fwd = arrays_bytes + b"".join(struct.pack("<B", m) + raw for m, raw in fields
                                  if m != ws.TENANT_MARKER) + rest
    assert ws.TENANT_MARKER not in [m for m, _ in fields if m != ws.TENANT_MARKER]
    if tail and tail[-1] != b"\x42tail-bytes":
        # the forwarded body parses on a replica with the other fields intact
        _, budget, trace, _ = ws.decode_request(fwd[1:])
        want = ws.decode_request(body[1:])
        assert (budget, trace) == want[1:3]


# -------------------------------------------------------------- fair gate
SCRIPT = ["heavy", "light", "heavy", "heavy", "other", "light", "tiny", "tiny", "tiny",
          "heavy", "light", "heavy", "other", "heavy", "light", "heavy", "tiny", "light"]


def grant_order(router_mod, script):
    """One permit held while the script's requests arrive in order (each
    queued, or shed, before the next arrives); then the permit goes round:
    each grant releases at once, so the recorded order is the gate's."""
    gate = router_mod.FairGate(1, policies=[
        router_mod.TenantPolicy("heavy", weight=3, max_queue=64),
        router_mod.TenantPolicy("light", weight=1, max_queue=64),
        router_mod.TenantPolicy("tiny", weight=2, max_queue=2)])
    gate.acquire(None, 5)
    order, threads = [], []

    def arrived():
        st = gate.stats().values()
        return sum(t["waiting"] + t["shed"] for t in st)

    for i, name in enumerate(script):
        def waiter(name=name, i=i):
            try:
                got = gate.acquire(router_mod.tenant_id(name), 60)
            except router_mod.ShedError as e:
                order.append(("shed", name, i, e.reason))
                return
            order.append((got, i))
            gate.release()

        t = threading.Thread(target=waiter)
        t.start()
        threads.append(t)
        _until(lambda i=i: arrived() == i + 1)
    gate.release()
    for t in threads:
        t.join(60)
    sheds = sorted(o for o in order if o[0] == "shed")
    return [o for o in order if o[0] != "shed"], sheds, gate.stats()


def test_fair_gate_grant_order_equals_the_reference():
    ours, ref = grant_order(trouter, SCRIPT), grant_order(rrouter, SCRIPT)
    assert ours == ref
    grants, sheds, stats = ours
    assert len(grants) + len(sheds) == len(SCRIPT) and sheds
    assert {s[3] for s in sheds} == {"tenant_queue_full"}
    assert stats["default"]["granted"] == 3  # "other" shares the default tenant
    # under contention heavy (weight 3) is granted ahead of light (weight 1)
    first = [g[0] for g in grants[:8]]
    assert first.count("heavy") >= 2 * first.count("light")


@pytest.mark.parametrize("reason", ["admission_timeout"])
def test_admission_timeout_sheds_alike(reason):
    for mod in (trouter, rrouter):
        gate = mod.FairGate(1)
        gate.acquire(None, 5)
        with pytest.raises(mod.ShedError) as ei:
            gate.acquire(None, 0.05)
        assert ei.value.reason == reason and gate.stats()["default"]["shed"] == 1
        gate.release()


# ------------------------------------------------------ autoscaler, ledger
@pytest.mark.parametrize("cfg", [dict(min_replicas=1, max_replicas=3, scale_down_ticks=2),
                                 dict(min_replicas=2, max_replicas=4, scale_up_pressure=2.0,
                                      scale_down_ticks=3),
                                 dict()])
def test_autoscaler_decisions_equal_the_reference(cfg):
    rng = np.random.RandomState(5)
    grid = [(int(n), int(w), float(b)) for n, w, b in zip(
        rng.randint(0, 5, 200), rng.randint(0, 12, 200) * (rng.rand(200) < 0.5),
        rng.randint(0, 12, 200) * (rng.rand(200) < 0.5))]
    a, b = tfleet.Autoscaler(**cfg), rfleet.Autoscaler(**cfg)
    ours = [a.decide(*g) for g in grid]
    assert ours == [b.decide(*g) for g in grid]
    assert {-1, 0, 1} <= set(ours) or cfg == dict()


def test_serving_goodput_report_equals_the_reference():
    rng = np.random.RandomState(9)
    reports = []
    for mod in (tgood, rgood):
        acct = mod.GoodputAccountant(export=False)
        led = mod.ServingGoodput(export=False, accountant=acct)
        for i in range(120):
            led.record(f"t{rng.randint(3)}", mod.SERVING_OUTCOMES[rng.randint(4)],
                       seconds=float(rng.rand()), tokens=int(rng.randint(0, 50)))
        rng = np.random.RandomState(9)
        reports.append((led.report(), acct.report()["serving_s"]))
    assert reports[0] == reports[1]
    with pytest.raises(ValueError):
        tgood.ServingGoodput(export=False).record("t", "nope")


# --------------------------------------------------------------- registry
HEALTHY = {"ok": True, "accepting": True, "phase": "decode", "decode": {"free_slots": 3},
           "engine": {"queue_depth": 2, "declared_buckets": [1, 2, 4]}}
DRAINING = {"ok": False, "accepting": False, "draining": True, "draining_deadline_s": 4.0,
            "engine": {"queue_depth": 0, "declared_buckets": [1, 2, 4]}}
OLD = {"ok": True, "engine": {"queue_depth": 0, "declared_buckets": []}}
REG_SCRIPT = [
    ("reply", "a", HEALTHY), ("reply", "b", OLD), ("beat",),
    ("reply", "a", ConnectionError("down")), ("beat",), ("beat",),  # two misses: ejected
    ("beat",),                               # still cooling down: not probed
    ("wait",), ("beat",),                    # the half-open probe fails: ejected again
    ("reply", "a", HEALTHY), ("wait",), ("beat",),  # the probe succeeds: readmitted
    ("reply", "a", DRAINING), ("beat",),     # a replica-announced drain: draining, not dead
    ("reply", "a", HEALTHY), ("beat",),      # ... lifted by an accepting heartbeat
    ("drain", "a", True), ("beat",),         # a router drain holds against a stale heartbeat
    ("drain", "a", False), ("beat",),
    ("io", "b"), ("reply", "b", RuntimeError("chaos")), ("wait",), ("beat",),
    ("reply", "b", OLD), ("wait",), ("beat",),
]


def registry_states(reg_mod, script, cooldown=0.3):
    replies = {}

    def probe(host, port, timeout):
        r = replies[port]
        if isinstance(r, Exception):
            raise r
        return r

    reg = reg_mod.ReplicaRegistry(heartbeat_interval=0, eject_misses=2,
                                  probe_cooldown=cooldown, probe_fn=probe)
    ports = {"a": 1, "b": 2}
    reg.register("a", "127.0.0.1", 1, phase="prefill")
    reg.register("b", "127.0.0.1", 2)
    out = []
    try:
        for step in script:
            if step[0] == "reply":
                replies[ports[step[1]]] = step[2]
            elif step[0] == "beat":
                reg.heartbeat_once()
            elif step[0] == "wait":
                time.sleep(cooldown + 0.02)
            elif step[0] == "io":
                reg.report_io_error(step[1])
            elif step[0] == "drain":
                reg.set_draining(step[1], step[2])
            out.append(sorted((v.rid, v.state, v.queue_depth, v.warm_buckets, v.phase,
                               v.free_slots, v.draining_deadline_s) for v in reg.snapshot()))
        out.append([v.rid for v in reg.routable()])
    finally:
        reg.close()
    return out


def test_registry_state_sequence_equals_the_reference():
    ours, ref = registry_states(treg, REG_SCRIPT), registry_states(rreg, REG_SCRIPT)
    assert ours == ref
    states = [dict((r[0], r[1]) for r in snap) for snap in ours[:-1]]
    a = [s["a"] for s in states]
    assert a[5] == a[6] == a[8] == "ejected" and a[11] == "ok"
    assert a[13] == "draining" and a[15] == "ok" and a[16] == a[17] == "draining"
    assert a[18] == a[19] == "ok"
    b = [s["b"] for s in states]
    assert b[20] == b[23] == "ejected" and b[26] == "ok"


def test_heartbeat_chaos_sites():
    reg = treg.ReplicaRegistry(heartbeat_interval=0, eject_misses=1,
                               probe_fn=lambda h, p, t: dict(HEALTHY))
    try:
        reg.register("x", "127.0.0.1", 1)
        reg.register("y", "127.0.0.1", 2)
        with tchaos.fault("fleet.heartbeat.x", exc=ConnectionError("injected")):
            reg.heartbeat_once()
        assert {v.rid: v.state for v in reg.snapshot()} == {"x": "ejected", "y": "ok"}
        assert tchaos.visits("fleet.heartbeat") >= 1
    finally:
        reg.close()


# ------------------------------------------------------------------ router
def _fleet_pair(run_a, run_b, tenants=(), server=PredictorServer, router=trouter,
                registry=treg, **router_kwargs):
    sa, sb = server(run_a), server(run_b)
    reg = registry.ReplicaRegistry(heartbeat_interval=0)
    reg.register("a", "127.0.0.1", sa.port)
    reg.register("b", "127.0.0.1", sb.port)
    router_kwargs.setdefault("retry_base", 0.005)
    router_kwargs.setdefault("retry_max", 0.02)
    return sa, sb, reg, router.FleetRouter(reg, tenants=tenants, own_registry=True,
                                           **router_kwargs)


def _stop(*things):
    for t in things:
        t.stop()


def test_shed_is_retried_on_another_replica():
    hits = {"a": 0, "b": 0}

    def run_a(x):
        hits["a"] += 1
        raise RetryableError("synthetic shed")

    def run_b(x):
        hits["b"] += 1
        return [x + 1.0]

    sa, sb, reg, router = _fleet_pair(run_a, run_b)
    try:
        body = _request(router.port, _frame([X]))
        assert body[0] == 0 and np.array_equal(ws.decode_arrays(body[1:])[0], X + 1.0)
        assert hits == {"a": 1, "b": 1}  # tried once, not hammered
    finally:
        _stop(router, sa, sb)


def test_dead_replica_is_ejected_and_routed_around():
    sa, sb, reg, router = _fleet_pair(lambda x: [x], lambda x: [x])
    try:
        sa.stop()
        assert all(_request(router.port, _frame([X]))[0] in (0, 2) for _ in range(4))
        assert {v.rid: v.state for v in reg.snapshot()} == {"a": "ejected", "b": "ok"}
        assert _request(router.port, _frame([X]))[0] == 0
    finally:
        _stop(router, sb)


def test_every_replica_gone_is_status_2_never_1():
    sa, sb, reg, router = _fleet_pair(lambda x: [x], lambda x: [x])
    try:
        _stop(sa, sb)
        assert [_request(router.port, _frame([X]))[0] for _ in range(3)] == [2, 2, 2]
    finally:
        router.stop()


def test_drain_zero_drops():
    """Drain a replica while requests are in flight: the drain completes,
    every reply is status 0, later traffic never reaches the drained
    replica, whose own health announces the drain until the undrain."""
    hits = {"a": 0, "b": 0}

    def mk(name):
        def run(x):
            hits[name] += 1
            time.sleep(0.05)
            return [x]
        return run

    sa, sb, reg, router = _fleet_pair(mk("a"), mk("b"))
    statuses = []

    def client():
        statuses.append(_request(router.port, _frame([X]))[0])

    try:
        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        assert router.drain("a", deadline_s=10.0) is True
        for t in threads:
            t.join(30)
        assert statuses == [0] * 8
        a_before = hits["a"]
        assert [_request(router.port, _frame([X]))[0] for _ in range(6)] == [0] * 6
        assert hits["a"] == a_before
        assert {v.rid: v.state for v in reg.snapshot()}["a"] == "draining"
        assert json.loads(_wire_cmd(sa.port, ws.CMD_HEALTH)[1:])["accepting"] is False
        router.undrain("a")
        assert {v.rid: v.state for v in reg.snapshot()}["a"] == "ok"
        assert json.loads(_wire_cmd(sa.port, ws.CMD_HEALTH)[1:])["accepting"] is True
    finally:
        _stop(router, sa, sb)


def test_a_request_racing_the_drain_is_retried_elsewhere():
    """The port's draining replica refuses new requests (status 2) where
    the reference's keeps serving them. A request the router sends before
    it has seen the drain (the registry still routes to the replica) gets
    that status 2 and is retried on the other replica: the client sees
    status 0, every time."""
    served = {"a": 0, "b": 0}

    def mk(name):
        def run(x):
            served[name] += 1
            return [x * 2.0]
        return run

    sa, sb, reg, router = _fleet_pair(mk("a"), mk("b"))
    try:
        sa.begin_drain(30.0)  # announced by the replica; the registry has not probed
        assert {v.rid: v.state for v in reg.snapshot()}["a"] == "ok"
        for _ in range(6):
            body = _request(router.port, _frame([X]))
            assert body[0] == 0 and np.array_equal(ws.decode_arrays(body[1:])[0], X * 2.0)
        assert served["a"] == 0 and served["b"] == 6
        assert trouter._M_RETRIES.value(cause="shed") >= 1
        reg.heartbeat_once()  # the drain is seen: no more detours
        assert {v.rid: v.state for v in reg.snapshot()}["a"] == "draining"
    finally:
        _stop(router, sa, sb)


def test_route_chaos_fault_sheds_instead_of_erroring():
    sa, sb, reg, router = _fleet_pair(lambda x: [x], lambda x: [x])
    try:
        with tchaos.fault("fleet.route", exc=RuntimeError("injected")):
            assert _request(router.port, _frame([X]))[0] == 2
        assert _request(router.port, _frame([X]))[0] == 0
    finally:
        _stop(router, sa, sb)


def test_per_tenant_accounting_in_the_ledger():
    tgood.SERVING_LEDGER.reset()
    sa, sb, reg, router = _fleet_pair(lambda x: [x], lambda x: [x],
                                      tenants=[trouter.TenantPolicy("t1", weight=2)])
    try:
        f1 = _frame([X], ws.encode_deadline(5000), ws.encode_tenant(trouter.tenant_id("t1")))
        assert [_request(router.port, f1)[0] for _ in range(3)] == [0, 0, 0]
        rep = tgood.SERVING_LEDGER.report()
        assert rep["tenants"]["t1"]["ok"] == 3
        assert rep["tenants"]["t1"]["deadline_hit_rate"] == 1.0 and rep["goodput"] > 0
        st = router.stats()
        assert st["tenants"]["t1"]["granted"] == 3 and st["serving_goodput"]["replies"] >= 3
        text = _wire_cmd(router.port, ws.CMD_METRICS)[1:].decode()
        assert any(line.startswith("paddle_fleet_requests_total{") and 'tenant="t1"' in line
                   and 'status="0"' in line and line.endswith(" 3") for line in text.splitlines())
    finally:
        _stop(router, sa, sb)


# ----------------------------------------------------------- across packages
def _one_shot_frames():
    rng = np.random.RandomState(2)
    y = rng.randn(3, 6).astype(np.float32)
    return [_frame([X]), _frame([y], ws.encode_deadline(5000.0)),
            _frame([y, X], ws.encode_tenant(rrouter.tenant_id("t9")), ws.encode_trace(77)),
            ws.build_request(ws.CMD_INFER, b"\x01garbage")]


@pytest.mark.parametrize("replicas", ["ref", "port"])
def test_both_routers_give_the_same_bytes(replicas):
    """The same replicas (the reference's servers, or the port's) behind
    the port's router and behind the reference's: every one-shot reply
    is the same bytes, and a shed on one replica is retried alike."""
    server = RefServer if replicas == "ref" else PredictorServer
    shed = RefRetryable if replicas == "ref" else RetryableError
    calls = {"n": 0}

    def run_a(*arrays):
        calls["n"] += 1
        if calls["n"] % 2:
            raise shed("every other call sheds")
        return [a * 3.0 + 1.0 for a in arrays]

    sa, sb = server(run_a), server(lambda *arrays: [a * 3.0 + 1.0 for a in arrays])
    replies = {}
    try:
        for name, (rmod, regmod, _) in ROUTERS.items():
            reg = regmod.ReplicaRegistry(heartbeat_interval=0)
            reg.register("a", "127.0.0.1", sa.port)
            reg.register("b", "127.0.0.1", sb.port)
            router = rmod.FleetRouter(reg, own_registry=True, retry_base=0.001,
                                      retry_max=0.002)
            try:
                calls["n"] = 0
                replies[name] = [_request(router.port, f) for f in _one_shot_frames()]
            finally:
                router.stop()
    finally:
        _stop(sa, sb)
    assert replies["port"] == replies["ref"]
    assert [r[0] for r in replies["port"]] == [0, 0, 0, 1]


def test_both_routers_give_the_same_streams_over_port_replicas(ref_tokens):
    """A pooled fleet of the port's toy decode replicas behind the
    reference's router and behind the port's: the same statuses and
    tokens, for a handed-off stream, a one-shot decode and a stream that
    opted into snapshot frames."""
    servers, registry, port_router = make_pooled()
    ref_reg = rreg.ReplicaRegistry(heartbeat_interval=0.05)
    for rid, srv in zip(("prefill-0", "decode-0"), servers):
        ref_reg.register(rid, "127.0.0.1", srv.port, phase=rid.split("-")[0])
    ref_router = rrouter.FleetRouter(ref_reg, own_registry=True, snapshot_every=4)
    bodies = [decode_body(PROMPT, 12), decode_body(PROMPT, 12, oneshot=True),
              decode_body(PROMPT, 12, snapshot_every=5)]
    try:
        _until(lambda: len(ref_reg.routable()) == 2)
        got = {}
        for name, router in (("port", port_router), ("ref", ref_router)):
            out = []
            for body in bodies:
                status, tokens, snaps = split_stream(stream_request(router.port, body))
                out.append((status, tokens, len(snaps) > 0))
            got[name] = out
        assert got["port"] == got["ref"]
        assert got["port"][0] == (0, ref_tokens, False) and got["port"][2][2]
        assert settled(port_router)
    finally:
        ref_router.stop()
        stop_all(port_router, servers)


@pytest.fixture(scope="module")
def ref_tokens():
    from test_torch_decode import solo, torch_toy_model

    return solo(torch_toy_model(), PROMPT, 12).tolist()


# -------------------------------------------------------------- supervisor
def test_supervise_once_respawns_a_dead_in_process_replica():
    servers = []

    def spawn(rid):
        srv = PredictorServer(lambda x: [x])
        servers.append(srv)
        h = tfleet.ReplicaHandle(rid, "127.0.0.1", srv.port)
        h._dead = False
        h.alive = lambda h=h: not h._dead
        h.stop = lambda timeout=10.0, s=srv: s.stop()
        return h

    fleet = tfleet.Fleet(spawn, replicas=2, supervise=False,
                         autoscaler=tfleet.Autoscaler(min_replicas=2, max_replicas=2))
    try:
        victim = sorted(fleet.handles())[0]
        fleet.handles()[victim]._dead = True
        tick = fleet.supervise_once()
        assert tick["dead"] == 1 and fleet.respawns == 1
        assert len(fleet.handles()) == 2 and victim not in fleet.handles()
        assert _request(fleet.port, _frame([X]))[0] == 0
    finally:
        fleet.close()
        for s in servers:
            s.stop()


def test_subprocess_replicas_serve_respawn_and_rolling_reload(tmp_path):
    """subprocess_spawner's replicas (``python -m paddle_tpu_torch.inference.
    fleet --replica``, on the CPU by argument): replies bitwise the saved
    model's Predictor.run; a SIGKILLed replica respawned by the
    supervisor; a rolling reload to another save with no reply failed."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, jit, nn
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.static import InputSpec

    prev = place._CURRENT
    paddle.set_device("cpu")
    try:
        prefixes = []
        for seed in (0, 1):
            paddle.seed(seed)
            model = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4))
            model.eval()
            prefixes.append(str(tmp_path / f"m{seed}"))
            jit.save(model, prefixes[-1], input_spec=[InputSpec([None, 6], "float32")])
        preds = []
        for p in prefixes:
            cfg = inference.Config(p)
            cfg.disable_gpu()
            preds.append(inference.create_predictor(cfg))
    finally:
        place._CURRENT = prev
    x = np.random.RandomState(0).randn(2, 6).astype(np.float32)
    want = [pr.run([x])[0] for pr in preds]
    spawn = tfleet.subprocess_spawner(prefixes[0], device="cpu", max_batch_size=4,
                                      spawn_timeout=120)
    fleet = tfleet.Fleet(spawn, replicas=2, supervise=False,
                         registry=treg.ReplicaRegistry(heartbeat_interval=0.05),
                         autoscaler=tfleet.Autoscaler(min_replicas=2, max_replicas=2),
                         router_kwargs=dict(retry_base=0.01, retry_max=0.05))
    try:
        wait_routable(fleet.registry, 2)
        body = _request(fleet.port, _frame([x]))
        assert body[0] == 0 and np.array_equal(ws.decode_arrays(body[1:])[0], want[0])
        victim = sorted(fleet.handles())[0]
        fleet.handles()[victim].proc.send_signal(signal.SIGKILL)
        fleet.handles()[victim].proc.wait(30)
        assert all(_request(fleet.port, _frame([x]))[0] in (0, 2) for _ in range(3))
        tick = fleet.supervise_once()
        assert tick["dead"] == 1 and fleet.respawns == 1 and victim not in fleet.handles()
        wait_routable(fleet.registry, 2)
        out = fleet.rolling_reload(prefixes[1])
        assert sorted(out) == sorted(fleet.handles())
        assert all(r["status"] == 0 for r in out.values())
        body = _request(fleet.port, _frame([x]))
        assert body[0] == 0 and np.array_equal(ws.decode_arrays(body[1:])[0], want[1])
        health = json.loads(_wire_cmd(fleet.port, ws.CMD_HEALTH)[1:])
        assert health["router"] and health["routable_replicas"] == 2
    finally:
        handles = fleet.handles()
        fleet.close()
    assert all(not h.alive() for h in handles.values())
