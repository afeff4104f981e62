"""Disaggregated prefill/decode serving in the port
(paddle_tpu_torch/inference/router.py, fleet.py and the engine's and the
server's ``phase``), on the CPU with the torch twin of the reference's
toy decoder (tests/test_torch_decode.py) behind in-process replicas.

Every check is bitwise (the router decides and relays bytes): a pooled
fleet's client stream carries exactly the tokens of the same prompt
decoded colocated, with no snapshot frame leaked; a prefill replica
dying mid-handoff is re-run elsewhere; a decode replica stopped abruptly
after the handoff rides the resume path with zero duplicated and zero
lost tokens; a pure pool at zero degrades (counted) and recovers; each
pool's autoscaler sees only its own pool, as the reference's does for
the same inputs; the phase reaches health and stats, and each phase's
warmup ladder is the reference engine's declared one. The router's live
snapshot count returns to 0 after every path. Token sequences and
statuses are compared, never frame boundaries (a chunk's cadence
follows timing).
"""
import logging
import socket
import struct
import threading
import time
import types

import numpy as np
import pytest
import torch

from paddle_tpu.inference import fleet as ref_fleet
from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu_torch.inference import router as router_mod
from paddle_tpu_torch.inference import wire_spec as ws
from paddle_tpu_torch.inference.fleet import Autoscaler, Fleet, ReplicaHandle
from paddle_tpu_torch.inference.registry import ReplicaRegistry
from paddle_tpu_torch.inference.router import FleetRouter
from paddle_tpu_torch.inference.server import PredictorServer, _read_all
from paddle_tpu_torch.resilience import chaos

from decode_worker import toy_decode_model
from test_torch_decode import HID, VOCAB, make_engine, solo, torch_toy_model

torch.set_num_threads(1)

PROMPT = np.array([1, 2, 3], np.int32)
MAX_NEW = 12
_NAMES = iter(range(10 ** 6))


@pytest.fixture(scope="module")
def model():
    return torch_toy_model()


@pytest.fixture(scope="module")
def ref(model):
    return solo(model, PROMPT, MAX_NEW).tolist()


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    yield
    chaos.reset()


# ----------------------------------------------------------------- helpers
def toy_server(phase="both", step_delay=0.002, **engine_kw):
    """A decode replica: the twin's engine (4 slots x 32, chunk 8) warmed
    up behind a PredictorServer, in this process."""
    eng = make_engine(torch_toy_model(step_delay=step_delay), phase=phase,
                      name=f"disagg-{phase}-{next(_NAMES)}", **engine_kw)
    eng.warmup()
    return PredictorServer(None, decode_engine=eng, own_decode_engine=True)


def decode_body(prompt, max_new, budget_ms=30000.0, **opts):
    return ws.build_request(ws.CMD_INFER, ws.encode_arrays([prompt])
                            + ws.encode_decode_opts(max_new, **opts)
                            + ws.encode_deadline(budget_ms))


def stream_request(port, frame, kill_at=None, timeout=120):
    """Every frame of one request's reply -> [(status, payload)].
    ``kill_at``: ``(n, hook)``, the hook called once the client holds n
    tokens."""
    n_at, hook = kill_at if kill_at else (None, None)
    frames, got, fired = [], 0, False
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(frame)
        while True:
            (blen,) = struct.unpack("<I", _read_all(s, 4))
            body = _read_all(s, blen)
            frames.append((body[0], body[1:]))
            if (body[1:] and not ws.is_kv_snapshot(body[1:])
                    and body[0] in (ws.STATUS_OK, ws.STATUS_STREAM)):
                got += int(ws.decode_arrays(body[1:])[0].size)
            if hook is not None and not fired and got >= n_at:
                hook()
                fired = True
            if body[0] != ws.STATUS_STREAM:
                return frames


def split_stream(frames):
    """-> (terminal status, tokens, snapshot payloads)."""
    tokens, snaps = [], []
    for status, payload in frames:
        if payload and ws.is_kv_snapshot(payload):
            snaps.append(payload)
        elif payload and status in (ws.STATUS_OK, ws.STATUS_STREAM):
            tokens += [int(t) for t in ws.decode_arrays(payload)[0]]
    return frames[-1][0], tokens, snaps


def wait_routable(registry, n, timeout=30.0, phase=None):
    deadline = time.monotonic() + timeout
    while len(registry.routable(phase)) < n:
        assert time.monotonic() < deadline, "replicas never routable"
        time.sleep(0.02)


class BrokenReplica:
    """A listener that accepts and closes every connection at once: a
    replica dying the instant a leg reaches it."""

    # the repo's resource lint (tools/tracelint.py) reads these
    # tpu-resource: acquires=router_socket
    def __init__(self):
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.close()

    # tpu-resource: releases=router_socket
    def close(self):
        self._sock.close()


def make_pooled(prefill=1, decode=1, step_delay=0.002, **router_kw):
    """In-process pooled topology -> (servers, registry, router)."""
    servers, registry = [], ReplicaRegistry(heartbeat_interval=0.05)
    for phase, n in (("prefill", prefill), ("decode", decode)):
        for i in range(n):
            srv = toy_server(phase, step_delay=step_delay)
            servers.append(srv)
            registry.register(f"{phase}-{i}", "127.0.0.1", srv.port, phase=phase)
    router_kw.setdefault("snapshot_every", 4)
    router_kw.setdefault("handoff_timeout", 30.0)
    router_kw.setdefault("backend_timeout", 30.0)
    router = FleetRouter(registry=registry, own_registry=True, **router_kw)
    wait_routable(registry, prefill + decode)
    return servers, registry, router


def settled(router, timeout=10.0):
    """The router's live snapshot count back at 0 (a relay drops its
    snapshot just after the terminal frame reaches the client)."""
    deadline = time.monotonic() + timeout
    while router.live_snapshots():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def stop_all(router, servers):
    router.stop()
    for s in servers:
        s.stop()


def handoff_counters():
    M = router_mod
    return {"ok": M._M_HANDOFF.value(outcome="ok"),
            "retried": M._M_HANDOFF.value(outcome="retried"),
            "degraded": M._M_HANDOFF.value(outcome="degraded"),
            "failed": M._M_HANDOFF.value(outcome="failed"),
            "retries": M._M_RETRIES.value(cause="handoff"),
            "latency_count": M._M_HANDOFF_SECONDS.value()["count"],
            "resume_ok": M._M_RESUMES.value(outcome="ok"),
            "resume_retries": M._M_RETRIES.value(cause="stream_resume")}


def moved(before, after):
    return {k: after[k] - before[k] for k in after}


def moved_once(before, key, want, timeout=10.0):
    """The counters' moves once ``key`` has moved ``want`` (a stream served
    by the prefill leg alone is counted just after its one frame went out,
    as in the reference's router)."""
    deadline = time.monotonic() + timeout
    d = moved(before, handoff_counters())
    while d[key] < want and time.monotonic() < deadline:
        time.sleep(0.005)
        d = moved(before, handoff_counters())
    return d


# ----------------------------------------------------------------- routing
def test_handoff_stream_bitwise_the_colocated_decode(ref):
    servers, _, router = make_pooled()
    before = handoff_counters()
    try:
        status, tokens, snaps = split_stream(
            stream_request(router.port, decode_body(PROMPT, MAX_NEW)))
        assert (status, tokens, snaps) == (0, ref, [])
        d = moved(before, handoff_counters())
        assert (d["ok"], d["latency_count"], d["retries"], d["failed"]) == (1, 1, 0, 0)
        # the decode leg ran on the decode replica, the prefill leg on the prefill one
        pre, dec = (s._decode_engine.stats() for s in servers)
        assert pre["resumes"]["ok"] == 0 and dec["resumes"]["ok"] == 1
        assert settled(router)
    finally:
        stop_all(router, servers)


def test_short_request_is_served_by_the_prefill_leg_alone(model):
    want = solo(model, PROMPT, 1).tolist()
    servers, _, router = make_pooled()
    before = handoff_counters()
    try:
        frames = stream_request(router.port, decode_body(PROMPT, 1))
        assert len(frames) == 1 and split_stream(frames) == (0, want, [])
        assert moved_once(before, "ok", 1)["ok"] == 1
        assert servers[1]._decode_engine.stats()["resumes"]["ok"] == 0
        assert settled(router)
    finally:
        stop_all(router, servers)


def test_colocated_fleet_plans_no_handoff(ref):
    server = toy_server()
    registry = ReplicaRegistry(heartbeat_interval=0.05)
    registry.register("r1", "127.0.0.1", server.port)
    router = FleetRouter(registry=registry, own_registry=True, snapshot_every=4)
    before = handoff_counters()
    try:
        wait_routable(registry, 1)
        assert split_stream(stream_request(router.port, decode_body(PROMPT, MAX_NEW))) \
            == (0, ref, [])
        d = moved(before, handoff_counters())
        assert (d["ok"], d["retried"], d["degraded"], d["failed"]) == (0, 0, 0, 0)
        assert settled(router)
    finally:
        router.stop()
        server.stop()


def test_router_health_and_stats_report_pools():
    servers, _, router = make_pooled(prefill=1, decode=2)
    try:
        assert router.health()["pools"] == {"prefill": 1, "decode": 2}
        assert router.stats()["pools"] == {"prefill": 1, "decode": 2}
    finally:
        stop_all(router, servers)


# --------------------------------------------------- a prefill replica dies
def test_dead_prefill_is_rerun_on_another_and_the_stream_is_clean(ref):
    broken = BrokenReplica()
    servers, registry, router = make_pooled()
    # "a-dead" sorts before "prefill-0": the broken replica is tried first
    registry.register("a-dead", "127.0.0.1", broken.port, phase="prefill")
    before = handoff_counters()
    try:
        assert split_stream(stream_request(router.port, decode_body(PROMPT, MAX_NEW))) \
            == (0, ref, [])
        d = moved(before, handoff_counters())
        assert d["retries"] >= 1 and d["retried"] == 1 and d["ok"] == 0
        assert settled(router)
    finally:
        stop_all(router, servers)
        broken.close()


def test_armed_handoff_fault_sheds_retryable():
    servers, _, router = make_pooled()
    chaos.arm("fleet.handoff", exc=RuntimeError("chaos: handoff"))
    try:
        status, tokens, _ = split_stream(stream_request(router.port,
                                                        decode_body(PROMPT, MAX_NEW)))
        assert (status, tokens) == (ws.STATUS_RETRYABLE, [])
        assert chaos.visits("fleet.handoff") >= 1 and settled(router)
    finally:
        stop_all(router, servers)


# ---------------------------------------------------- a decode replica dies
def test_decode_replica_stopped_abruptly_rides_resume(model):
    """The decode replica carrying a handed-off stream stops abruptly (its
    sockets closed mid-stream, its engine closed): the router resumes the
    stream from its newest snapshot on the other decode replica. One
    unbroken status-0 stream, bitwise the solo decode, zero duplicated
    and zero lost tokens."""
    max_new = 20
    want = solo(model, PROMPT, max_new).tolist()
    servers, registry, router = make_pooled(prefill=1, decode=2, step_delay=0.02)
    by_rid = {"decode-0": servers[1], "decode-1": servers[2]}
    killed = []

    def stop_the_carrier():
        rid = max(by_rid, key=registry.inflight)
        assert registry.inflight(rid) > 0, "no decode replica carries the stream"
        by_rid[rid].stop(drain=False)
        killed.append(rid)

    before = handoff_counters()
    try:
        status, tokens, snaps = split_stream(stream_request(
            router.port, decode_body(PROMPT, max_new), kill_at=(9, stop_the_carrier)))
        assert killed and status == 0 and snaps == []
        assert tokens == want  # zero duplicated, zero lost
        d = moved(before, handoff_counters())
        assert d["ok"] == 1 and d["resume_ok"] >= 1 and d["resume_retries"] >= 1
        assert settled(router)
    finally:
        stop_all(router, servers)


# ------------------------------------------------------ a pool at zero
def test_decode_pool_at_zero_degrades_then_recovers(ref, caplog):
    servers, registry, router = make_pooled()
    before = handoff_counters()
    try:
        registry.deregister("decode-0")
        with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.inference.router"):
            assert split_stream(stream_request(router.port, decode_body(PROMPT, MAX_NEW))) \
                == (0, ref, [])
        mid = handoff_counters()
        assert moved(before, mid)["degraded"] == 1 and mid["ok"] == before["ok"]
        assert any("degraded to colocated" in r.message for r in caplog.records)
        registry.register("decode-0", "127.0.0.1", servers[1].port, phase="decode")
        wait_routable(registry, 2)
        assert split_stream(stream_request(router.port, decode_body(PROMPT, MAX_NEW))) \
            == (0, ref, [])
        assert moved(mid, handoff_counters())["ok"] == 1
        assert settled(router)
    finally:
        stop_all(router, servers)


def test_decode_pool_refusing_every_attempt_degrades_mid_stream(ref, caplog):
    broken = BrokenReplica()
    registry = ReplicaRegistry(heartbeat_interval=0.05)
    srv = toy_server("prefill")
    registry.register("prefill-0", "127.0.0.1", srv.port, phase="prefill")
    registry.register("z-dead", "127.0.0.1", broken.port, phase="decode")
    router = FleetRouter(registry=registry, own_registry=True, snapshot_every=4)
    before = handoff_counters()
    try:
        wait_routable(registry, 2)
        with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.inference.router"):
            assert split_stream(stream_request(router.port, decode_body(PROMPT, MAX_NEW))) \
                == (0, ref, [])
        d = moved(before, handoff_counters())
        assert d["degraded"] == 1 and d["failed"] == 0
        assert any("decode pool refused handoff" in r.message for r in caplog.records)
        assert settled(router)
    finally:
        router.stop()
        srv.stop()
        broken.close()


# ------------------------------------------------------- per-pool autoscaling
def _view(rid, inflight=0, queue_depth=0, free_slots=None):
    return types.SimpleNamespace(rid=rid, inflight=inflight, queue_depth=queue_depth,
                                 free_slots=free_slots)


def fake_pooled_fleet(fleet_mod, prefill_scaler=None, decode_scaler=None):
    """A pooled Fleet of ``fleet_mod`` over stand-in handles: pool
    membership, signals and the supervisor's tick are what is tested."""
    def spawn(rid, phase):
        h = fleet_mod.ReplicaHandle(rid, "127.0.0.1", 1)
        h._dead = False
        h.alive = lambda h=h: not h._dead
        h.stop = lambda timeout=10.0: None
        return h

    A = fleet_mod.Autoscaler
    return fleet_mod.Fleet(spawn, supervise=False, pools={
        "prefill": {"replicas": 1, "autoscaler": prefill_scaler
                    or A(min_replicas=1, max_replicas=3, scale_up_pressure=4.0)},
        "decode": {"replicas": 1, "autoscaler": decode_scaler
                   or A(min_replicas=1, max_replicas=3, scale_up_pressure=4.0)},
    })


@pytest.mark.parametrize("waiting,views", [
    (9, [_view("prefill-0"), _view("decode-0", free_slots=4)]),
    (0, [_view("prefill-0", inflight=1), _view("decode-0", inflight=2, free_slots=0)]),
    (3, [_view("prefill-0", queue_depth=5), _view("decode-0", inflight=1, queue_depth=2,
                                                  free_slots=1)]),
])
def test_each_pool_autoscaler_sees_only_its_own_pool(monkeypatch, waiting, views):
    """Pool-local signals and the tick's per-pool actions, equal to the
    reference's: gate pressure is the prefill pool's, decode backlog and
    slot saturation the decode pool's."""
    out = []
    for mod in (ref_fleet, __import__("paddle_tpu_torch.inference.fleet",
                                      fromlist=["Fleet"])):
        fleet = fake_pooled_fleet(mod)
        try:
            monkeypatch.setattr(fleet.router.gate, "stats", lambda: {
                "default": {"weight": 1, "waiting": waiting, "granted": 0, "shed": 0}})
            signals = {p: fleet.pool_signals(p, views=views) for p in ("prefill", "decode")}
            tick = fleet.supervise_once()
            out.append((signals, {p: tick["pools"][p]["action"] for p in tick["pools"]},
                        {p: len(m) for p, m in fleet.pools().items()}))
        finally:
            fleet.close()
    assert out[0] == out[1]
    signals, actions, _ = out[1]
    assert signals["prefill"][0] == waiting and signals["decode"][0] == 0


def test_dead_replica_respawns_into_its_own_pool():
    from paddle_tpu_torch.inference import fleet as mod

    fleet = fake_pooled_fleet(mod, prefill_scaler=Autoscaler(min_replicas=1, max_replicas=1),
                              decode_scaler=Autoscaler(min_replicas=1, max_replicas=1))
    try:
        victim = fleet.pools()["decode"][0]
        fleet.handles()[victim]._dead = True
        tick = fleet.supervise_once()
        assert tick["dead"] == 1 and victim not in fleet.handles()
        assert [len(fleet.pools()[p]) for p in ("prefill", "decode")] == [1, 1]
        assert fleet.pools()["decode"][0] == "decode-1" and fleet.respawns == 1
    finally:
        fleet.close()


def test_pooled_fleet_of_toy_replicas_hands_off(ref):
    """``Fleet(pools=)`` over in-process toy replicas spawned per phase:
    the pooled stream is the colocated one, and a prefill pool scaled to
    zero degrades to the decode pool (counted) with the same tokens."""
    servers = []

    def spawn(rid, phase):
        srv = toy_server(phase)
        servers.append(srv)
        h = ReplicaHandle(rid, "127.0.0.1", srv.port)
        h.stop = lambda timeout=10.0, s=srv: s.stop()
        return h

    fleet = Fleet(spawn, supervise=False, pools={"prefill": 1, "decode": 1},
                  registry=ReplicaRegistry(heartbeat_interval=0.05),
                  router_kwargs=dict(snapshot_every=4))
    try:
        wait_routable(fleet.registry, 2)
        before = handoff_counters()
        assert split_stream(stream_request(fleet.port, decode_body(PROMPT, MAX_NEW))) \
            == (0, ref, [])
        assert moved(before, handoff_counters())["ok"] == 1
        fleet.scale_to(0, "prefill")
        mid = handoff_counters()
        assert split_stream(stream_request(fleet.port, decode_body(PROMPT, MAX_NEW))) \
            == (0, ref, [])
        assert moved(mid, handoff_counters())["degraded"] == 1
        assert settled(fleet.router)
    finally:
        fleet.close()
        for s in servers:
            s.stop()


# ----------------------------------------------------------------- phase
LADDER = dict(max_slots=4, max_seq_len=32, min_seq_bucket=8, max_prompt_len=16)


@pytest.mark.parametrize("phase", ["prefill", "decode", "both"])
def test_phase_ladder_health_and_stats_match_the_reference(model, phase):
    """The reference engine's declared ladder for the same configuration
    (its compiles skipped: the ladder is the subject) against the port's.
    Prompt side: the reference's prefill buckets are the port's fill
    rungs (start + C), the smallest only for a decode engine. Step side:
    the port has one step program, at max_seq_len, which reaches every
    step rung the reference declares (a prefill engine's reach the prompt
    bucket). Both report the phase in health and stats."""
    ref_eng = JaxEngine(toy_decode_model(hidden=HID, vocab=VOCAB, seed=0), phase=phase,
                        watchdog_interval=0, prefix=False, name=f"ladder-jax-{phase}",
                        **LADDER)
    try:
        ref_eng._program = lambda key, warming=False: None
        declared = ref_eng.warmup()
        ref_health, ref_stats = ref_eng.health(), ref_eng.stats()
    finally:
        ref_eng.close()
    with make_engine(model, phase=phase, max_prompt_len=16, name=f"ladder-{phase}") as eng:
        rungs = eng.warmup()
        keys = eng.declared_buckets()
        health, stats = eng.health(), eng.stats()
    ref_prompt = sorted({seq for kind, _, seq in declared if kind == "prefill"})
    ref_step = sorted({seq for kind, _, seq in declared if kind == "step"})
    assert rungs == ref_prompt == sorted(s for kind, _, s in keys if kind == "fill")
    assert [k for k in keys if k[0] == "step"] == [("step", 4, 32)]
    assert max(ref_step) <= 32
    if phase == "prefill":
        assert max(ref_step) == max(ref_prompt)  # the step reaches the prompt bucket
    if phase == "decode":
        assert rungs == [8]
    assert health["phase"] == stats["phase"] == ref_health["phase"] == ref_stats["phase"] \
        == phase
    assert stats["declared_programs"] == len(keys)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_server_declares_its_engines_phase(model, phase):
    srv = toy_server(phase)
    try:
        for cmd in (ws.CMD_HEALTH, ws.CMD_STATS):
            with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
                s.sendall(ws.build_request(cmd))
                (blen,) = struct.unpack("<I", _read_all(s, 4))
                body = _read_all(s, blen)
            import json

            doc = json.loads(body[1:])
            assert doc["phase"] == phase and doc["decode"]["phase"] == phase
        with pytest.raises(ValueError, match="phase"):
            PredictorServer(None, phase="mixed")
    finally:
        srv.stop()


def test_health_carries_what_the_registry_reads_like_the_reference():
    """A decode replica's cmd-3 health in both packages (the toy twins,
    phase "decode"): the same top-level keys, every field the registry
    reads under the reference's key, and a registry of either package
    folding them into the same routing view."""
    import json

    from paddle_tpu.inference import registry as ref_registry
    from paddle_tpu.inference.server import PredictorServer as RefServer

    ref_eng = JaxEngine(toy_decode_model(hidden=HID, vocab=VOCAB, seed=0), phase="decode",
                        watchdog_interval=0, prefix=False, name="health-jax", max_slots=4,
                        max_seq_len=32, min_seq_bucket=8)
    servers = {"ref": RefServer(None, decode_engine=ref_eng, own_decode_engine=True),
               "port": toy_server("decode")}
    try:
        health = {}
        for name, srv in servers.items():
            with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
                s.sendall(ws.build_request(ws.CMD_HEALTH))
                (blen,) = struct.unpack("<I", _read_all(s, 4))
                health[name] = json.loads(_read_all(s, blen)[1:])
        assert set(health["port"]) == set(health["ref"])
        for doc in health.values():
            assert doc["accepting"] and doc["phase"] == "decode" and doc["engine"] is None
            assert doc["draining_deadline_s"] is None and doc["decode"]["free_slots"] == 4
        views = []
        for mod in (ref_registry, __import__("paddle_tpu_torch.inference.registry",
                                             fromlist=["ReplicaRegistry"])):
            reg = mod.ReplicaRegistry(heartbeat_interval=0)
            try:
                for name, srv in sorted(servers.items()):
                    reg.register(name, "127.0.0.1", srv.port)
                reg.heartbeat_once()
                views.append([(v.rid, v.state, v.phase, v.free_slots, v.queue_depth,
                               v.warm_buckets) for v in reg.routable("decode")])
            finally:
                reg.close()
        assert views[0] == views[1] == [("port", "ok", "decode", 4, 0, 0),
                                        ("ref", "ok", "decode", 4, 0, 0)]
    finally:
        for srv in servers.values():
            srv.stop()
