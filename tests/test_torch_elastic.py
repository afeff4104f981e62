"""The port's elastic protocol (paddle_tpu_torch/resilience/elastic.py)
and its pod end to end, on the CPU.

The consensus cases mirror tests/test_elastic.py's
``TestConsensusProtocol``, each run three ways: the port's coordinator
with the port's clients, the JAX package's coordinator with the port's
clients, and the port's coordinator with the JAX package's clients (the
protocol is the reference's newline-delimited JSON, so either package's
clients take part in the other's consensus and agree on the same step).
The host-sharded cases mirror ``TestHostShardedFormat`` on the port's
``Shard`` blocks. The pod: two ranks of tests/torch_elastic_worker.py
through the port's ``launch_elastic`` over gloo, ZeRO-1 over dp=2, a
SIGTERM to rank 1 mid-run: both ranks save one consensus step through
``MultiProcessShardedManager`` and exit 143, the launcher raises
``PodPreempted`` without relaunching, and the checkpoint restores onto
one rank bitwise as the ranks' state gathered.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu.resilience import elastic as jelastic
from paddle_tpu.resilience import preemption as jpreemption
import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import from_rank_states
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed import launch_mod
from paddle_tpu_torch.distributed.topology import Mesh
from paddle_tpu_torch.resilience import chaos, elastic, preemption
from paddle_tpu_torch.resilience.checkpoint import CheckpointCorrupt

import torch_elastic_worker as EW

WORKER = EW.__file__
FAST = {"hb_interval": 0.05, "consensus_timeout": 15.0}
PACKAGES = {"port": (elastic, preemption), "jax": (jelastic, jpreemption)}
# (the coordinator's package, the clients' package)
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]


@pytest.fixture(autouse=True)
def _clean():
    for c, p in ((chaos, preemption), (jchaos, jpreemption)):
        c.reset()
        p.get_preemption_handler().clear()
    yield
    for c, p in ((chaos, preemption), (jchaos, jpreemption)):
        c.reset()
        p.get_preemption_handler().clear()
    elastic._clear_active(elastic.active_client())
    jelastic._clear_active(jelastic.active_client())


@pytest.fixture(params=PAIRS, ids=["-".join(p) for p in PAIRS])
def pod(request):
    """``make(world, dead_timeout=5.0, **coordinator knobs)`` -> (coordinator,
    clients) of the pair; everything made is closed after the test."""
    coord_mod = PACKAGES[request.param[0]][0]
    client_mod, pre_mod = PACKAGES[request.param[1]]
    made = []

    def make(world, dead_timeout=5.0, **coord_kw):
        coord = coord_mod.ElasticCoordinator(world, port=0, dead_timeout=dead_timeout,
                                             **coord_kw)
        addr = ("127.0.0.1", coord.port)
        clients = [client_mod.ElasticClient(addr, r, world,
                                            handler=pre_mod.PreemptionHandler(),
                                            dead_timeout=dead_timeout, **FAST).start()
                   for r in range(world)]
        made.append((coord, clients))
        return coord, clients

    make.client_mod = client_mod
    make.pre_mod = pre_mod
    make.coord_mod = coord_mod
    yield make
    for coord, clients in made:
        for c in clients:
            c.close()
        coord.close()


def _threads(fn, items, timeout=25):
    ths = [threading.Thread(target=fn, args=it) for it in items]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout)


class TestConsensusProtocol:
    def test_consensus_is_max_step_over_ranks(self, pod):
        _, clients = pod(3)
        for r, c in enumerate(clients):
            for s in range(1, 5 + r):  # ranks done 4, 5, 6
                c.note_step(s, 0.01)
                assert c.check_boundary(s) is None
        clients[1].request_save("maintenance")
        results = {}

        def run(r, c, done):
            results[r] = c.check_boundary(done)
        _threads(run, [(r, c, 4 + r) for r, c in enumerate(clients)])
        # every rank saves the highest boundary any rank reached
        assert results == {0: 6, 1: 6, 2: 6}

    def test_local_sigterm_reaches_consensus(self, pod):
        _, clients = pod(2)
        for c in clients:
            c.note_step(3, 0.01)
        clients[0]._handler.request()  # the SIGTERM flag, minus the signal
        results = {}

        def run(r, c):
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                got = c.check_boundary(3)
                if got is not None:
                    results[r] = got
                    return
                time.sleep(0.02)
        _threads(run, list(enumerate(clients)))
        assert results == {0: 3, 1: 3}

    def test_nonblocking_mode_agrees_on_future_barrier(self, pod):
        coord, _ = pod(2)
        clients = [pod.client_mod.ElasticClient(
            ("127.0.0.1", coord.port), r, 2, handler=pod.pre_mod.PreemptionHandler(),
            block=False, margin=2, **FAST).start() for r in range(2)]
        try:
            for c in clients:
                c.note_step(4, 0.01)
            clients[0].request_save()
            assert clients[0].check_boundary(4) is None
            got = clients[1].check_boundary(4)
            results = set() if got is None else {got}
            for c in clients:
                c.note_step(5, 0.01)
                got = c.check_boundary(5)
                if got is not None:
                    results.add(got)
            assert results == {6}  # max(4, 4) + margin 2
        finally:
            for c in clients:
                c.close()

    def test_dead_host_triggers_consensus_and_barrier_excludes_it(self, pod):
        _, clients = pod(2, dead_timeout=0.4)
        clients[0].note_step(3, 0.01)
        clients[1]._stop.set()  # rank 1 goes silent (a SIGKILL)
        clients[1]._hb_thread.join(2)
        time.sleep(0.8)
        assert clients[0].check_boundary(3) == 3
        status = clients[0].status()
        assert status["dead"] == [1] and "dead_host" in status["reason"]
        clients[0].barrier("publish", timeout=5)  # must not hang

    def test_straggler_flagged_after_n_strikes(self, pod):
        _, clients = pod(2, straggler_k=2.0, straggler_n=2)
        for s in range(1, 4):
            clients[0].note_step(s, 0.01)
            clients[0].check_boundary(s)
            clients[1].note_step(s, 0.5)
            clients[1].check_boundary(s)
        status = clients[0].status()
        assert status["stragglers"] == [1] and status["ranks"]["1"]["straggler"] is True
        assert status["save"] is False  # flagged, never killed

    def test_one_fast_step_is_not_a_straggler(self, pod):
        _, clients = pod(2, straggler_k=2.0, straggler_n=3)
        for dur in (0.5, 0.5, 0.01, 0.5, 0.5):
            clients[0].note_step(1, 0.01)
            clients[0].check_boundary(1)
            clients[1].note_step(1, dur)
            clients[1].check_boundary(1)
        assert clients[0].status()["stragglers"] == []

    def test_finished_rank_stands_as_proposal(self, pod):
        _, clients = pod(2)
        for c in clients:
            c.note_step(4, 0.01)
        done = {}

        def drain(c):
            done["drain"] = c.finish_and_drain(4, timeout=15)
        t = threading.Thread(target=drain, args=(clients[0],))
        t.start()
        time.sleep(0.2)
        clients[1].request_save("late preemption")
        assert clients[1].check_boundary(4) == 4
        t.join(20)
        assert done["drain"] == 4

    def test_drain_completes_when_all_finish(self, pod):
        _, clients = pod(2)
        out = {}

        def drain(r, c):
            out[r] = c.finish_and_drain(5, timeout=15)
        _threads(drain, list(enumerate(clients)))
        assert out == {0: None, 1: None}

    def test_coordinator_lost_raises_instead_of_solo_save(self, pod):
        coord, clients = pod(2, dead_timeout=0.3)
        clients[1].close()
        coord.close()  # rank 0's process died
        c = clients[0]
        c.note_step(2, 0.01)
        c.request_save()  # swallowed: the coordinator is gone
        with pytest.raises(pod.client_mod.CoordinatorLost):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                c.check_boundary(2)
                time.sleep(0.05)


def test_local_fallback_degrades_to_single_host(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_ELASTIC_COORD", raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    h = preemption.PreemptionHandler()
    el = elastic.init_from_env(handler=h)
    assert isinstance(el, elastic.LocalElastic)
    el.note_step(1, 0.01)
    assert el.check_boundary(1) is None
    h.request()
    assert el.check_boundary(2) == 2 and el.finish_and_drain(2) == 2
    el.barrier("anything")  # a no-op
    el.close()


def test_init_from_env_builds_pod(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_COORD", f"127.0.0.1:{launch_mod.find_free_port()}")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    el0 = elastic.init_from_env(handler=preemption.PreemptionHandler(), **FAST)
    assert el0._coordinator is not None and elastic.active_client() is el0
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    el1 = elastic.init_from_env(handler=preemption.PreemptionHandler(), **FAST)
    assert el1._coordinator is None
    # the sharded manager's default barrier is the active client's
    seen = []
    el1.barrier = lambda name: seen.append(name)
    manager = tckpt.MultiProcessShardedManager("/nonexistent-root", rank=1, world=2)
    manager._barrier("stage-1.1")
    assert seen == ["stage-1.1"]
    el1.close()
    el0.close()


def test_counters_and_goodput_are_the_ports():
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.obs import goodput

    coord = elastic.ElasticCoordinator(1, port=0)
    client = elastic.ElasticClient(("127.0.0.1", coord.port), 0, 1,
                                   handler=preemption.PreemptionHandler(), **FAST).start()
    try:
        before = goodput.report()["steps"]
        client.note_step(1, 0.01)
        assert goodput.report()["steps"] == before + 1
        client.request_save("test")
        assert client.check_boundary(1) == 1
        assert "paddle_elastic_consensus_saves_total" in obs.render()
    finally:
        client.close()
        coord.close()


# ------------------------------------------------- the host-sharded format


def _w():
    return np.arange(64, dtype=np.float32).reshape(8, 8), np.arange(32, dtype=np.float32) \
        .reshape(8, 4)


def _rank_state(r, n):
    """Rank r of n's blocks of the mirrored state: "w" split on dim 0,
    "m" whole."""
    w, m = _w()
    k = 8 // n
    cuts = [(0, r, n)]
    return {"params": {"w": tckpt.Shard(torch.from_numpy(w[r * k:(r + 1) * k]),
                                        *tckpt.cut_index((k, 8), cuts)),
                       "m": torch.from_numpy(m)},
            "opt_state": [tckpt.Shard(torch.from_numpy(2 * w[r * k:(r + 1) * k]),
                                      *tckpt.cut_index((k, 8), cuts)),
                          (torch.from_numpy(m + 1),)],
            "step": np.int64(7)}


class TestHostShardedFormat:
    def test_save_then_reshard_onto_fewer_ranks_bitwise(self, tmp_path):
        ck = str(tmp_path / "ck")
        for r in range(4):  # four ranks' blocks in one directory
            tckpt.write_host_shards(_rank_state(r, 4), os.path.join(ck, f"shard-{r:05d}"), r)
        tckpt.write_host_manifest(_rank_state(0, 4), ck, world=4, step=7)
        w, m = _w()
        for r in range(2):
            out = tckpt.load_sharded(ck, _rank_state(r, 2))
            np.testing.assert_array_equal(out["params"]["w"].numpy(), w[r * 4:(r + 1) * 4])
            np.testing.assert_array_equal(out["opt_state"][0].numpy(), 2 * w[r * 4:(r + 1) * 4])
            np.testing.assert_array_equal(out["opt_state"][1][0].numpy(), m + 1)
            assert int(out["step"]) == 7

    def test_assemble_detects_missing_shard_coverage(self, tmp_path):
        ck = str(tmp_path / "ck")
        for r in range(2):  # two of four ranks' blocks arrived
            tckpt.write_host_shards(_rank_state(r, 4), os.path.join(ck, f"shard-{r:05d}"), r)
        tckpt.write_host_manifest(_rank_state(0, 4), ck, world=4)
        with pytest.raises(CheckpointCorrupt, match="covers"):
            tckpt.assemble_host_checkpoint(ck)

    def test_manager_stages_per_rank_and_rank0_commits(self, tmp_path):
        root = str(tmp_path / "root")
        mgrs = [tckpt.sharded_checkpoint_manager(root, like=_rank_state(r, 2), rank=r, world=2)
                for r in range(2)]
        assert all(isinstance(m, tckpt.MultiProcessShardedManager) for m in mgrs)
        errs = []

        def save(r, step, shift):
            st = _rank_state(r, 2)
            st["params"]["w"].data = st["params"]["w"].data + shift
            try:
                mgrs[r].save(st, step)
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append((r, e))
        _threads(save, [(r, 3, 0) for r in range(2)], timeout=60)
        assert not errs, errs
        assert mgrs[0].latest_step() == 3
        for name in ("MANIFEST.json", "SHARDS.json", "shard-00000", "shard-00001"):
            assert os.path.exists(os.path.join(mgrs[0].path(3), name))
        w, _ = _w()
        for r, m in enumerate(mgrs):
            st, step = m.load()
            assert step == 3
            np.testing.assert_array_equal(st["params"]["w"].numpy(), w[r * 4:(r + 1) * 4])
        _threads(save, [(r, 5, 1) for r in range(2)], timeout=60)
        assert not errs, errs
        assert mgrs[0].latest_step() == 5
        st, _ = mgrs[1].load()
        np.testing.assert_array_equal(st["params"]["w"].numpy(), w[4:] + 1)

    def test_corrupt_published_ckpt_falls_back_to_previous(self, tmp_path):
        root = str(tmp_path / "root")
        mgr = tckpt.MultiProcessShardedManager(root, rank=0, world=1,
                                               like={"w": torch.zeros(2, 2)})
        mgr.save({"w": torch.ones(2, 2)}, 1)
        mgr.save({"w": 2 * torch.ones(2, 2)}, 2)
        with open(os.path.join(mgr.path(2), "shard-00000", "data.npz"), "wb") as f:
            f.write(b"garbage")
        with pytest.warns(UserWarning, match="falling back"):
            st, step = mgr.load()
        assert step == 1
        np.testing.assert_array_equal(st["w"].numpy(), np.ones((2, 2), np.float32))


# ------------------------------------------------------------------ the pod


def test_pod_sigterm_consensus_143_and_bitwise_resume(tmp_path):
    ck, rep = str(tmp_path / "ck"), str(tmp_path / "rep")
    env = {"PADDLE_TPU_ELASTIC_HB_INTERVAL": "0.1",
           "PADDLE_TPU_CHAOS": "site=train.step,signum=15,at=4,rank=1"}
    with pytest.raises(launch_mod.PodPreempted) as ei:
        launch_mod.launch_elastic(WORKER, [ck, rep, "40"], nproc_per_node=2,
                                  log_dir=str(tmp_path / "logs"), extra_env=env,
                                  backend="gloo", max_restarts=2)
    assert ei.value.codes == {0: 143, 1: 143}
    assert sorted(os.listdir(tmp_path / "logs")) == ["workerlog.0", "workerlog.1"]  # no relaunch
    reports = [json.load(open(os.path.join(rep, f"rank-{r}.json"))) for r in range(2)]
    assert all(r["preempted"] for r in reports)
    steps = {r["step"] for r in reports}
    assert len(steps) == 1
    step = steps.pop()
    assert 4 <= step < 40
    assert preemption.read_resume_marker(ck)["step"] == step
    # the checkpoint restores onto one rank as the ranks' state gathered
    ranks = [dict(np.load(os.path.join(rep, f"state-{r}.npz"))) for r in range(2)]
    params = {k[len("param/"):]: v for k, v in ranks[0].items() if k.startswith("param/")}

    def state_of(r):
        out = {}
        for k, v in r.items():
            if k.startswith("state/"):
                name, i = k[len("state/"):].rsplit("/", 1)
                out.setdefault(name, {})[int(i)] = v
        return {n: tuple(d[i] for i in sorted(d)) for n, d in out.items()}
    saved_place = ptt.core.place._CURRENT
    ptt.set_device("cpu")
    step_fn, init_fn = EW.model_and_step(Mesh((1,) * 6))
    p1, s1 = init_fn()
    manager = tckpt.sharded_checkpoint_manager(ck, world=1)
    manager.reader_like = tckpt.place({"params": p1, "opt_state": s1, "step": np.int64(0)},
                                      step_fn.layout)
    got, saved = manager.load()
    assert saved == step and int(got["step"]) == step
    whole = from_rank_states([state_of(r) for r in ranks],
                             {n: tuple(a.numpy() for a in v) for n, v in s1.items()})
    for n, p in params.items():
        np.testing.assert_array_equal(got["params"][n].numpy(), p, err_msg=n)
        for a, b in zip(got["opt_state"][n], whole[n]):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    # one more step from the restored state trains on
    x, y = EW.batch(step, 0, 1)
    loss, _, _ = step_fn(got["params"], got["opt_state"], x, y)
    assert np.isfinite(float(loss))
    ptt.core.place._CURRENT = saved_place
