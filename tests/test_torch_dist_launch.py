"""The port's launcher, chaos.arm_from_env, spawn, init_parallel_env's
refusals, and eager DataParallel with the fleet facade over two gloo
ranks, against the JAX package's.

The launcher tests are the reference's (tests/test_distributed.py
TestMultiProcess, TestTransientRetries, TestElasticLaunch) on the port's
``launch_mod``; each runs inside a deadline of its own (``_within``,
at most torch_dist_worker.RANK_TIMEOUT), so a hang fails one test. The
eager run compares the global loss of two ranks with the reference's
one-process full-batch run at its own tolerance (rtol 2e-5, atol 1e-6),
as TestEagerDDP2Proc does.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import launch_mod as jlaunch
from paddle_tpu.resilience import chaos as jchaos
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import launch_mod
from paddle_tpu_torch.distributed import parallel as tparallel
from paddle_tpu_torch.resilience import chaos as tchaos

import torch_dist_worker as W


def _within(fn, seconds=W.RANK_TIMEOUT):
    """fn() in a thread, failing the test if it has not returned in time."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"did not finish within {seconds} s")
    if "error" in box:
        raise box["error"]
    return box.get("value")


# ------------------------------------------------------------ the env contract


def test_cluster_env_has_the_reference_keys(monkeypatch):
    monkeypatch.delenv("PYTHONPATH", raising=False)
    want = jlaunch.get_cluster_env(1, 2, "127.0.0.1:5000", local_rank=1)
    got = launch_mod.get_cluster_env(1, 2, "127.0.0.1:5000", local_rank=1)
    assert set(got) == set(want)
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_COORDINATOR",
              "PADDLE_LOCAL_RANK"):
        assert got[k] == want[k]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got["PYTHONPATH"].split(os.pathsep)[0] == repo
    env = dict(got, FLAGS_selected_gpus="3")
    pe = tdist.ParallelEnv(env)
    assert (pe.rank, pe.world_size, pe.local_rank, pe.dev_id, pe.nranks) == (1, 2, 1, 3, 2)


def test_transient_signatures_are_the_gloo_ones():
    """The JAX package's gloo signatures stay; its jax.distributed
    cascade cannot occur in a torch run."""
    assert launch_mod._TRANSIENT_RE.search("op.preamble.length <= op.nbytes")
    assert launch_mod._TRANSIENT_RE.search("'gloo::EnforceNotMet'")
    assert not launch_mod._TRANSIENT_RE.search(
        "Terminating process because the JAX distributed service")
    assert jlaunch._TRANSIENT_RE.search("Terminating process because the JAX distributed service")


def test_two_nccl_ranks_on_one_card_raise_before_starting(tmp_path):
    marker = tmp_path / "started"
    script = tmp_path / "s.py"
    script.write_text(f"open({str(marker)!r}, 'w').close()\n")
    for kw in (dict(gpus="0,0"), dict(gpus=["1", "1"], backend="nccl"),
               dict(extra_env={"FLAGS_selected_gpus": "0"})):
        with pytest.raises(ValueError, match="NCCL needs a card per rank"):
            launch_mod.launch_collective(str(script), [], nproc_per_node=2, **kw)
    assert not marker.exists()
    with pytest.raises(ValueError, match="names 1 cards for 2 ranks"):
        launch_mod.launch_collective(str(script), [], nproc_per_node=2, gpus="0", backend="gloo")


def test_gpus_and_backend_reach_each_rank(tmp_path):
    """--gpus 0,0 --backend gloo: two ranks on card 0 over gloo, each with
    its FLAGS_selected_gpus, through ``python -m ...launch``."""
    import subprocess

    script = tmp_path / "env.py"
    script.write_text(
        "import json, os, sys\n"
        "keys = ('PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM', 'FLAGS_selected_gpus',\n"
        "        'PADDLE_DISTRI_BACKEND', 'PADDLE_LOCAL_RANK')\n"
        "json.dump({k: os.environ.get(k) for k in keys},\n"
        "          open(sys.argv[1] + os.environ['PADDLE_TRAINER_ID'], 'w'))\n")
    out = tmp_path / "rank"
    r = _within(lambda: subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--gpus", "0,0",
         "--backend", "gloo", str(script), str(out)], cwd=W.REPO, capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=W.REPO), timeout=W.RANK_TIMEOUT))
    assert r.returncode == 0, r.stderr[-3000:]
    for rank in (0, 1):
        got = json.load(open(f"{out}{rank}"))
        assert got == {"PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": "2",
                       "FLAGS_selected_gpus": "0", "PADDLE_DISTRI_BACKEND": "gloo",
                       "PADDLE_LOCAL_RANK": str(rank)}


# ------------------------------------------------------------ fault paths


def test_watch_kills_pod_on_failure(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import sys, time\nimport os\n"
                   "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
                   "if rank == 1:\n    sys.exit(7)\ntime.sleep(60)\n")
    with pytest.raises(RuntimeError, match="exited with code 7"):
        _within(lambda: launch_mod.launch_collective(str(bad), [], nproc_per_node=2))


def test_gloo_abort_retried_until_success(tmp_path):
    marker = tmp_path / "aborted_once"
    script = tmp_path / "gloo_flaky.py"
    script.write_text(
        "import os, signal, sys\n"
        f"m = {str(marker)!r}\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "if rank == 1 and not os.path.exists(m):\n"
        "    open(m, 'w').close()\n"
        "    print(\"terminate called after throwing an instance of 'gloo::EnforceNotMet'\")\n"
        "    print('  what():  [enforce fail at gloo/transport/tcp/pair.cc:446] '\n"
        "          'op.preamble.length <= op.nbytes. 2048 vs 32')\n"
        "    sys.stdout.flush()\n"
        "    os.kill(os.getpid(), signal.SIGABRT)\n")
    rc = _within(lambda: launch_mod.launch_collective(
        str(script), [], nproc_per_node=2, log_dir=str(tmp_path / "logs"),
        transient_retries=2))
    assert rc == 0 and marker.exists()


def test_clean_nonzero_exit_not_retried(tmp_path):
    attempts = tmp_path / "attempts"
    script = tmp_path / "deterministic_fail.py"
    script.write_text(
        "import os, sys\n"
        f"d = {str(attempts)!r}\n"
        "os.makedirs(d, exist_ok=True)\n"
        "open(os.path.join(d, str(os.getpid())), 'w').close()\n"
        "sys.exit(7)\n")
    with pytest.raises(RuntimeError, match="exited with code 7"):
        _within(lambda: launch_mod.launch_collective(
            str(script), [], nproc_per_node=2, log_dir=str(tmp_path / "logs"),
            transient_retries=3))
    assert len(list(attempts.iterdir())) <= 2  # both ranks, one launch


def test_signal_death_without_signature_not_retried(tmp_path):
    script = tmp_path / "plain_abort.py"
    script.write_text(
        "import os, signal\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "if rank == 1:\n"
        "    os.kill(os.getpid(), signal.SIGABRT)\n")
    with pytest.raises(RuntimeError, match="code -6"):
        _within(lambda: launch_mod.launch_collective(
            str(script), [], nproc_per_node=2, log_dir=str(tmp_path / "logs"),
            transient_retries=3))


def test_elastic_restarts_pod_until_success(tmp_path):
    marker = tmp_path / "failed_once"
    script = tmp_path / "flaky.py"
    script.write_text(
        "import os, sys\n"
        f"m = {str(marker)!r}\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "if rank == 1 and not os.path.exists(m):\n"
        "    open(m, 'w').close()\n"
        "    sys.exit(3)\n")
    rc = _within(lambda: launch_mod.launch_elastic(str(script), nproc_per_node=2,
                                                   max_restarts=2))
    assert rc == 0 and marker.exists()


def test_elastic_exhausted_restarts_raise(tmp_path):
    script = tmp_path / "always_fail.py"
    script.write_text("import sys\nsys.exit(5)\n")
    with pytest.raises(RuntimeError, match="exhausted"):
        _within(lambda: launch_mod.launch_elastic(str(script), nproc_per_node=2,
                                                  max_restarts=1))


def test_chaos_kill_from_the_env_tears_the_pod_down(tmp_path):
    """PADDLE_TPU_CHAOS with rank=1, signum=9 at the second train.step hit:
    rank 1 dies, rank 0 (sleeping) is torn down, the launcher raises."""
    script = tmp_path / "loop.py"
    script.write_text(
        "import time\n"
        "from paddle_tpu_torch.resilience import chaos\n"
        "chaos.arm_from_env()\n"
        "for _ in range(3):\n"
        "    chaos.hit('train.step')\n"
        "time.sleep(60)\n")
    os.environ["PADDLE_TPU_ELASTIC_EXIT_GRACE"] = "1"
    try:
        with pytest.raises(RuntimeError, match="code -9"):
            _within(lambda: launch_mod.launch_collective(
                str(script), [], nproc_per_node=2,
                extra_env={"PADDLE_TPU_CHAOS": "site=train.step,signum=9,at=2,rank=1"}))
    finally:
        del os.environ["PADDLE_TPU_ELASTIC_EXIT_GRACE"]


# ------------------------------------------------------------ arm_from_env


SPECS = ["site=train.step,signum=15,at=6,rank=1;site=io,exc=OSError",
         "site=a,at=2,times=3,delay=0.5", "site=b,nan=1", " ; site=c,exc=ValueError ;",
         "site=d,rank=0", ""]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rank", [None, "0", "1"])
def test_arm_from_env_parses_as_the_reference(spec, rank):
    env = {"PADDLE_TPU_CHAOS": spec}
    if rank is not None:
        env["PADDLE_TRAINER_ID"] = rank

    def facts(mod):
        try:
            return [(f.site, f.at, f.times, f.delay, f.nan, f.signum,
                     None if f.exc is None else type(f.exc).__name__
                     if isinstance(f.exc, BaseException) else f.exc.__name__)
                    for f in mod.arm_from_env(env)]
        finally:
            mod.reset()

    assert facts(tchaos) == facts(jchaos)


@pytest.mark.parametrize("spec", ["at=2", "site=x,exc=SystemExit"])
def test_arm_from_env_refuses_as_the_reference(spec):
    for mod in (tchaos, jchaos):
        with pytest.raises(ValueError):
            mod.arm_from_env({"PADDLE_TPU_CHAOS": spec})
        mod.reset()


# ------------------------------------------------------------ entry points


def test_init_parallel_env_raises_without_a_card_unless_gloo_is_asked(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour is not observable")
    monkeypatch.delenv("PADDLE_DISTRI_BACKEND", raising=False)
    monkeypatch.delenv("PADDLE_COORDINATOR", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdist.init_parallel_env()
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "nccl")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdist.init_parallel_env()
    with pytest.raises(ValueError, match="nccl or gloo"):
        tdist.init_parallel_env(backend="mpi")
    # gloo asked for, in a process of its own: a one-rank mesh, no job
    env = tdist.init_parallel_env(backend="gloo")
    assert env.world_size == 1 and tdist.get_global_mesh().size == 1


def test_spawn_cpu_runs_each_rank_on_the_cpu_over_gloo(tmp_path):
    procs = tparallel.spawn(W.spawned, args=(str(tmp_path),), nprocs=2, join=False,
                            backend="cpu")
    try:
        for p in procs:
            p.join(W.RANK_TIMEOUT)
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    for r in (0, 1):
        got = json.load(open(tmp_path / f"spawned{r}.json"))
        assert got == dict(rank=r, world=2, sum=3.0, device="cpu", backend="gloo")
    seen = []
    tparallel.spawn(lambda: seen.append(1), nprocs=1)
    assert seen == [1]


# ------------------------------------------------------------ eager DataParallel


def test_eager_ddp_and_fleet_match_the_reference_full_batch(tmp_path):
    rc, log = W.run_ranks("eager_ddp", tmp_path)
    assert rc == 0, log[-6000:]
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in (0, 1)]
    init = {n: a for n, a in np.load(tmp_path / "init_ddp0.npz").items()}
    jpaddle.seed(5)
    model = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    model.set_state_dict({n: jpaddle.to_tensor(a) for n, a in init.items()})
    opt = jopt.SGD(0.1, parameters=model.parameters())
    mse = jnn.MSELoss()
    x = np.random.RandomState(0).rand(16, 8).astype(np.float32)
    y = np.random.RandomState(1).rand(16, 4).astype(np.float32)
    one_proc = []
    for _ in range(3):
        loss = mse(model(jpaddle.to_tensor(x)), jpaddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        one_proc.append(float(loss.numpy()))
    want = {n: p.numpy() for n, p in model.named_parameters()}
    for r in (0, 1):
        for how in ("ddp", "fleet", "fused"):
            losses = got[r]["fleet"]["losses"] if how == "fleet" else got[r][how]
            np.testing.assert_allclose(losses, one_proc, rtol=2e-5, atol=1e-6)
            for n, a in got[r][how + "_params"].items():
                np.testing.assert_allclose(np.asarray(a, np.float32), want[n], rtol=1e-5,
                                           atol=1e-6, err_msg=n)
                assert a == got[1 - r][how + "_params"][n]
        assert got[r]["fleet"]["worker_num"] == 2 and got[r]["fleet"]["worker_index"] == r
        assert got[r]["fleet"]["is_first_worker"] == (r == 0)
        assert got[r]["fleet"]["mode"] == "data"
    for how in ("ddp", "fleet", "fused"):
        for r in (0, 1):  # every rank starts from the same seeded weights
            for n, a in np.load(tmp_path / f"init_{how}{r}.npz").items():
                np.testing.assert_array_equal(a, init[n])


def test_gradient_merge_and_the_unported_modes_as_the_reference():
    """distributed_optimizer's HybridParallelOptimizer with gradient merge
    (k_steps 2) steps on every second call, the gradients accumulating:
    the same weights as the reference's after each call. In one process
    the port's fleet is one rank; the PS runtime and the pipe mode raise,
    naming their slice."""
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed import topology as jtopology
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet as tfleet

    def merging(fl):
        strategy = fl.DistributedStrategy()
        strategy.gradient_merge = True
        strategy.gradient_merge_configs = {"k_steps": 2}
        return strategy

    x = np.random.RandomState(2).rand(6, 3).astype(np.float32)
    saved = jtopology._GLOBAL_MESH, jtopology._HYBRID_GROUP
    try:
        jfleet.init(is_collective=True, strategy=merging(jfleet))
        jlin = jnn.Linear(3, 2)
        jo = jfleet.distributed_optimizer(jopt.SGD(0.1, parameters=jlin.parameters()))
        tfleet.init(is_collective=True, strategy=merging(tfleet))
        tlin = tnn.Linear(3, 2, device="cpu")
        with torch.no_grad():
            for p, q in zip(tlin.parameters(), jlin.parameters()):
                p.copy_(torch.from_numpy(np.array(q.numpy())))
        to = tfleet.distributed_optimizer(topt.SGD(0.1, parameters=tlin.parameters()))
        start = [p.detach().clone() for p in tlin.parameters()]
        for i in range(4):
            jloss = (jlin(jpaddle.to_tensor(x[i:i + 3])) ** 2).mean()
            jloss.backward()
            jo.step()
            jo.clear_grad()
            tloss = (tlin(torch.from_numpy(x[i:i + 3])) ** 2).mean()
            tloss.backward()
            to.step()
            to.clear_grad()
            for p, q in zip(tlin.parameters(), jlin.parameters()):
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(q.numpy()),
                                           rtol=1e-6, atol=1e-7)
            if i == 0:  # merged: no step on the first call
                assert all(torch.equal(p, s) for p, s in zip(tlin.parameters(), start))
    finally:
        jtopology._GLOBAL_MESH, jtopology._HYBRID_GROUP = saved
    assert not all(torch.equal(p, s) for p, s in zip(tlin.parameters(), start))
    assert tfleet.worker_num() == 1 and tfleet.worker_index() == 0 and tfleet.is_worker()
    assert tfleet.get_hybrid_communicate_group().get_parallel_mode() == "single"
    for fn, args in ((tfleet.set_ps_tables, ([],)), (tfleet.init_server, ()),
                     (tfleet.run_server, ()), (tfleet.stop_server, ()),
                     (tfleet.init_worker, ()), (tfleet.ps_client, ()), (tfleet.stop_worker, ())):
        with pytest.raises(NotImplementedError, match="parameter-server slice"):
            fn(*args)
    strategy = tfleet.DistributedStrategy()
    strategy.pipeline = True
    tfleet.init(is_collective=True, strategy=strategy)
    # the pipe mode wraps in PipelineParallel, as the reference's
    pp_model = tfleet.distributed_model(tnn.Linear(2, 2, device="cpu"))
    assert type(pp_model).__name__ == "PipelineParallel"
    tfleet.init(is_collective=True)
    assert isinstance(tfleet.distributed_model(tnn.Linear(2, 2, device="cpu")),
                      tdist.DataParallel)
