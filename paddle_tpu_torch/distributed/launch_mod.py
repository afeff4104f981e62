"""Launcher (counterpart of paddle_tpu/distributed/launch_mod.py;
reference: python/paddle/distributed/fleet/launch.py:215
launch_collective, launch_utils.py:59 Cluster, :173 Pod, get_cluster:268,
watch_local_trainers:556, terminate_local_procs:309).

One process per rank, as the reference's one-proc-per-GPU trainers:
``nproc_per_node`` trainers on this node, each with a distinct global
rank in the ``PADDLE_*`` contract ``init_parallel_env`` reads. The JAX
package learns its devices from jax; the port takes Paddle's ``--gpus``
(``gpus=``: one card id per local rank, set as that rank's
``FLAGS_selected_gpus``) and ``--backend`` (``backend=``:
``PADDLE_DISTRI_BACKEND``, nccl or gloo). NCCL needs a card per rank, so
a launch that puts two nccl ranks on one card raises before it starts
them; two ranks may share a card over gloo.
"""
import os
import re
import signal
import socket
import subprocess
import sys
import time

# Known-transient trainer crash signatures, worth a bounded pod rerun
# (launch_collective transient_retries): gloo's TCP transport, which
# torch.distributed's gloo backend runs too, has a framing race on
# loopback — two collectives' payloads race on one pair and the size
# check aborts the process ("op.preamble.length <= op.nbytes",
# gloo/transport/tcp/pair.cc). The JAX package's third signature (the
# jax.distributed service's cascade) cannot occur without jax.
_TRANSIENT_RE = re.compile(r"op\.preamble\.length|gloo::EnforceNotMet")


def _failure_is_transient(err):
    """Is this pod failure worth a bounded relaunch? Only a trainer
    killed by a signal (negative returncode) qualifies — a clean nonzero
    sys.exit is deterministic — and when its log was captured, the crash
    must match a known-transient signature."""
    tp = getattr(err, "trainer", None)
    if tp is None or tp.proc.returncode is None or tp.proc.returncode >= 0:
        return False
    if tp.log_path and os.path.exists(tp.log_path):
        with open(tp.log_path, errors="replace") as f:
            return bool(_TRANSIENT_RE.search(f.read()))
    return True  # signal death, no log captured: assume transient


def find_free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


PREEMPT_EXIT = 143  # 128 + SIGTERM (resilience.preemption.EXIT_CODE)
# trainer exit codes that mean "preemption consensus in progress", not
# "pod is broken": the graceful save-exit, SIGTERM death (a rank that
# never reached a boundary), and SIGKILL (host loss — the survivors
# consensus-save around it)
_CONSENSUS_CODES = (PREEMPT_EXIT, -signal.SIGTERM, -signal.SIGKILL)


class PodPreempted(RuntimeError):
    """The pod exited through the preemption consensus: every rank
    finished with a consensus code (143 / signal death) within the
    grace window. Carries {rank: exit_code}; the caller resumes from
    the consensus checkpoint instead of treating this as a crash."""

    def __init__(self, codes):
        super().__init__(f"pod preempted (rank exit codes {codes})")
        self.codes = dict(codes)


class TrainerProc:
    def __init__(self, proc, rank, log_path=None):
        self.proc = proc
        self.rank = rank
        self.log_path = log_path


def get_cluster_env(rank, world_size, master, local_rank=0):
    """The PADDLE_* contract init_parallel_env reads (reference
    launch_utils.py pod env: PADDLE_TRAINER_ID/PADDLE_CURRENT_ENDPOINT/
    PADDLE_TRAINERS_NUM)."""
    env = dict(os.environ)
    env["PADDLE_TRAINER_ID"] = str(rank)
    env["PADDLE_TRAINERS_NUM"] = str(world_size)
    env["PADDLE_COORDINATOR"] = master
    env["PADDLE_LOCAL_RANK"] = str(local_rank)
    # Children must be able to import paddle_tpu_torch even when it isn't
    # pip-installed: prepend the repo root (parent of this package) to
    # PYTHONPATH, since the child's sys.path[0] is the script's dir.
    # Skip when installed into site-packages (importable anyway, and
    # prepending it would let it shadow the user's own PYTHONPATH).
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if os.path.basename(pkg_root) not in ("site-packages", "dist-packages"):
        prev = env.get("PYTHONPATH")
        env["PYTHONPATH"] = pkg_root + (os.pathsep + prev if prev else "")
    return env


def _raise_trainer_failure(procs, tp, ret):
    terminate_local_procs(procs)
    err = RuntimeError(f"trainer rank {tp.rank} exited with code {ret}")
    err.trainer = tp  # inspected by transient_retries
    raise err


def watch_local_trainers(procs, poll_interval=0.5, preempt_grace=None):
    """Block until all trainers exit (reference: launch_utils.py:556).

    A hard failure (any exit code outside {0, 143, -SIGTERM, -SIGKILL})
    still tears the pod down immediately. A CONSENSUS code instead opens
    a grace window (``preempt_grace`` seconds, default env
    PADDLE_TPU_ELASTIC_EXIT_GRACE or 30): the other ranks are mid
    consensus-save and must be allowed to publish the shared checkpoint
    and exit 143 themselves — killing them rank-by-rank is exactly the
    torn-checkpoint failure the consensus exists to prevent. When every
    rank lands on a consensus code, raises :class:`PodPreempted`."""
    if preempt_grace is None:
        try:
            preempt_grace = float(os.environ.get(
                "PADDLE_TPU_ELASTIC_EXIT_GRACE", 30.0))
        except ValueError:
            preempt_grace = 30.0
    grace_deadline = None
    first_signal_death = None  # (tp, ret) that opened the grace window
    try:
        while True:
            alive = False
            preempting = False
            saw_143 = False
            for tp in procs:
                ret = tp.proc.poll()
                if ret is None:
                    alive = True
                elif ret in _CONSENSUS_CODES:
                    preempting = True
                    if ret == PREEMPT_EXIT:
                        saw_143 = True
                    elif first_signal_death is None:
                        first_signal_death = (tp, ret)
                elif ret != 0:
                    _raise_trainer_failure(procs, tp, ret)
            if not alive:
                if preempting:
                    raise PodPreempted({tp.rank: tp.proc.returncode
                                        for tp in procs})
                return 0
            if preempting:
                now = time.time()
                if grace_deadline is None:
                    grace_deadline = now + preempt_grace
                elif now >= grace_deadline:
                    if not saw_143 and first_signal_death is not None:
                        # no rank ever produced a graceful 143: this
                        # was a plain signal kill (OOM killer, operator
                        # SIGKILL) on a pod not running the consensus —
                        # classify it as the original trainer failure
                        # so transient_retries keeps working
                        tp, ret = first_signal_death
                        _raise_trainer_failure(procs, tp, ret)
                    terminate_local_procs(procs)
                    raise RuntimeError(
                        f"preemption consensus exit timed out: ranks "
                        f"{[tp.rank for tp in procs if tp.proc.poll() is None]}"
                        f" still running {preempt_grace:.0f}s after the "
                        "first preempted rank exited")
                time.sleep(min(poll_interval, 0.1))
                continue
            time.sleep(poll_interval)
    except KeyboardInterrupt:
        terminate_local_procs(procs)
        raise


def terminate_local_procs(procs, grace=3.0):
    """reference: launch_utils.py:309."""
    for tp in procs:
        if tp.proc.poll() is None:
            tp.proc.terminate()
    deadline = time.time() + grace
    for tp in procs:
        while tp.proc.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        if tp.proc.poll() is None:
            tp.proc.send_signal(signal.SIGKILL)


def _fresh_log_path(log_dir, rank, attempt):
    """Per-attempt workerlogs that also survive the PREEMPTION path: a
    resumed pod reuses the same log_dir, and reopening workerlog.N with
    "w" would truncate the preempted incarnation's evidence — pick the
    next free .rK name instead of overwriting."""
    suffix = f".attempt{attempt}" if attempt else ""
    base = f"workerlog.{rank}{suffix}"
    log_path = os.path.join(log_dir, base)
    k = 0
    while os.path.exists(log_path) and os.path.getsize(log_path) > 0:
        k += 1
        log_path = os.path.join(log_dir, f"{base}.r{k}")
    return log_path


def _rank_envs(nproc_per_node, node_rank, world, rdv, elastic_coord, extra_env, gpus,
               backend):
    """Each local rank's environment; raises before any rank starts when
    two nccl ranks would share a card."""
    if gpus is not None:
        gpus = [str(g).strip() for g in (gpus.split(",") if isinstance(gpus, str) else gpus)]
        if len(gpus) != nproc_per_node:
            raise ValueError(f"gpus {gpus} names {len(gpus)} cards for {nproc_per_node} "
                             "ranks on this node")
    envs = []
    for local_rank in range(nproc_per_node):
        rank = node_rank * nproc_per_node + local_rank
        env = get_cluster_env(rank, world, rdv, local_rank)
        env["PADDLE_TPU_ELASTIC_COORD"] = elastic_coord
        if gpus is not None:
            env["FLAGS_selected_gpus"] = gpus[local_rank]
        if backend is not None:
            env["PADDLE_DISTRI_BACKEND"] = backend
        if extra_env:
            env.update({k: str(v) for k, v in extra_env.items()})
        envs.append(env)
    from .parallel import ParallelEnv

    cards = [ParallelEnv(env).dev_id for env in envs]
    nccl = [e.get("PADDLE_DISTRI_BACKEND", "nccl") == "nccl" for e in envs]
    if any(nccl) and len(set(cards)) < len(cards):
        raise ValueError(
            f"the ranks of this node map to cards {cards}: NCCL needs a card per rank "
            "(it refuses two ranks on one device), so give each rank its own card "
            "(--gpus) or share a card over gloo (--backend gloo)")
    return envs


def launch_collective(script, args=(), nproc_per_node=1, nnodes=1,
                      node_rank=0, master=None, log_dir=None,
                      extra_env=None, transient_retries=0, gpus=None, backend=None):
    """Spawn nproc_per_node trainer processes on this node and watch them
    (reference: launch.py:215 launch_collective).

    ``transient_retries`` bounds a rerun of the whole pod when a trainer
    is killed by a signal with a known-transient crash signature in its
    log (the gloo TCP framing race aborts a CPU worker ~50% of the time
    on this box — see _TRANSIENT_RE). A clean nonzero exit is
    deterministic and never retried. Each attempt rendezvouses on a
    fresh master port unless the caller pinned one.

    Preemption contract: each attempt also publishes a fresh elastic
    coordinator address (PADDLE_TPU_ELASTIC_COORD, unless the caller
    pinned one via extra_env) so the trainers can run the multi-host
    preemption consensus; a SIGTERM delivered to THIS launcher is
    forwarded to every trainer, and the watcher then waits for the
    consensus exit (all ranks 143) instead of letting the pod die
    rank-by-rank — surfaced as :class:`PodPreempted`, never retried.

    ``gpus`` (a list, or Paddle's comma string): each local rank's card,
    its ``FLAGS_selected_gpus``; ``backend``: nccl or gloo, each rank's
    ``PADDLE_DISTRI_BACKEND`` (unset: nccl). ``extra_env`` is applied
    last. Two nccl ranks on one card raise ValueError before any rank
    starts."""
    world = nnodes * nproc_per_node
    for attempt in range(int(transient_retries) + 1):
        rdv = master or f"127.0.0.1:{find_free_port()}"
        coord_host = rdv.rsplit(":", 1)[0]
        elastic_coord = f"{coord_host}:{find_free_port()}"
        procs = []
        envs = _rank_envs(nproc_per_node, node_rank, world, rdv, elastic_coord, extra_env,
                          gpus, backend)
        for local_rank, env in enumerate(envs):
            rank = node_rank * nproc_per_node + local_rank
            stdout = None
            log_path = None
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                log_path = _fresh_log_path(log_dir, rank, attempt)
                stdout = open(log_path, "w")
            proc = subprocess.Popen(
                [sys.executable, script, *map(str, args)],
                env=env, stdout=stdout,
                stderr=subprocess.STDOUT if stdout else None)
            if stdout is not None:
                stdout.close()  # the child owns the fd now
            procs.append(TrainerProc(proc, rank, log_path))
        # forward a SIGTERM aimed at the launcher to the whole pod: the
        # trainers run the preemption consensus and exit 143 together,
        # and the watcher below waits for exactly that
        prev_term = None
        forwarded = {"done": False}

        def _forward_sigterm(signum, frame, _procs=procs):
            if not forwarded["done"]:
                forwarded["done"] = True
                for tp in _procs:
                    if tp.proc.poll() is None:
                        try:
                            tp.proc.send_signal(signal.SIGTERM)
                        except OSError:
                            pass
            if callable(prev_term) and prev_term not in (
                    signal.SIG_DFL, signal.SIG_IGN):
                prev_term(signum, frame)

        try:
            prev_term = signal.signal(signal.SIGTERM, _forward_sigterm)
        except (ValueError, OSError):
            prev_term = None  # non-main thread: no forwarding, still works
        try:
            return watch_local_trainers(procs)
        except PodPreempted:
            raise  # consensus exit: resumable, never a retryable crash
        except RuntimeError as e:
            if attempt >= transient_retries or not _failure_is_transient(e):
                raise
            print(f"[launch] transient trainer crash (attempt "
                  f"{attempt + 1}/{transient_retries + 1}): {e}; "
                  "relaunching pod", file=sys.stderr, flush=True)
        finally:
            if prev_term is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_term)
                except (ValueError, OSError):
                    pass


def launch_elastic(script, args=(), nproc_per_node=1, nnodes=1,
                   node_rank=0, log_dir=None, max_restarts=3,
                   extra_env=None, master_fn=None, gpus=None, backend=None):
    """Elastic supervision (reference: DistributedStrategy.elastic +
    launch_utils respawn; this rev of the reference also restarts whole
    pods rather than hot-swapping ranks): on any trainer failure the pod
    is torn down (watch_local_trainers) and relaunched with a FRESH
    rendezvous master, up to max_restarts times.

    Single-node only unless ``master_fn`` is given: each attempt needs a
    NEW coordinator that every node agrees on, so multi-node callers must
    supply ``master_fn(attempt) -> "host:port"`` (an external
    rendezvous); without it nnodes>1 raises.

    A pod that exits through the preemption consensus raises
    :class:`PodPreempted` at once: its checkpoint is the one to resume
    from, and a relaunch would only train past the preemption (the JAX
    package's ``launch_elastic`` relaunches it as a failure)."""
    if nnodes > 1 and master_fn is None:
        raise ValueError(
            "launch_elastic with nnodes>1 needs master_fn(attempt) so all "
            "nodes rendezvous on the same fresh coordinator per restart")
    last_err = None
    for attempt in range(int(max_restarts) + 1):
        master = master_fn(attempt) if master_fn is not None else None
        try:
            return launch_collective(script, args, nproc_per_node, nnodes,
                                     node_rank, master=master,
                                     log_dir=log_dir, extra_env=extra_env,
                                     gpus=gpus, backend=backend)
        except PodPreempted:
            raise  # a consensus exit: the caller resumes, nothing is retried
        except RuntimeError as e:
            last_err = e
            print(f"[elastic] pod failed (attempt {attempt + 1}/"
                  f"{max_restarts + 1}): {e}", file=sys.stderr, flush=True)
    raise RuntimeError(
        f"elastic launch exhausted {max_restarts} restarts") from last_err


def launch(script=None, args=(), nnodes=1, node_rank=0, master=None,
           nproc_per_node=1, log_dir=None):
    return launch_collective(script, args, nproc_per_node, nnodes,
                             node_rank, master, log_dir)


def main():
    import argparse

    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=int(os.environ.get(
        "PADDLE_TRAINER_ID", 0)))
    p.add_argument("--master", default=os.environ.get("PADDLE_MASTER"))
    p.add_argument("--log_dir", default=None)
    p.add_argument("--gpus", default=None,
                   help="each local rank's card, comma separated (0,0 puts two ranks on "
                        "card 0: gloo only); sets --nproc_per_node to its length")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="the ranks' torch.distributed backend (default nccl)")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    ns = p.parse_args()
    nproc = ns.nproc_per_node
    if ns.gpus is not None:
        nproc = len(ns.gpus.split(","))
    try:
        launch_collective(ns.script, ns.script_args, nproc,
                          ns.nnodes, ns.node_rank, ns.master, ns.log_dir,
                          gpus=ns.gpus, backend=ns.backend)
    except PodPreempted as e:
        # propagate the conventional preempted status so the scheduler
        # reschedules the (resumable) job instead of marking it failed
        print(f"[launch] {e}", file=sys.stderr, flush=True)
        sys.exit(PREEMPT_EXIT)


if __name__ == "__main__":
    main()
