"""Process environment and dygraph DataParallel (counterpart of
paddle_tpu/distributed/parallel.py; reference: python/paddle/distributed/
parallel.py:57 init_parallel_env, python/paddle/fluid/dygraph/
parallel.py:380 DataParallel; C++ imperative/reducer.cc).

One process per rank. ``init_parallel_env`` reads the reference's
``PADDLE_*`` contract (which the launcher sets), makes the job's c10d
``TCPStore`` on ``PADDLE_COORDINATOR`` and ``torch.distributed``'s
process group over it, and sets a data-parallel ``Mesh`` of every rank
as the global mesh. The backend is the caller's: ``backend=``, else
``PADDLE_DISTRI_BACKEND`` (the launcher's ``--backend``), else nccl.
Nothing moves to gloo or to the CPU on its own: nccl without a card
raises, and gloo runs each rank on its card where there is one
(``FLAGS_selected_gpus``), on the CPU where there is none.
"""
import datetime
import os

import torch
import torch.distributed as dist
import torch.profiler

from ..nn.layer import Layer
from . import collective, topology

_STORE = None


class ParallelEnv:
    """reference: dygraph/parallel.py ParallelEnv (the PADDLE_* env).
    ``env``: the environment to read (a launcher reads its ranks'),
    else this process's."""

    def __init__(self, env=None):
        env = os.environ if env is None else env
        self._rank = int(env.get("PADDLE_TRAINER_ID") or get_rank())
        self._world_size = int(env.get("PADDLE_TRAINERS_NUM") or get_world_size())
        self._local_rank = int(env.get("PADDLE_LOCAL_RANK") or 0)
        # Paddle's FLAGS_selected_gpus: this rank's cards, the first used
        gpus = (env.get("FLAGS_selected_gpus") or "").split(",")[0].strip()
        self._device_id = int(gpus) if gpus else self._local_rank
        self._endpoints = env

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def nranks(self):
        return self._world_size

    @property
    def dev_id(self):
        return self._device_id

    @property
    def current_endpoint(self):
        return self._endpoints.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        return self._endpoints.get("PADDLE_TRAINER_ENDPOINTS", "127.0.0.1:6170").split(",")


def store():
    """The job's c10d store (made by ``init_parallel_env``), or None."""
    return _STORE


def _transient(e):
    """Rendezvous errors worth waiting out: refused or timed-out
    connections while the coordinator's store binds. Configuration
    errors (a bad address, a second init) surface at once."""
    if not isinstance(e, RuntimeError):
        return True
    msg = str(e)
    return any(s in msg for s in ("Connection refused", "connect", "Connect", "timed out",
                                  "Timed out", "unavailable", "UNAVAILABLE"))


def init_parallel_env(backend=None):
    """reference: distributed/parallel.py:57 (the JAX package's
    jax.distributed.initialize). With ``PADDLE_COORDINATOR`` set, joins
    the job of ``PADDLE_TRAINERS_NUM`` ranks as rank ``PADDLE_TRAINER_ID``
    (a one-rank job too: the nccl route on one card); the rendezvous is
    retried as the reference's (call_with_retry with the
    ``PADDLE_TPU_DIST_INIT_DEADLINE`` deadline, connection errors only).
    Then sets the global mesh, dp over every rank. Returns ParallelEnv()."""
    global _STORE
    backend = backend or os.environ.get("PADDLE_DISTRI_BACKEND") or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_parallel_env: backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_parallel_env: backend nccl needs a CUDA card and this "
                           "process sees no CUDA card; ask for backend='gloo' (or "
                           "PADDLE_DISTRI_BACKEND=gloo) to run the ranks on the CPU")
    env = ParallelEnv()
    if torch.cuda.is_available():
        torch.cuda.set_device(env.dev_id)
    coordinator = os.environ.get("PADDLE_COORDINATOR")
    if coordinator and not dist.is_initialized():
        from ..resilience.retry import call_with_retry

        n = int(os.environ.get("PADDLE_TRAINERS_NUM") or 1)
        rank = int(os.environ.get("PADDLE_TRAINER_ID") or 0)
        host, port = coordinator.rsplit(":", 1)
        deadline = float(os.environ.get("PADDLE_TPU_DIST_INIT_DEADLINE", 300.0))

        def rendezvous():
            s = dist.TCPStore(host, int(port), n, rank == 0,
                              timeout=datetime.timedelta(seconds=deadline))
            dist.init_process_group(backend, store=s, rank=rank, world_size=n)
            return s

        _STORE = call_with_retry(
            rendezvous, retry_on=(OSError, ConnectionError, TimeoutError, RuntimeError),
            retry_if=_transient, max_attempts=5, base_delay=1.0, max_delay=10.0,
            deadline=deadline)
    topology.set_global_mesh(topology.build_mesh(dp=get_world_size()))
    return ParallelEnv()


def get_rank(group=None):
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_world_size(group=None):
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DataParallel(Layer):
    """reference: dygraph/parallel.py:380 + reducer.cc's allreduce. Each
    rank runs its local forward and backward (with its own RNG state, as
    the reference's eager ranks do); ``apply_collective_grads`` then
    averages every gradient over the group, one coalesced all-reduce per
    dtype (reducer.cc's fused buckets, one bucket per dtype), so each
    rank's optimizer steps on the global batch's gradient. ``scale_loss``
    is the identity, as in the reference."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25, last_comm_buffer_size=1,
                 find_unused_parameters=False, group=None):
        super().__init__()
        self._layers = layers
        self._group = group
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        grads = [p.grad for p in torch.nn.Module.parameters(self._layers)
                 if p.grad is not None]
        with torch.profiler.record_function("DataParallel.apply_collective_grads"):
            collective.coalesced_mean(grads, self._group)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    @property
    def parameters_attr(self):
        return self._layers.parameters()

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)


def _spawn_target(func, args, rank, nprocs, master, backend):
    # a fresh interpreter (spawn context): the cluster env first, then
    # user code, which calls init_parallel_env() as in the reference
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    os.environ["PADDLE_COORDINATOR"] = master
    os.environ["PADDLE_LOCAL_RANK"] = str(rank)
    if backend == "cpu":
        # each rank on the CPU over gloo (the JAX package's one CPU device a rank)
        os.environ["PADDLE_DISTRI_BACKEND"] = "gloo"
        from ..core import place

        place.set_device("cpu")
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, backend=None, **options):
    """reference: distributed/spawn.py:317. nprocs <= 1: a direct call.
    nprocs > 1: one process per rank (spawn context) on a fresh
    coordinator; ``func`` calls init_parallel_env() first, as in the
    reference. ``backend="cpu"`` puts each rank on the CPU over gloo;
    otherwise each rank takes ``init_parallel_env``'s backend."""
    if nprocs is None or nprocs <= 1:
        func(*args)
        return None
    import multiprocessing as mp

    from .launch_mod import find_free_port

    ctx = mp.get_context("spawn")
    master = f"127.0.0.1:{find_free_port()}"
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_spawn_target, args=(func, args, rank, nprocs, master, backend),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if not join:
        return procs
    for p in procs:
        p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawned trainers failed with exit codes {bad}")
    return None
