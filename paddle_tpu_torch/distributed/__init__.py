"""paddle.distributed (counterpart of paddle_tpu/distributed/; reference:
python/paddle/distributed/): the process topology, the collectives,
init_parallel_env with DataParallel, point-to-point transport, the
launcher, the training step over a data and tensor-parallel mesh with
ZeRO stages 1-3 (``spmd``, with ``build_fsdp_train_step``), the
communication-efficient modes (``comm_opt``: fp16 all-reduce, DGC,
LocalSGD), ZeRO's eager helpers (``sharding``), the model-parallel tier
(``meta_parallel``'s layers, the pipeline step in ``pipeline``,
``ring_attention``) and the collective half of the fleet facade.

The JAX package's names that later slices bring are absent here (see
tests/test_torch_top_level.py): the parameter server (``ps``, the fleet
``dataset``/``data_generator``, ``InMemoryDataset``, ``QueueDataset``,
``CountFilterEntry``, ``ProbabilityEntry``) and ``checkpoint``.
"""
from .parallel import (  # noqa: F401
    init_parallel_env, get_rank, get_world_size, ParallelEnv, DataParallel, spawn,
)
from .collective import (  # noqa: F401
    all_reduce, all_gather, broadcast, reduce, scatter, barrier, send, recv,
    all_to_all, alltoall_single, split, new_group, is_initialized, ReduceOp,
    Group, get_rank_in, psum, pmean, pmax, all_gather_spmd, ppermute,
    all_to_all_spmd,
)
from . import topology  # noqa: F401
from .topology import (  # noqa: F401
    HybridCommunicateGroup, CommunicateTopology, build_mesh, get_global_mesh,
    set_global_mesh,
)
from . import fleet  # noqa: F401
from . import spmd  # noqa: F401
from . import meta_parallel  # noqa: F401
from .spmd import build_train_step, shard_batch  # noqa: F401
from . import sharding  # noqa: F401
from . import comm_opt  # noqa: F401
# paddle.distributed.launch is a MODULE (python -m entry point), as in
# the reference; the programmatic API lives in launch_mod
from . import launch  # noqa: F401
from ..ops.ring_attention import ring_attention  # noqa: F401
