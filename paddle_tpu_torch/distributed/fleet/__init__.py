"""paddle.distributed.fleet, its collective half (counterpart of
paddle_tpu/distributed/fleet/; reference: python/paddle/distributed/
fleet/: fleet_base.py Fleet facade, base/distributed_strategy.py over
framework/distributed_strategy.proto:146-193).

The JAX package's parameter-server names (``data_generator``,
``dataset``, its datasets) are absent: a later slice brings them. The PS
runtime's functions are here and raise NotImplementedError. The
model-parallel layers come from ``distributed.meta_parallel``.
"""
from .distributed_strategy import DistributedStrategy  # noqa: F401
from . import metrics  # noqa: F401
from .util import UtilBase  # noqa: F401
from ..topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
)
from .fleet_base import (  # noqa: F401
    Fleet, init, distributed_optimizer, distributed_model, get_hybrid_communicate_group,
    worker_num, worker_index, is_worker, is_server, barrier_worker, _fleet_singleton,
)
from . import utils  # noqa: F401
from .role_maker import (  # noqa: F401
    Role, RoleMakerBase, PaddleCloudRoleMaker, UserDefinedRoleMaker,
)
from ..meta_parallel import (  # noqa: F401
    VocabParallelEmbedding, ColumnParallelLinear, RowParallelLinear,
    PipelineLayer, LayerDesc, SharedLayerDesc,
)
from ..meta_parallel.mp_layers import get_rng_state_tracker  # noqa: F401


def set_ps_tables(table_configs):
    return _fleet_singleton.set_ps_tables(table_configs)


def init_server(*a, **k):
    return _fleet_singleton.init_server(*a, **k)


def run_server(*a, **k):
    return _fleet_singleton.run_server(*a, **k)


def stop_server():
    return _fleet_singleton.stop_server()


def init_worker(*a, **k):
    return _fleet_singleton.init_worker(*a, **k)


def ps_client():
    return _fleet_singleton.ps_client()


def stop_worker():
    return _fleet_singleton.stop_worker()
