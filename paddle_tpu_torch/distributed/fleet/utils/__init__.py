"""fleet.utils (counterpart of paddle_tpu/distributed/fleet/utils/;
reference: fleet/utils/: recompute.py, hybrid_parallel_util.py, fs.py)."""
from .recompute import recompute  # noqa: F401
from .fs import LocalFS, HDFSClient  # noqa: F401
from .hybrid_parallel_util import (  # noqa: F401
    fused_allreduce_gradients, broadcast_mp_parameters, broadcast_dp_parameters,
)
