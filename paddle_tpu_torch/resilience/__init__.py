"""The fault-tolerant runtime of the port (counterpart of
paddle_tpu/resilience): :mod:`chaos` (deterministic fault injection),
:mod:`checkpoint` (atomic, self-verifying checkpoints with retention and
a verified load with fallback: ``CheckpointManager``), :mod:`badstep` (the
NaN/Inf step guard and the consecutive-bad-step rollback policy:
``BadStepMonitor``), :mod:`preemption` (SIGTERM to a resumable stop at a
boundary), :mod:`retry` (backoff with jitter and a deadline) and
:mod:`elastic` (pod-scale preemption consensus, straggler detection and
dead-host recovery over a small TCP coordinator:
``elastic.init_from_env``)."""
from . import chaos  # noqa: F401
from . import elastic  # noqa: F401
from . import preemption  # noqa: F401
from .badstep import BadStepMonitor, guard_step, select_tree, tree_nonfinite  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointCorrupt,
    CheckpointManager,
    atomic_write_bytes,
    atomic_write_json,
    file_sha256,
    leaf_checksums,
)
from .elastic import (  # noqa: F401
    CoordinatorLost,
    ElasticClient,
    ElasticCoordinator,
    LocalElastic,
)
from .preemption import (  # noqa: F401
    EXIT_CODE as PREEMPTED_EXIT_CODE,
    PreemptedExit,
    PreemptionHandler,
    clear_resume_marker,
    get_preemption_handler,
    preemption_requested,
    read_resume_marker,
    resolve_resume_step,
    write_resume_marker,
)
from .retry import RetryError, backoff_delays, call_with_retry, retry  # noqa: F401
