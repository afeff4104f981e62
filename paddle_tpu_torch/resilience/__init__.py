"""The fault-tolerant runtime of the port (counterpart of
paddle_tpu/resilience): :mod:`chaos` (deterministic fault injection), the
atomic file primitives of :mod:`checkpoint`, :mod:`preemption` (SIGTERM
to a resumable stop at a boundary) and :mod:`retry` (backoff with jitter
and a deadline). ``CheckpointManager``, ``badstep`` and ``elastic`` are not
ported yet (ROADMAP Queue 1)."""
from . import chaos  # noqa: F401
from . import preemption  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointCorrupt,
    atomic_write_bytes,
    atomic_write_json,
    file_sha256,
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
