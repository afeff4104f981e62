"""Bad-step guard (counterpart of paddle_tpu/resilience/badstep.py): never
let a NaN/Inf step reach the parameters.

Two layers, as in the reference:

1. on the device (:func:`guard_step`, or ``build_train_step(...,
   bad_step_guard=True)``, which selects inside the step before any value
   is written back): a non-finite loss or update keeps the previous
   params and optimizer state, with no read back to the host;
2. on the host (:class:`BadStepMonitor`): count consecutive bad steps;
   past a threshold, skipping is not enough, and the caller rolls back to
   the last good checkpoint of a ``CheckpointManager`` (:meth:`restore`).

``amp.GradScaler.attach_bad_step_monitor`` feeds the scaler's overflow
skips into the same count. Counters: ``paddle_badstep_bad_total`` and
``paddle_badstep_rollbacks_total``; a restore's time is goodput's
``rollback`` category.
"""
import time

import torch

from ..obs import goodput as _goodput
from ..obs import metrics as _obs
from .checkpoint import flatten_tree

OK = "ok"
SKIP = "skipped"
ROLLBACK = "rollback"

_BAD_STEPS = _obs.counter("paddle_badstep_bad_total", "Non-finite (skipped) training steps")
_ROLLBACKS = _obs.counter("paddle_badstep_rollbacks_total",
                          "Checkpoint rollbacks after consecutive bad steps")


def tree_nonfinite(tree):
    """0-d bool tensor: any non-finite value in any floating tensor of a
    nested dict/list/tuple (on the leaves' device; a CPU False where there
    is none)."""
    bad = None
    for leaf in flatten_tree(tree).values():
        if isinstance(leaf, torch.Tensor) and (leaf.is_floating_point() or leaf.is_complex()):
            b = ~torch.isfinite(leaf).all()
            bad = b if bad is None else bad | b.to(bad.device)
    return torch.zeros((), dtype=torch.bool) if bad is None else bad


def select_tree(bad, on_bad, on_good):
    """``torch.where(bad, b, g)`` leaf by leaf over two trees of one
    structure: the skip without a branch on the host. Leaves that are not
    tensors come from ``on_good``."""
    if isinstance(on_good, dict):
        return {k: select_tree(bad, on_bad[k], v) for k, v in on_good.items()}
    if isinstance(on_good, (list, tuple)):
        return type(on_good)(select_tree(bad, b, g) for b, g in zip(on_bad, on_good))
    if isinstance(on_good, torch.Tensor):
        return torch.where(bad.to(on_good.device), on_bad, on_good)
    return on_good


def guard_step(step_fn):
    """Wrap a functional step so that a bad step is a no-op.

    ``step_fn(params, opt_state, *rest) -> (loss, new_params, new_opt)``;
    the wrapper returns ``(loss, params', opt_state', bad)``, with
    params'/opt_state' the inputs where ``bad`` (a 0-d bool tensor). The
    inputs have to stay alive through the step: do not wrap a step that
    writes its inputs in place (``build_train_step(donate=True)``); use
    ``build_train_step(bad_step_guard=True)`` there, which selects before
    it writes."""

    def guarded(params, opt_state, *rest):
        loss, new_params, new_opt = step_fn(params, opt_state, *rest)
        bad = tree_nonfinite(loss) | tree_nonfinite(new_params)
        return (loss, select_tree(bad, params, new_params), select_tree(bad, opt_state, new_opt),
                bad)

    return guarded


class BadStepMonitor:
    """Consecutive-bad-step accounting and the rollback policy.

    ``record(bad) -> OK | SKIP | ROLLBACK``: after ``threshold``
    consecutive bad steps it returns ROLLBACK (and the streak starts over);
    the caller restores state, through :meth:`restore` when a manager is
    attached, and ``on_rollback()`` fires for any other recovery."""

    def __init__(self, threshold=3, manager=None, on_rollback=None):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.manager = manager
        self.on_rollback = on_rollback
        self.consecutive = 0
        self.total_bad = 0
        self.rollbacks = 0

    def record(self, bad):
        if not bool(bad):
            self.consecutive = 0
            return OK
        self.total_bad += 1
        self.consecutive += 1
        _BAD_STEPS.inc()
        if self.consecutive >= self.threshold:
            self.consecutive = 0
            self.rollbacks += 1
            _ROLLBACKS.inc()
            if self.on_rollback is not None:
                self.on_rollback()
            return ROLLBACK
        return SKIP

    def restore(self):
        """(state, step) of the attached manager's last good checkpoint
        (verified, with fallback)."""
        if self.manager is None:
            raise RuntimeError("BadStepMonitor has no CheckpointManager attached; pass "
                               "manager= to restore")
        t0 = time.perf_counter()
        state, step = self.manager.load()
        if state is None:
            raise RuntimeError(f"rollback requested but no usable checkpoint under "
                               f"{self.manager.root}")
        # the load records its own span; its time is the rollback's goodput loss
        _goodput.account("rollback", time.perf_counter() - t0)
        return state, step

    def state_dict(self):
        return {"consecutive": self.consecutive, "total_bad": self.total_bad,
                "rollbacks": self.rollbacks}
