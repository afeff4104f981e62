"""Preemption handling: save and exit at the next safe boundary
(counterpart of paddle_tpu/resilience/preemption.py).

Preemptible clusters deliver SIGTERM (maintenance events, spot reclaim,
eviction) with a grace window. The handler only notes the request (an
Event, async-signal-safe); the training loop finishes its step, saves,
writes a resumable marker and stops. ``hapi.Model.fit`` stops at the batch
boundary, writes the marker and returns; ``fit(resume=True)`` restarts from
the last completed epoch and clears it. Tests inject the signal with
``resilience.chaos`` (``signum=SIGTERM``).
"""
import json
import os
import signal
import threading

from ..obs import metrics as _obs

MARKER_NAME = "PREEMPTED.json"

_PREEMPTION_SAVES = _obs.counter(
    "paddle_preemption_saves_total",
    "Preemption save-and-exit markers written (resumable shutdowns)")
EXIT_CODE = 143  # 128 + SIGTERM — what a scheduler expects from a
                 # gracefully preempted worker


class PreemptedExit(SystemExit):
    """Raised at a step/epoch boundary after the preemption checkpoint
    is on disk; carries the conventional exit status."""

    def __init__(self, step=None):
        super().__init__(EXIT_CODE)
        self.step = step


def _chainable(prev):
    """Is a pre-existing handler worth chaining? Only a real callable
    the application installed — the stock dispositions (SIG_DFL,
    SIG_IGN, Python's default KeyboardInterrupt raiser) are what this
    handler deliberately replaces."""
    return (callable(prev) and prev not in (signal.SIG_DFL, signal.SIG_IGN)
            and prev is not signal.default_int_handler)


class PreemptionHandler:
    """Signal handler that records a preemption request.

    The handler only sets a flag (async-signal-safe); training loops
    poll `requested` at boundaries and perform the save/exit themselves.
    install() is idempotent, and a pre-existing NON-DEFAULT handler is
    chained (called after the flag is set) rather than silently
    overwritten — a cluster agent's own SIGTERM bookkeeping keeps
    running. uninstall() restores the previous handlers.
    """

    def __init__(self):
        self._requested = threading.Event()
        self._prev = {}
        self._installed = False
        self.signum = None  # which signal fired (telemetry)

    def install(self, signals=(signal.SIGTERM, signal.SIGINT)):
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal only works on the main thread
        for s in signals:
            if s in self._prev:
                continue  # idempotent per signal
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except (ValueError, OSError):  # non-main thread / exotic env
                pass
        self._installed = True
        return self

    def uninstall(self):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}
        self._installed = False

    def _on_signal(self, signum, frame):
        self.signum = signum
        self._requested.set()
        prev = self._prev.get(signum)
        if _chainable(prev) and prev is not self._on_signal:
            prev(signum, frame)

    @property
    def requested(self):
        return self._requested.is_set()

    def request(self):
        """Programmatic preemption (tests, cluster agents polling a
        maintenance-event API instead of a signal)."""
        self._requested.set()

    def clear(self):
        self._requested.clear()
        self.signum = None


_handler = None
_handler_lock = threading.Lock()


def get_preemption_handler():
    global _handler
    with _handler_lock:
        if _handler is None:
            _handler = PreemptionHandler()
        return _handler


def install(signals=(signal.SIGTERM, signal.SIGINT)):
    return get_preemption_handler().install(signals)


def preemption_requested():
    return _handler is not None and _handler.requested


# ----------------------------------------------------------------- markers

def write_resume_marker(save_dir, step=None, extra=None, world_size=None):
    """Atomically record "this run was preempted after saving at
    `step`" so the restart knows the checkpoint is resumable (and
    schedulers/tooling can distinguish preemption from a crash).
    world_size (default: the PADDLE_TRAINERS_NUM env, when set) lets
    the restart detect a marker written by a different slice shape."""
    from .checkpoint import atomic_write_json

    if world_size is None:
        try:
            world_size = int(os.environ.get("PADDLE_TRAINERS_NUM") or 0)
        except ValueError:
            world_size = 0
        world_size = world_size or None
    payload = {"preempted": True, "step": step}
    if world_size is not None:
        payload["world_size"] = int(world_size)
    if extra:
        payload.update(extra)
    os.makedirs(save_dir, exist_ok=True)
    path = atomic_write_json(os.path.join(save_dir, MARKER_NAME), payload)
    _PREEMPTION_SAVES.inc()
    return path


def read_resume_marker(save_dir):
    try:
        with open(os.path.join(save_dir, MARKER_NAME)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def clear_resume_marker(save_dir):
    try:
        os.remove(os.path.join(save_dir, MARKER_NAME))
    except OSError:
        pass


def resolve_resume_step(save_dir, available_step=None, world_size=None):
    """Reconcile the resume marker against what is actually on disk.

    The marker is a HINT, not the source of truth — the verified
    checkpoint store is. Edge cases this resolves (all warn rather than
    crash, because a restart must always make progress):

    - marker present but the checkpoint it names is missing/corrupt:
      resume from ``available_step`` (the newest step the store could
      verify — CheckpointManager.load's fallback result);
    - marker step ahead of the store's LATEST (the marker write raced a
      crash after an unpublished save): clamp to ``available_step``;
    - marker written by a different world size: trust the step (the
      sharded store reshards on load) but surface the mismatch so
      non-reshardable callers can start clean instead.

    Returns ``(step, info)``: ``step`` is the boundary to resume from
    (``available_step`` when the marker is unusable, ``None`` when
    neither exists), ``info`` carries ``marker``, ``stale_world`` and
    ``clamped`` flags for the caller's logging.
    """
    import warnings

    marker = read_resume_marker(save_dir)
    info = {"marker": marker, "stale_world": False, "clamped": False}
    if marker is None:
        return available_step, info
    mstep = marker.get("step")
    mworld = marker.get("world_size")
    if (world_size is not None and mworld is not None
            and int(mworld) != int(world_size)):
        info["stale_world"] = True
        warnings.warn(
            f"resume marker in {save_dir} was written by world_size="
            f"{mworld}, resuming with world_size={world_size}: valid only "
            "if the checkpoint store reshards on load")
    if mstep is None:
        return available_step, info
    if available_step is None:
        info["clamped"] = True
        warnings.warn(
            f"resume marker names step {mstep} but no usable checkpoint "
            f"exists in {save_dir}; starting clean")
        return None, info
    if int(mstep) > int(available_step):
        info["clamped"] = True
        warnings.warn(
            f"resume marker names step {mstep} but the newest verified "
            f"checkpoint is step {available_step} (marker ahead of "
            "LATEST, or the checkpoint it names was lost); resuming from "
            f"{available_step}")
        return available_step, info
    return int(mstep), info
