"""Goodput accounting (counterpart of paddle_tpu/obs/goodput.py :1-148,
the training half): useful step time against everything else.

The production training metric is not step throughput but the share of
wall-clock spent making forward progress: checkpoints, retries, rollbacks
and idle waits are throughput a preemption-prone fleet loses.

Categories:

    step        a useful training step (the numerator)
    checkpoint  save/restore I/O
    retry       backoff sleeps (resilience/retry.py feeds this)
    rollback    bad-step checkpoint restores
    serving     reply-seconds of in-deadline OK replies (the fleet router's;
                the reference's ServingGoodput is not ported yet)
    idle        wall-clock not covered by any recorded category

Use the context managers::

    acct = goodput.ACCOUNTANT
    with acct.step():        loss = train_step(...)

or feed measured durations with ``account(category, seconds)``.
``report()`` gives the goodput fraction; the same numbers are exported as
``paddle_goodput_seconds_total{category=...}`` through the port's metrics
registry.
"""
import contextlib
import threading
import time

from . import metrics as _metrics

CATEGORIES = ("step", "checkpoint", "retry", "rollback", "serving", "idle")

_SECONDS = _metrics.counter(
    "paddle_goodput_seconds_total",
    "Wall-clock seconds per goodput category (step = useful time)",
    labelnames=("category",))
_EVENTS = _metrics.counter(
    "paddle_goodput_events_total",
    "Recorded goodput events per category",
    labelnames=("category",))


class GoodputAccountant:
    """Thread-safe per-category time ledger.

    Wall-clock (for the idle residual) runs from the first recorded
    event to the last; a quiet accountant reports goodput 0.0 rather
    than inventing a denominator.
    """

    def __init__(self, export=True):
        self._lock = threading.Lock()
        self._totals = {c: 0.0 for c in CATEGORIES}
        self._counts = {c: 0 for c in CATEGORIES}
        self._t_first = None
        self._t_last = None
        self._export = export

    def account(self, category, seconds):
        if category not in CATEGORIES:
            raise ValueError(
                f"unknown goodput category {category!r} "
                f"(have {CATEGORIES})")
        seconds = max(0.0, float(seconds))
        now = time.monotonic()
        with self._lock:
            self._totals[category] += seconds
            self._counts[category] += 1
            if self._t_first is None:
                self._t_first = now - seconds
            self._t_last = now
        if self._export:
            _SECONDS.inc(seconds, category=category)
            _EVENTS.inc(category=category)

    @contextlib.contextmanager
    def _timed(self, category):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.account(category, time.perf_counter() - t0)

    def step(self):
        return self._timed("step")

    def checkpoint(self):
        return self._timed("checkpoint")

    def retry(self):
        return self._timed("retry")

    def rollback(self):
        return self._timed("rollback")

    def report(self):
        """-> {<cat>_s, steps, total_s, goodput}. ``idle_s`` is the
        first-to-last-event wall-clock not covered by any recorded
        category (plus anything accounted explicitly as idle)."""
        with self._lock:
            totals = dict(self._totals)
            steps = self._counts["step"]
            wall = ((self._t_last - self._t_first)
                    if self._t_first is not None else 0.0)
        accounted = sum(totals.values())
        idle = totals["idle"] + max(0.0, wall - accounted)
        total = max(wall, accounted)
        out = {f"{c}_s": round(totals[c], 6) for c in CATEGORIES}
        out["idle_s"] = round(idle, 6)
        out["steps"] = steps
        out["total_s"] = round(total, 6)
        out["goodput"] = round(totals["step"] / total, 6) if total else 0.0
        # the fleet-facing rate (bench.py goodput): useful steps per
        # wall-clock hour, the "ML Productivity Goodput" numerator
        out["steps_per_hour"] = (round(steps / total * 3600.0, 3)
                                 if total else 0.0)
        return out

    def reset(self):
        with self._lock:
            self._totals = {c: 0.0 for c in CATEGORIES}
            self._counts = {c: 0 for c in CATEGORIES}
            self._t_first = self._t_last = None


#: Default process accountant; the resilience runtime feeds it.
ACCOUNTANT = GoodputAccountant()


def account(category, seconds):
    ACCOUNTANT.account(category, seconds)


def report():
    return ACCOUNTANT.report()
