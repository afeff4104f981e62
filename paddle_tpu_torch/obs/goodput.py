"""Goodput accounting (counterpart of paddle_tpu/obs/goodput.py): useful
step time against everything else, and the serving ledger of a fleet's
replies (``ServingGoodput``).

The production training metric is not step throughput but the share of
wall-clock spent making forward progress: checkpoints, retries, rollbacks
and idle waits are throughput a preemption-prone fleet loses.

Categories:

    step        a useful training step (the numerator)
    checkpoint  save/restore I/O
    retry       backoff sleeps (resilience/retry.py feeds this)
    rollback    bad-step checkpoint restores
    serving     reply-seconds of in-deadline OK replies (the fleet router's
                ``SERVING_LEDGER`` feeds it)
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


# --------------------------------------------------------------- serving
# Reply outcomes the fleet router records. "ok" is the goodput
# numerator: the reply arrived AND met its deadline (or carried none).
SERVING_OUTCOMES = ("ok", "late", "shed", "error")

_SERVING_SECONDS = _metrics.counter(
    "paddle_serving_goodput_seconds_total",
    "Reply-service seconds per tenant and outcome (ok = in-deadline)",
    labelnames=("tenant", "outcome"))
_SERVING_REPLIES = _metrics.counter(
    "paddle_serving_replies_total",
    "Fleet replies per tenant and outcome",
    labelnames=("tenant", "outcome"))
_SERVING_TOKENS = _metrics.counter(
    "paddle_serving_goodput_tokens_total",
    "Streamed tokens per tenant and outcome (the token-streaming "
    "workload's goodput unit: a reply is many tokens, so tenant SLO "
    "accounting must count tokens, not replies)",
    labelnames=("tenant", "outcome"))


class ServingGoodput:
    """Serving-side goodput ledger ("ML Productivity Goodput" applied
    to a reply fleet): the fraction of fleet reply-seconds spent on
    replies that met their deadline, broken down per tenant.

    The router records one event per finished request::

        SERVING_LEDGER.record("tenant-a", "ok", seconds=0.012)

    Streaming decode replies additionally carry their token count —
    the unit tenant SLO accounting uses for token workloads (one
    streamed reply is hundreds of tokens; counting replies would let
    a tenant's one giant stream look equal to another's one tiny
    one)::

        SERVING_LEDGER.record("tenant-a", "ok", seconds=1.2, tokens=128)

    ``report()`` gives the fleet goodput fraction plus per-tenant
    reply/deadline-hit counts and token totals (``goodput_tokens`` =
    in-SLO tokens over all streamed tokens); the same numbers export
    as ``paddle_serving_goodput_seconds_total{tenant,outcome}`` /
    ``paddle_serving_replies_total{tenant,outcome}`` /
    ``paddle_serving_goodput_tokens_total{tenant,outcome}``. Every
    in-deadline OK reply's service time is also fed to the process
    accountant's ``serving`` category, so one `goodput.report()` spans
    training and serving."""

    def __init__(self, export=True, accountant=None):
        self._lock = threading.Lock()
        self._data = {}  # tenant -> {outcome: [count, seconds, tokens]}
        self._export = export
        self._accountant = accountant

    def record(self, tenant, outcome, seconds=0.0, tokens=0):
        if outcome not in SERVING_OUTCOMES:
            raise ValueError(f"unknown serving outcome {outcome!r} "
                             f"(have {SERVING_OUTCOMES})")
        tenant = str(tenant)
        seconds = max(0.0, float(seconds))
        tokens = max(0, int(tokens))
        with self._lock:
            cell = self._data.setdefault(
                tenant,
                {o: [0, 0.0, 0] for o in SERVING_OUTCOMES})[outcome]
            cell[0] += 1
            cell[1] += seconds
            cell[2] += tokens
        if self._export:
            _SERVING_SECONDS.inc(seconds, tenant=tenant, outcome=outcome)
            _SERVING_REPLIES.inc(tenant=tenant, outcome=outcome)
            if tokens:
                _SERVING_TOKENS.inc(tokens, tenant=tenant,
                                    outcome=outcome)
        if outcome == "ok":
            (self._accountant or ACCOUNTANT).account("serving", seconds)

    def report(self):
        """-> {goodput, ok/late/shed/error totals, tenants: {name:
        {replies, ok, late, shed, error, seconds, ok_seconds,
        deadline_hit_rate}}}. ``goodput`` is ok-seconds over all
        reply-seconds; ``deadline_hit_rate`` is ok replies over all
        *answered* replies plus sheds (an error or shed is a miss, by
        construction — a request the fleet failed to answer usefully)."""
        with self._lock:
            data = {t: {o: list(c) for o, c in per.items()}
                    for t, per in self._data.items()}
        tenants = {}
        tot = {o: [0, 0.0, 0] for o in SERVING_OUTCOMES}
        for t, per in sorted(data.items()):
            replies = sum(c[0] for c in per.values())
            secs = sum(c[1] for c in per.values())
            toks = sum(c[2] for c in per.values())
            for o in SERVING_OUTCOMES:
                tot[o][0] += per[o][0]
                tot[o][1] += per[o][1]
                tot[o][2] += per[o][2]
            tenants[t] = {
                "replies": replies,
                **{o: per[o][0] for o in SERVING_OUTCOMES},
                "seconds": round(secs, 6),
                "ok_seconds": round(per["ok"][1], 6),
                "tokens": toks,
                "ok_tokens": per["ok"][2],
                "deadline_hit_rate": (round(per["ok"][0] / replies, 6)
                                      if replies else 0.0),
                "token_hit_rate": (round(per["ok"][2] / toks, 6)
                                   if toks else 0.0),
            }
        total_s = sum(c[1] for c in tot.values())
        total_n = sum(c[0] for c in tot.values())
        total_tok = sum(c[2] for c in tot.values())
        return {
            "goodput": (round(tot["ok"][1] / total_s, 6)
                        if total_s > 0 else 0.0),
            # the token-workload goodput: in-SLO tokens over ALL
            # streamed tokens (0.0 while nothing streamed)
            "goodput_tokens": (round(tot["ok"][2] / total_tok, 6)
                               if total_tok > 0 else 0.0),
            "replies": total_n,
            **{o: tot[o][0] for o in SERVING_OUTCOMES},
            "total_seconds": round(total_s, 6),
            "ok_seconds": round(tot["ok"][1], 6),
            "tokens": total_tok,
            "ok_tokens": tot["ok"][2],
            "tenants": tenants,
        }

    def reset(self):
        with self._lock:
            self._data = {}


#: Default process serving-goodput ledger; the fleet router feeds it.
SERVING_LEDGER = ServingGoodput()
