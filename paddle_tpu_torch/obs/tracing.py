"""Span tracing: one clock, one summary table, request-scoped trace ids
(counterpart of paddle_tpu/obs/tracing.py).

A *span* is a named timed region. The serving engines record per-request
spans (enqueue -> batch -> execute -> reply, and a decode stream's
per-token spans), tagged with the request's ``trace_id`` (carried on the
wire by the 0x1D field, inference/wire_spec.py), and aggregate untraced
regions into the summary table with :func:`observe`. All of them share
one clock (``time.perf_counter``), one table (:func:`summary_rows`) and
one bounded buffer of finished spans (:func:`finished`).

Trace ids are 64-bit, non-zero, hex-rendered; ``trace(tid)`` installs
an ambient id for the current thread that ``span()``/``start_span()``
inherit, and explicit ``trace_id=`` wins: the engine scheduler runs in
a different thread from the submitting handler, so the id travels on
the request object, not on the thread.
"""
import collections
import contextlib
import random
import threading
import time

# the finished-span buffer's bound (the port reads no environment: the
# reference's default)
_BUFFER_CAP = 4096

_lock = threading.Lock()
_finished = collections.deque(maxlen=_BUFFER_CAP)
_agg = {}  # name -> [calls, total_s, max_s, min_s]
_tls = threading.local()
_span_seq = [0]


def new_trace_id():
    """Random non-zero u64 (0 means "no trace" on the wire)."""
    tid = 0
    while tid == 0:
        tid = random.getrandbits(64)
    return tid


def format_trace_id(tid):
    return f"{tid:016x}"


def current_trace_id():
    """The ambient trace id installed by :func:`trace` (None outside)."""
    return getattr(_tls, "trace_id", None)


@contextlib.contextmanager
def trace(trace_id):
    """Install ``trace_id`` as the current thread's ambient id."""
    prev = getattr(_tls, "trace_id", None)
    _tls.trace_id = trace_id
    try:
        yield trace_id
    finally:
        _tls.trace_id = prev


class Span:
    """One timed region. Created by :func:`start_span`; must be
    :meth:`finish`-ed (or used via the :func:`span` context manager).
    A Span may be finished from a different thread than it was started
    on — the engine scheduler finishes queue spans the handler thread
    opened."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "t_start", "duration_s", "_done")

    def __init__(self, name, trace_id=None, parent_id=None, attrs=None):
        self.name = name
        self.trace_id = (trace_id if trace_id is not None
                         else current_trace_id())
        with _lock:
            _span_seq[0] += 1
            self.span_id = _span_seq[0]
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.t_start = time.perf_counter()
        self.duration_s = None
        self._done = False

    def finish(self, **attrs):
        """Record the span (idempotent). Extra attrs merge in."""
        if self._done:
            return self
        self._done = True
        self.duration_s = time.perf_counter() - self.t_start
        if attrs:
            self.attrs.update(attrs)
        _record(self)
        return self

    def as_dict(self):
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "duration_s": self.duration_s, "attrs": dict(self.attrs)}


def start_span(name, trace_id=None, parent_id=None, **attrs):
    return Span(name, trace_id=trace_id, parent_id=parent_id, attrs=attrs)


@contextlib.contextmanager
def span(name, trace_id=None, **attrs):
    sp = start_span(name, trace_id=trace_id, **attrs)
    try:
        yield sp
    finally:
        sp.finish()


def _agg_update_locked(name, duration_s):
    """Fold one duration into the summary table. Caller holds _lock."""
    rec = _agg.get(name)
    if rec is None:
        rec = _agg[name] = [0, 0.0, 0.0, float("inf")]
    rec[0] += 1
    rec[1] += duration_s
    rec[2] = max(rec[2], duration_s)
    rec[3] = min(rec[3], duration_s)


def _record(sp):
    with _lock:
        _finished.append(sp.as_dict())
        _agg_update_locked(sp.name, sp.duration_s)


def observe(name, duration_s):
    """Aggregate a pre-measured duration into the summary table only —
    no buffer entry, no Span object (the cheap path for untraced hot
    traffic)."""
    with _lock:
        _agg_update_locked(name, float(duration_s))


def record_span(name, duration_s, trace_id=None, parent_id=None, **attrs):
    """Record an already-measured region as a finished span (the
    engine measures one batch execute and attributes it to every traced
    request in the group)."""
    sp = Span.__new__(Span)
    sp.name = name
    sp.trace_id = trace_id if trace_id is not None else current_trace_id()
    with _lock:
        _span_seq[0] += 1
        sp.span_id = _span_seq[0]
    sp.parent_id = parent_id
    sp.attrs = dict(attrs)
    sp.t_start = time.perf_counter() - duration_s
    sp.duration_s = float(duration_s)
    sp._done = True
    _record(sp)
    return sp


def finished(trace_id=None, name=None):
    """Finished spans (as dicts, oldest first), optionally filtered by
    trace id and/or span name. The buffer is bounded (4096 spans): this
    is a debugging / test surface, not a durable trace store."""
    with _lock:
        spans = list(_finished)
    if trace_id is not None:
        spans = [s for s in spans if s["trace_id"] == trace_id]
    if name is not None:
        spans = [s for s in spans if s["name"] == name]
    return spans


def summary_rows():
    """Aggregated per-name rows (the reference's table schema):
    {name, calls, total, avg, max, min}, seconds."""
    with _lock:
        return [{"name": n, "calls": c, "total": tot, "avg": tot / c,
                 "max": mx, "min": mn}
                for n, (c, tot, mx, mn) in _agg.items()]


def reset_summary():
    """Clear the aggregation table (the profiler's ``reset_summary``); the
    finished-span buffer survives."""
    with _lock:
        _agg.clear()


def reset():
    """Clear both the aggregation table and the finished-span buffer."""
    with _lock:
        _agg.clear()
        _finished.clear()
