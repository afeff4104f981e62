"""Compile ledger: a record of every program the serving engines build
(counterpart of paddle_tpu/obs/ledger.py, kept here so that the port
imports nothing of the JAX package).

The reference records each XLA compile with its cost analysis and a
structural HLO fingerprint. The port compiles no XLA program: a loaded
layer is one ``torch.export`` graph run eagerly, and the decode engine's
programs are CUDA graphs captured on the card. So an entry records what
has a torch counterpart::

    key          caller-chosen identity, the reference's
                 ("serving/bucket8", "decode/step16x256")
    kind         "aot" (a bucket's first run of a loaded program, the
                 reference's inline compile), "cuda_graph" (a decode
                 program's capture), "eager" (a decode program built
                 without a capture: the CPU, or cuda_graph=False)
    duration_s   wall-clock build time
    op_counts    {aten target: n} over a ``torch.export`` graph's
                 call_function nodes (:func:`graph_ops`)
    n_ops
    fingerprint  sha256 over those targets in order: a structural
                 identity of the graph, blind to node names

A CUDA graph capture has no ATen graph to read and records
``duration_s`` only. The reference's ``flops`` and ``bytes_accessed``
come from XLA's cost analysis and have no counterpart here (ROADMAP
Queue 3 (b)); ``totals`` reports them as 0.0 so that its shape is the
reference's.
"""
import hashlib
import threading
import time

from . import metrics as _metrics
from . import tracing as _tracing

_COMPILES = _metrics.counter(
    "paddle_compile_events_total",
    "XLA compile events recorded in the compile ledger",
    labelnames=("kind",))
_COMPILE_SECONDS = _metrics.histogram(
    "paddle_compile_seconds",
    "Duration of recorded compile events",
    buckets=_metrics.log_buckets(0.001, 4.0, 10))


def graph_ops(graph):
    """The ordered call_function targets of a torch.fx graph, by name
    (an operator overload as ``aten.mm.default``, any other callable by
    its ``__name__``: ``getitem``, ``sharded_matmul``)."""
    return [str(n.target) if hasattr(n.target, "_schema")
            else getattr(n.target, "__name__", str(n.target))
            for n in graph.nodes if n.op == "call_function"]


def ops_fingerprint(ops):
    """Structural identity: sha256 over the ordered op sequence."""
    h = hashlib.sha256()
    for op in ops:
        h.update(str(op).encode("ascii", "replace"))
        h.update(b"\n")
    return h.hexdigest()[:16]


def analyze_graph(graph):
    """``op_counts``, ``n_ops`` and ``fingerprint`` of a torch.fx graph."""
    ops = graph_ops(graph)
    counts = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    return {"op_counts": counts, "n_ops": len(ops), "fingerprint": ops_fingerprint(ops)}


class CompileLedger:
    """Append-only, bounded record of compile events."""

    def __init__(self, cap=1024):
        self._lock = threading.Lock()
        self._events = []
        self._cap = cap

    def record(self, key, duration_s=None, graph=None, kind="aot", extra=None):
        """Record one compile event; returns the event dict. ``graph``: the
        torch.fx graph the event built, if it has one."""
        ev = {"key": str(key), "kind": kind, "ts": time.time()}
        if duration_s is not None:
            ev["duration_s"] = round(float(duration_s), 6)
        if graph is not None:
            ev.update(analyze_graph(graph))
        if extra:
            ev.update(extra)
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self._cap:
                del self._events[:len(self._events) - self._cap]
        _COMPILES.inc(kind=kind)
        if duration_s is not None:
            _COMPILE_SECONDS.observe(float(duration_s))
            _tracing.observe(f"compile:{key}", float(duration_s))
        return ev

    def events(self, key_prefix=None):
        with self._lock:
            evs = list(self._events)
        if key_prefix is not None:
            evs = [e for e in evs if e["key"].startswith(key_prefix)]
        return evs

    def totals(self, key_prefix=None):
        """Aggregate view: compile count, merged op counts; ``flops`` and
        ``bytes_accessed`` are 0.0 (module docstring)."""
        evs = self.events(key_prefix)
        op_counts = {}
        for e in evs:
            for op, n in e.get("op_counts", {}).items():
                op_counts[op] = op_counts.get(op, 0) + n
        return {"compiles": len(evs), "flops": 0.0, "bytes_accessed": 0.0,
                "op_counts": op_counts, "n_ops": sum(op_counts.values())}

    def reset(self):
        with self._lock:
            self._events = []


#: Default process ledger (the serving engines record here).
LEDGER = CompileLedger()
