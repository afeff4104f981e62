"""Process-wide metrics registry: counters, gauges, histograms
(counterpart of paddle_tpu/obs/metrics.py, kept here so that the port
imports nothing of the JAX package).

The serving engines' counters (inference/batching.py, inference/decode.py)
and the server's connection and frame counters (inference/server.py)
register here; the cmd-5 ``stats`` and cmd-3 ``health`` wire views read
the same instruments, and the Prometheus exposition
(``obs.prometheus.render``, wire cmd 6, ``obs.httpd.MetricsServer``)
renders them.

Design points:

- **Lock-cheap**: each instrument carries one small lock around a dict
  update; hot paths (the engine scheduler) already hold the engine lock
  at increment sites, so there is never lock contention beyond the GIL.
- **Snapshot-consistent**: ``Registry.collect()`` copies registered
  instruments under the registry lock, then runs collectors OUTSIDE it
  — a collector (e.g. the batching engine's) takes its own subsystem
  lock and emits every sample from one consistent view. The lock order
  is always subsystem-lock -> instrument-lock, never the reverse, so
  exposition can never deadlock against the hot path.
- **Instruments work standalone**: a subsystem may build private
  Counter/Gauge/Histogram objects (per-engine, per-server) and expose
  them through a registered collector instead of claiming global metric
  names — two engines then contribute samples to the same family,
  distinguished by their const labels.
- **Histograms use fixed log-spaced buckets** (:func:`log_buckets`):
  latency distributions span decades, and fixed buckets keep observe()
  O(#buckets) with zero allocation.
"""
import bisect
import math
import re
import threading

# lock order: the registry lock may be held while touching instruments,
# but instrument code never calls back into the registry while holding its
# own lock (the exposition deadlock the module docstring rules out)

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_RESERVED_LABELS = frozenset({"le", "quantile"})


def log_buckets(start=0.0001, factor=4.0, count=12):
    """Fixed log-spaced histogram bucket upper bounds:
    ``start * factor**i`` for i in [0, count). The default spans 100us
    to ~420s at 4x resolution — wide enough for queue waits, batch
    execs, XLA compiles, and checkpoint writes with one shape."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


DEFAULT_BUCKETS = log_buckets()


def _check_labels(labelnames):
    for ln in labelnames:
        if not _LABEL_NAME_RE.match(ln) or ln in _RESERVED_LABELS:
            raise ValueError(f"invalid label name {ln!r}")
    return tuple(labelnames)


class Family:
    """One exposition family: every sample a metric contributes under
    one name. ``samples`` rows are (suffix, labels_dict, value)."""

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name, kind, help, samples):
        self.name = name
        self.kind = kind
        self.help = help
        self.samples = samples


class Metric:
    """Base instrument: a named family of samples keyed by label
    values. Usable standalone or registered in a :class:`Registry`."""

    kind = None

    def __init__(self, name, help="", labelnames=(), const_labels=None):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = _check_labels(labelnames)
        self.const_labels = dict(const_labels or {})
        _check_labels(self.const_labels)
        self._lock = threading.Lock()
        self._values = {}  # label-value tuple -> store

    def _key(self, labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _label_dict(self, key):
        d = dict(self.const_labels)
        d.update(zip(self.labelnames, key))
        return d

    def _new_store(self):
        return 0.0

    def _store(self, key):
        """Called with self._lock held."""
        st = self._values.get(key)
        if st is None:
            st = self._values[key] = self._new_store()
        return st

    def clear(self, **labels):
        """Drop one label child (or every sample with no labels given)
        — long-lived registries shed per-test engines this way."""
        with self._lock:
            if labels:
                self._values.pop(self._key(labels), None)
            else:
                self._values.clear()


class Counter(Metric):
    """Monotonic counter. By convention the name ends in ``_total``."""

    kind = "counter"

    def inc(self, amount=1, **labels):
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._store(key) + amount

    def value(self, **labels):
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def collect(self):
        with self._lock:
            samples = [("", self._label_dict(k), v)
                       for k, v in sorted(self._values.items())]
        if not self.labelnames and not samples:
            samples = [("", dict(self.const_labels), 0.0)]
        return Family(self.name, self.kind, self.help, samples)


class Gauge(Metric):
    """Point-in-time value (queue depth, heartbeat age, goodput)."""

    kind = "gauge"

    def set(self, value, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount=1, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._store(key) + amount

    def dec(self, amount=1, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels):
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def collect(self):
        with self._lock:
            samples = [("", self._label_dict(k), v)
                       for k, v in sorted(self._values.items())]
        if not self.labelnames and not samples:
            samples = [("", dict(self.const_labels), 0.0)]
        return Family(self.name, self.kind, self.help, samples)


class _HistStore:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(Metric):
    """Distribution with fixed (log-spaced by default) buckets.

    Exposes the Prometheus histogram triplet: cumulative
    ``<name>_bucket{le=...}`` series (always ending in ``le="+Inf"``),
    ``<name>_sum`` and ``<name>_count``.
    """

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), const_labels=None,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, const_labels)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(set(bs)):
            raise ValueError(f"{name}: buckets must be sorted and unique")
        if math.isinf(bs[-1]):
            bs = bs[:-1]  # +Inf is implicit
        self.buckets = bs

    def _new_store(self):
        return _HistStore(len(self.buckets) + 1)

    def observe(self, value, **labels):
        value = float(value)
        key = self._key(labels)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            st = self._store(key)
            st.counts[idx] += 1
            st.sum += value
            st.count += 1

    def value(self, **labels):
        """-> {"count": n, "sum": s} for one label child."""
        with self._lock:
            st = self._values.get(self._key(labels))
            if st is None:
                return {"count": 0, "sum": 0.0}
            return {"count": st.count, "sum": st.sum}

    def collect(self):
        samples = []
        with self._lock:
            items = [(k, list(st.counts), st.sum, st.count)
                     for k, st in sorted(self._values.items())]
        for key, counts, total, count in items:
            base = self._label_dict(key)
            acc = 0
            for ub, c in zip(self.buckets, counts):
                acc += c
                le = dict(base)
                le["le"] = _format_float(ub)
                samples.append(("_bucket", le, acc))
            inf = dict(base)
            inf["le"] = "+Inf"
            samples.append(("_bucket", inf, count))
            samples.append(("_sum", base, total))
            samples.append(("_count", base, count))
        return Family(self.name, self.kind, self.help, samples)


def _format_float(v):
    """Shortest exact-ish rendering ("0.001", "2", "+Inf")."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Registry:
    """Named instruments plus collector callbacks.

    ``counter``/``gauge``/``histogram`` are get-or-create: a module that
    is imported twice (or a test that re-runs setup) gets the existing
    instrument back instead of a duplicate-name error — but asking for
    an existing name with a different kind or label schema raises.

    Collectors are zero-arg callables returning an iterable of
    :class:`Family`; they run OUTSIDE the registry lock (see module
    docstring for the lock-order argument) at every ``collect()``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        self._collectors = []

    # -------------------------------------------------------- registration
    def register(self, metric):
        with self._lock:
            have = self._metrics.get(metric.name)
            if have is not None and have is not metric:
                raise ValueError(
                    f"metric {metric.name!r} already registered")
            self._metrics[metric.name] = metric
        return metric

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def _get_or_create(self, cls, name, help, labelnames, const_labels,
                       **kw):
        with self._lock:
            have = self._metrics.get(name)
            if have is not None:
                if (type(have) is not cls
                        or have.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} exists with a different "
                        f"kind/label schema")
                return have
            m = cls(name, help, labelnames, const_labels, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=(), const_labels=None):
        return self._get_or_create(Counter, name, help, labelnames,
                                   const_labels)

    def gauge(self, name, help="", labelnames=(), const_labels=None):
        return self._get_or_create(Gauge, name, help, labelnames,
                                   const_labels)

    def histogram(self, name, help="", labelnames=(), const_labels=None,
                  buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   const_labels, buckets=buckets)

    def register_collector(self, fn):
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)
        return fn

    def unregister_collector(self, fn):
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    # ----------------------------------------------------------- snapshot
    def collect(self):
        """-> list[Family]: registered instruments first, then collector
        families. Collectors run outside the registry lock. A collector
        returning None (vs an empty list) declares itself dead — e.g. a
        weakref-wrapped engine that was garbage-collected without
        close() — and is auto-unregistered."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        families = [m.collect() for m in metrics]
        for fn in collectors:
            fams = fn()
            if fams is None:
                self.unregister_collector(fn)
                continue
            families.extend(fams)
        return families

    def snapshot(self):
        """JSON-able view: {name: [{"labels": {...}, "value": v}, ...]}
        (histogram families expose their _sum/_count/_bucket rows)."""
        out = {}
        for fam in self.collect():
            rows = out.setdefault(fam.name, [])
            for suffix, labels, value in fam.samples:
                rows.append({"sample": fam.name + suffix,
                             "labels": dict(labels), "value": value})
        return out


#: Default process-wide registry — what the Prometheus surfaces
#: (wire cmd 6, obs.httpd.MetricsServer) expose.
REGISTRY = Registry()


def counter(name, help="", labelnames=()):
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)
