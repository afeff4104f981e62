"""Telemetry of the port (counterpart of paddle_tpu/obs): the metrics
registry, span tracing and the Prometheus exposition, served on the wire
(cmd 6) and over HTTP (:class:`httpd.MetricsServer`), the goodput
accountant (:mod:`goodput`) and the compile ledger (:mod:`ledger`,
``LEDGER``: the serving engines' program builds). Standard library
only::

    from paddle_tpu_torch import obs

    reqs = obs.counter("myapp_requests_total", "requests served")
    reqs.inc()
    print(obs.render())               # Prometheus text exposition

    with obs.tracing.span("myapp.handler", trace_id=obs.new_trace_id()):
        ...                           # lands in the shared span table
"""
from . import goodput, httpd, ledger, metrics, prometheus, tracing  # noqa: F401
from .httpd import MetricsServer  # noqa: F401
from .ledger import LEDGER, CompileLedger  # noqa: F401
from .metrics import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                      Registry, counter, gauge, histogram, log_buckets)
from .prometheus import render  # noqa: F401
from .tracing import new_trace_id, span, start_span  # noqa: F401

__all__ = [
    "goodput", "ledger", "metrics", "prometheus", "tracing", "httpd", "MetricsServer",
    "LEDGER", "CompileLedger",
    "REGISTRY", "Registry", "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram", "log_buckets", "render",
    "new_trace_id", "span", "start_span",
]
