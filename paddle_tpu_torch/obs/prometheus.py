"""Prometheus text exposition (format version 0.0.4) over a
:class:`~paddle_tpu_torch.obs.metrics.Registry` (counterpart of
paddle_tpu/obs/prometheus.py: the same bytes for the same samples).

Families with the same name (e.g. two batching engines each exposing
``paddle_serving_requests_total`` through their collectors) are merged
under one HELP/TYPE header; duplicate (name, labels) sample keys are
summed — the semantics an aggregating scraper would apply anyway, and
the only correct merge for counters/histogram buckets.
"""
from .metrics import REGISTRY, _format_float

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s):
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s):
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _render_labels(labels):
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render(registry=None):
    """-> the exposition text for every family the registry collects."""
    registry = registry if registry is not None else REGISTRY
    merged = {}  # name -> (kind, help, {(suffix, label_items): value})
    order = []
    for fam in registry.collect():
        if fam.name not in merged:
            merged[fam.name] = (fam.kind, fam.help, {})
            order.append(fam.name)
        kind, help_, samples = merged[fam.name]
        if kind != fam.kind:
            raise ValueError(
                f"family {fam.name!r} collected with conflicting kinds "
                f"{kind!r} and {fam.kind!r}")
        for suffix, labels, value in fam.samples:
            key = (suffix, tuple(sorted((str(k), str(v))
                                        for k, v in labels.items())))
            samples[key] = samples.get(key, 0.0) + value
    lines = []
    for name in sorted(order):
        kind, help_, samples = merged[name]
        if help_:
            lines.append(f"# HELP {name} {_escape_help(help_)}")
        lines.append(f"# TYPE {name} {kind or 'untyped'}")
        for (suffix, label_items), value in samples.items():
            lines.append(f"{name}{suffix}"
                         f"{_render_labels(dict(label_items))} "
                         f"{_format_float(value)}")
    return "\n".join(lines) + "\n" if lines else ""
