"""Profiler (counterpart of paddle_tpu/utils/profiler.py; reference:
paddle/fluid/platform/profiler.* RecordEvent + DeviceTracer/CUPTI, python
fluid/profiler.py) over ``torch.profiler``.

``RecordEvent`` spans are ``torch.profiler.record_function`` ranges (which
a device trace correlates with the kernels they launch) and spans of the
port's span layer (``obs.tracing``), which backs ``summary()``: one clock
and one table for RecordEvent, serving, checkpoint and compile spans.
``profiler``/``start_profiler``/``stop_profiler`` run a
``torch.profiler.profile`` window (CPU, and CUDA where a card is
present) and write its Chrome trace, gzipped, into ``profile_path``;
``op_summary_from_trace``/``print_op_summary`` aggregate the newest such
trace into the reference's per-op table (the device's kernels where the
trace has them).
"""
import contextlib
import os
import tempfile
import time

import torch

from ..obs import tracing as _tracing

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _default_path():
    return os.path.join(tempfile.gettempdir(), "profile")


class RecordEvent:
    """A named span (reference: profiler.h:127): a ``record_function``
    range and a span of the aggregation table ``summary()`` prints."""

    def __init__(self, name):
        self.name = name
        self._range = None
        self._span = None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._span = _tracing.start_span(self.name)
        return self

    def __exit__(self, *exc):
        self._span.finish()
        self._span = None
        out = self._range.__exit__(*exc)
        self._range = None
        return out


def reset_summary():
    _tracing.reset_summary()


def summary(sorted_by="total", printer=print):
    """The aggregated span table (reference: profiler.cc PrintProfiler):
    every span the process recorded since the last ``reset_summary()``.
    Returns the rows; prints a table too."""
    rows = _tracing.summary_rows()
    key = {"total": "total", "calls": "calls", "avg": "avg", "max": "max",
           "min": "min"}.get(sorted_by, "total")
    rows.sort(key=lambda r: r[key], reverse=True)
    if printer is not None and rows:
        w = max(len(r["name"]) for r in rows)
        printer(f"{'Event':<{w}}  {'Calls':>7} {'Total(s)':>10} {'Avg(s)':>10} "
                f"{'Max(s)':>10} {'Min(s)':>10}")
        for r in rows:
            printer(f"{r['name']:<{w}}  {r['calls']:>7} {r['total']:>10.6f} "
                    f"{r['avg']:>10.6f} {r['max']:>10.6f} {r['min']:>10.6f}")
    return rows


_ACTIVE = []  # the window start_profiler opened: (profile, path)


def _open_window():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _close_window(prof, profile_path):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(profile_path, exist_ok=True)
    out = os.path.join(profile_path, f"{time.time_ns()}.trace.json.gz")
    prof.export_chrome_trace(out)
    return out


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None, tracer_option="Default"):
    """A ``torch.profiler`` window whose Chrome trace lands in
    ``profile_path`` (a directory; the temporary directory's ``profile``
    when None)."""
    prof = _open_window()
    try:
        yield prof
    finally:
        _close_window(prof, profile_path or _default_path())


def start_profiler(state="All", tracer_option="Default", profile_path=None):
    if _ACTIVE:
        raise RuntimeError("a profiler window is already open")
    _ACTIVE.append((_open_window(), profile_path or _default_path()))


def stop_profiler(sorted_key=None, profile_path=None):
    """Close the window ``start_profiler`` opened -> the trace file's path."""
    if not _ACTIVE:
        raise RuntimeError("no profiler window is open")
    prof, path = _ACTIVE.pop()
    return _close_window(prof, profile_path or path)


def cuda_profiler(*args, **kwargs):
    raise NotImplementedError("use utils.profiler.profiler (torch.profiler) windows")


# --------------------------------------------- legacy fluid-profiler API
# (reference: python/paddle/utils/profiler.py ProfilerOptions/Profiler/
# get_profiler)


class ProfilerOptions:
    def __init__(self, options=None):
        self.options = {
            "state": "All", "sorted_key": "default", "tracer_level": "Default",
            "batch_range": [0, 100], "output_thread_detail": False, "profile_path": "none",
            "timeline_path": "none", "op_summary_path": "none",
        }
        if options is not None:
            self.options.update(options)

    def with_state(self, state):
        new = ProfilerOptions(dict(self.options))
        new.options["state"] = state
        return new

    def __getitem__(self, name):
        return self.options[name]


class Profiler:
    """Context-manager profiler (reference: utils/profiler.py Profiler):
    resets the span table and records a "Profiler" span around the
    window; ``summary()`` then reads it."""

    def __init__(self, enabled=True, options=None):
        self.enabled = enabled
        self.profiler_options = options or ProfilerOptions()
        self._span = None

    def __enter__(self):
        if self.enabled:
            reset_summary()
            self._span = RecordEvent("Profiler")
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.__exit__(*exc)
            self._span = None
        return False

    def reset(self):
        reset_summary()


_profiler = None


def get_profiler(options=None):
    global _profiler
    if _profiler is None:
        _profiler = Profiler(options=options)
    return _profiler


# ---------------------------------------------------- the per-op table
def _find_trace_files(trace_dir):
    import glob

    pats = sorted(glob.glob(os.path.join(trace_dir, "*.trace.json.gz")), key=os.path.getmtime)
    return pats[-1:]


def op_summary_from_trace(trace_dir, top=20, device_only=True):
    """The newest trace under ``trace_dir`` aggregated into per-op rows
    (name, calls, total_ms, avg_ms, ratio), by total time. With
    ``device_only`` the rows are the device's (kernels, copies, sets)
    where the trace has any, else every complete event."""
    import gzip
    import json
    from collections import defaultdict

    files = _find_trace_files(trace_dir)
    if not files:
        raise FileNotFoundError(f"no *.trace.json.gz under {trace_dir!r}: record one with "
                                "profiler() or start_profiler/stop_profiler first")
    with gzip.open(files[0], "rt") as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if device_only and device:
        events = device
    total, calls = defaultdict(float), defaultdict(int)
    for e in events:
        total[e.get("name", "?")] += float(e["dur"])  # microseconds
        calls[e.get("name", "?")] += 1
    grand = sum(total.values()) or 1.0
    rows = [{"name": n, "calls": calls[n], "total_ms": total[n] / 1000.0,
             "avg_ms": total[n] / calls[n] / 1000.0, "ratio": total[n] / grand} for n in total]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows[:top] if top else rows


def print_op_summary(trace_dir, top=20, printer=print, device_only=True):
    """The reference's profiler.cc-style table for the newest trace in
    ``trace_dir``; returns the rows it printed."""
    rows = op_summary_from_trace(trace_dir, top=top, device_only=device_only)
    width = max([len(r["name"]) for r in rows] + [8])
    printer(f"{'op':<{width}}  {'calls':>6}  {'total ms':>10}  {'avg ms':>9}  {'ratio':>6}")
    for r in rows:
        printer(f"{r['name']:<{width}}  {r['calls']:>6}  {r['total_ms']:>10.3f}  "
                f"{r['avg_ms']:>9.4f}  {r['ratio']:>6.1%}")
    return rows
