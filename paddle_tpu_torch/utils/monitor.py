"""Runtime stat registry (counterpart of paddle_tpu/utils/monitor.py;
reference: paddle/fluid/platform/monitor.h:77
StatRegistry + STAT_ADD/STAT_RESET macros, monitor.cc): named global
int counters, thread-safe, exported as a dict for observability."""
import threading

_STATS = {}
_LOCK = threading.Lock()


def stat_add(name, value=1):
    """STAT_ADD analog."""
    with _LOCK:
        _STATS[name] = _STATS.get(name, 0) + int(value)
        return _STATS[name]


def stat_sub(name, value=1):
    return stat_add(name, -int(value))


def stat_get(name):
    with _LOCK:
        return _STATS.get(name, 0)


def stat_reset(name=None):
    """STAT_RESET analog; name=None clears everything."""
    with _LOCK:
        if name is None:
            _STATS.clear()
        else:
            _STATS.pop(name, None)


def stat_registry():
    """Snapshot of all counters (monitor.h StatRegistry dump)."""
    with _LOCK:
        return dict(_STATS)
