"""Deterministic chaos / fault-injection harness (counterpart of
paddle_tpu/resilience/chaos.py).

Every fault the serving engines defend against (a scheduler that dies or
wedges, a program that fails) is injectable here, *deterministically*,
by visit count rather than randomness, so a failing chaos test replays
bit-for-bit. The sites the port declares: ``serving.submit``,
``serving.scheduler.loop``, ``serving.execute`` and
``serving.execute.bucket{n}`` (inference/batching.py);
``serving.decode.admit``, ``.resume``, ``.loop``, ``.prefill``,
``.step``, ``.snapshot`` and ``.compile`` (inference/decode.py). The
reference's ``arm_from_env`` is not ported: the port reads no
environment.

Instrumented code declares named *sites* by calling :func:`hit` (or
:func:`poison` for data corruption). Tests arm faults against a site:

    from paddle_tpu_torch.resilience import chaos
    with chaos.fault("serving.decode.loop", exc=RuntimeError("die"), at=2):
        ...   # the 2nd scheduler iteration raises; the 1st and 3rd run

Supported actions per fault: raise an exception, deliver a signal to
this process, sleep (delayed I/O), or NaN-poison an array. A fault
fires on visits ``at .. at+times-1`` of its site. When nothing is
armed, ``hit()`` is a near-free early return — safe on hot paths.
"""
import os
import threading
import time

import numpy as np


class Fault:
    """One armed fault: fires on visits ``at .. at+times-1`` of ``site``."""

    def __init__(self, site, at=1, times=1, exc=None, signum=None,
                 delay=0.0, nan=False):
        if at < 1:
            raise ValueError(f"at is 1-based, got {at}")
        self.site = site
        self.at = at
        self.times = times
        self.exc = exc
        self.signum = signum
        self.delay = delay
        self.nan = nan
        self.fired = 0

    def covers(self, visit):
        return self.at <= visit < self.at + self.times


class ChaosMonkey:
    """Process-global registry of armed faults and per-site visit counts."""

    def __init__(self):
        self._lock = threading.RLock()
        self._faults = []
        self._counts = {}
        self.log = []  # (site, visit, action) — for test assertions

    # ------------------------------------------------------------ arming
    def arm(self, site, at=1, times=1, exc=None, signum=None, delay=0.0,
            nan=False):
        f = Fault(site, at=at, times=times, exc=exc, signum=signum,
                  delay=delay, nan=nan)
        with self._lock:
            self._faults.append(f)
        return f

    def disarm(self, fault):
        with self._lock:
            if fault in self._faults:
                self._faults.remove(fault)

    def reset(self):
        with self._lock:
            self._faults = []
            self._counts = {}
            self.log = []

    def armed(self, site=None):
        with self._lock:
            if site is None:
                return bool(self._faults)
            return any(f.site == site for f in self._faults)

    def visits(self, site):
        with self._lock:
            return self._counts.get(site, 0)

    # ------------------------------------------------------------ firing
    def _visit(self, site):
        with self._lock:
            n = self._counts[site] = self._counts.get(site, 0) + 1
            matched = [f for f in self._faults
                       if f.site == site and f.covers(n)]
            for f in matched:
                f.fired += 1
        return n, matched

    def hit(self, site):
        """Record a visit to `site`; apply any armed fault covering it.

        Order per matched fault: delay, then signal, then raise — a
        single fault can model "slow write that then fails". Returns the
        visit number (1-based).
        """
        n, matched = self._visit(site)
        for f in matched:
            if f.delay:
                self.log.append((site, n, "delay"))
                time.sleep(f.delay)
            if f.signum is not None:
                self.log.append((site, n, "signal"))
                os.kill(os.getpid(), f.signum)
            if f.exc is not None:
                self.log.append((site, n, "raise"))
                raise f.exc() if isinstance(f.exc, type) else f.exc
        return n

    def poison(self, site, array):
        """Return `array`, NaN-poisoned when a ``nan=True`` fault covers
        this visit (how tests make "the gradients went NaN at step k"
        reproducible). Non-nan actions armed on the same site fire too."""
        n, matched = self._visit(site)
        poisoned = False
        for f in matched:
            if f.delay:
                self.log.append((site, n, "delay"))
                time.sleep(f.delay)
            if f.signum is not None:
                self.log.append((site, n, "signal"))
                os.kill(os.getpid(), f.signum)
            if f.exc is not None:
                self.log.append((site, n, "raise"))
                raise f.exc() if isinstance(f.exc, type) else f.exc
            if f.nan:
                poisoned = True
        if poisoned:
            self.log.append((site, n, "nan"))
            arr = np.array(array, dtype=np.asarray(array).dtype, copy=True)
            if not np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(np.float32)
            arr.fill(np.nan)
            return arr
        return array


monkey = ChaosMonkey()

# module-level aliases — instrumented code and tests use these
arm = monkey.arm
disarm = monkey.disarm
reset = monkey.reset
armed = monkey.armed
visits = monkey.visits
hit = monkey.hit
poison = monkey.poison


_EXC_WHITELIST = ("RuntimeError", "OSError", "IOError", "ValueError",
                  "TimeoutError", "ConnectionError")


def arm_from_env(env=None):
    """Arm faults described in the ``PADDLE_TPU_CHAOS`` env var — how a
    launcher (the port's ``launch_collective``/``launch_elastic``, whose
    rank loops call it once) injects deterministic faults into SUBPROCESS
    trainers it cannot reach with ``chaos.arm`` directly (the JAX
    package's ``arm_from_env``, the same grammar).

    Spec: ``;``-separated faults, each ``,``-separated ``k=v`` pairs::

        PADDLE_TPU_CHAOS="site=train.step,signum=15,at=6,rank=1;site=io,exc=OSError"

    Keys: ``site`` (required), ``at``, ``times``, ``signum``, ``delay``,
    ``nan=1``, ``exc=<builtin exception name>``, and ``rank=<n>`` which
    arms the fault only when PADDLE_TRAINER_ID matches — one spec
    string fans out to a whole pod with per-rank targeting. Returns the
    list of armed Faults (empty when the var is unset)."""
    env = os.environ if env is None else env
    spec = env.get("PADDLE_TPU_CHAOS", "")
    my_rank = env.get("PADDLE_TRAINER_ID")
    armed = []
    for part in (p.strip() for p in spec.split(";")):
        if not part:
            continue
        kv = dict(item.split("=", 1) for item in part.split(","))
        if "site" not in kv:
            raise ValueError(f"PADDLE_TPU_CHAOS fault without site: {part!r}")
        if "rank" in kv and my_rank is not None \
                and int(kv["rank"]) != int(my_rank):
            continue
        kwargs = {"at": int(kv.get("at", 1)),
                  "times": int(kv.get("times", 1)),
                  "delay": float(kv.get("delay", 0.0)),
                  "nan": kv.get("nan") in ("1", "true")}
        if "signum" in kv:
            kwargs["signum"] = int(kv["signum"])
        if "exc" in kv:
            name = kv["exc"]
            if name not in _EXC_WHITELIST:
                raise ValueError(f"PADDLE_TPU_CHAOS exc {name!r} not in "
                                 f"{_EXC_WHITELIST}")
            import builtins

            kwargs["exc"] = getattr(builtins, name)
        armed.append(arm(kv["site"], **kwargs))
    return armed


class fault:
    """Context manager: arm a fault for the `with` body, disarm after.

    with chaos.fault("serving.decode.step", delay=3.0):
        ...
    """

    def __init__(self, site, **kwargs):
        self._args = (site, kwargs)
        self.fault = None

    def __enter__(self):
        site, kwargs = self._args
        self.fault = monkey.arm(site, **kwargs)
        return self.fault

    def __exit__(self, *exc_info):
        monkey.disarm(self.fault)
        return False
