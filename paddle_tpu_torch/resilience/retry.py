"""Retry with exponential backoff, jitter and a deadline (counterpart of
paddle_tpu/resilience/retry.py): one typed, observable retry primitive for
transient failures (a shared filesystem's hiccup, a dataset read under
load). The port's DataLoader retries a sample's read with it.

Environment knobs (defaults, overridable per call site), as in the
reference:
    PADDLE_TPU_RETRY_MAX_ATTEMPTS   (default 3)
    PADDLE_TPU_RETRY_BASE_DELAY     seconds, first backoff   (default 0.1)
    PADDLE_TPU_RETRY_MAX_DELAY      seconds, backoff ceiling (default 30)

Retries and exhaustion count in the port's metrics registry
(``paddle_retry_attempts_total``, ``paddle_retry_exhausted_total``), and
each backoff sleep is accounted as goodput's ``retry`` time.
"""
import errno
import functools
import os
import random
import time

from ..obs import goodput as _goodput
from ..obs import metrics as _obs

DEFAULT_RETRYABLE = (OSError, ConnectionError, TimeoutError)

# Registry-backed retry telemetry: backoff sleeps are wall-clock the
# goodput accountant debits (a pod retrying a flaky FS is not training).
_RETRIES = _obs.counter("paddle_retry_attempts_total",
                        "Retries performed (backoff sleeps)")
_EXHAUSTED = _obs.counter("paddle_retry_exhausted_total",
                          "call_with_retry gave up (RetryError)")

# OSErrors that no amount of waiting fixes: retrying them only adds
# latency, and converting a FileNotFoundError into a RetryError breaks
# every `except OSError`/`except FileNotFoundError` caller contract —
# these always re-raise immediately and unchanged.
PERMANENT_ERRNOS = frozenset({
    errno.ENOENT, errno.ENOTDIR, errno.EISDIR, errno.EEXIST,
    errno.ENAMETOOLONG, errno.EROFS, errno.ENOTEMPTY, errno.EINVAL,
})


def is_permanent(exc):
    return isinstance(exc, OSError) and exc.errno in PERMANENT_ERRNOS


class RetryError(RuntimeError):
    """All attempts exhausted (or deadline hit). `.last` is the final
    exception; it is also chained as __cause__."""

    def __init__(self, message, last=None, attempts=0):
        super().__init__(message)
        self.last = last
        self.attempts = attempts


def _env_int(name, default):
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def backoff_delays(max_attempts, base_delay, max_delay, jitter, rng):
    """Delays slept *between* attempts: base * 2^k, capped, with
    multiplicative jitter in [1-jitter, 1+jitter] (decorrelates a pod's
    worth of workers hammering the same recovering filesystem)."""
    for k in range(max_attempts - 1):
        d = min(max_delay, base_delay * (2.0 ** k))
        if jitter:
            d *= 1.0 + jitter * (2.0 * rng() - 1.0)
        yield max(0.0, d)


def call_with_retry(fn, *args, max_attempts=None, base_delay=None,
                    max_delay=None, deadline=None, retry_on=None,
                    retry_if=None, jitter=0.5, on_retry=None,
                    sleep=time.sleep, rng=random.random, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying on exceptions in
    ``retry_on`` (default: OSError/ConnectionError/TimeoutError).

    deadline: total seconds across attempts+sleeps; exceeded -> RetryError.
    retry_if(exc) -> bool: extra predicate over type-matched exceptions —
    return False to re-raise immediately (for exception types like
    RuntimeError that mix transient and permanent failures).
    on_retry(attempt, exc, delay): observer hook (logging/metrics).
    sleep/rng: injectable for deterministic tests.
    """
    max_attempts = max_attempts if max_attempts is not None else \
        _env_int("PADDLE_TPU_RETRY_MAX_ATTEMPTS", 3)
    base_delay = base_delay if base_delay is not None else \
        _env_float("PADDLE_TPU_RETRY_BASE_DELAY", 0.1)
    max_delay = max_delay if max_delay is not None else \
        _env_float("PADDLE_TPU_RETRY_MAX_DELAY", 30.0)
    retry_on = tuple(retry_on) if retry_on is not None else DEFAULT_RETRYABLE
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    t0 = time.monotonic()
    delays = backoff_delays(max_attempts, base_delay, max_delay, jitter, rng)
    last = None
    for attempt in range(1, max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if is_permanent(e):
                raise  # unchanged: ENOENT etc. keep their contract
            if retry_if is not None and not retry_if(e):
                raise
            last = e
            if attempt == max_attempts:
                break
            delay = next(delays)
            if deadline is not None and \
                    time.monotonic() - t0 + delay > deadline:
                _EXHAUSTED.inc()
                raise RetryError(
                    f"{_name(fn)}: deadline {deadline}s exceeded after "
                    f"{attempt} attempt(s)", last=e, attempts=attempt) from e
            if on_retry is not None:
                on_retry(attempt, e, delay)
            _RETRIES.inc()
            _goodput.account("retry", delay)
            sleep(delay)
    _EXHAUSTED.inc()
    raise RetryError(
        f"{_name(fn)}: failed after {max_attempts} attempt(s): {last}",
        last=last, attempts=max_attempts) from last


def retry(max_attempts=None, base_delay=None, max_delay=None, deadline=None,
          retry_on=None, jitter=0.5, on_retry=None, sleep=time.sleep,
          rng=random.random):
    """Decorator form of :func:`call_with_retry`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return call_with_retry(
                fn, *args, max_attempts=max_attempts, base_delay=base_delay,
                max_delay=max_delay, deadline=deadline, retry_on=retry_on,
                jitter=jitter, on_retry=on_retry, sleep=sleep, rng=rng,
                **kwargs)
        return wrapped
    return deco


def _name(fn):
    return getattr(fn, "__qualname__", getattr(fn, "__name__", repr(fn)))
