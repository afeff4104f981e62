"""Dynamic-batching serving engine (counterpart of
paddle_tpu/inference/batching.py): coalesce concurrent infer requests
into padded power-of-two row buckets.

  requests --> bounded queue --> scheduler thread --> padded bucket batch
                (load shed,       (fire on max_batch_size     |
                 deadline purge)   or max_wait_ms)            v
  response <----------------- slice rows off <---------- model call

The bounded queue turns saturation into fast rejection
(:class:`EngineOverloaded`, wire status 2). A request may carry an
absolute deadline: expired requests are dropped before dispatch, and a
group never waits past the tightest deadline of its members. Padding rows
are sliced off before anything is returned.

Not yet ported (later slices): the per-bucket circuit breaker, the
scheduler watchdog, cold-compile threads, the artifact store, meshes and
the obs metrics. A batch that raises fails only its own group.
"""
import threading
import time

import numpy as np

from .wire_spec import STATUS_RETRYABLE


class RetryableError(RuntimeError):
    """Transient serving failure: back off and retry (wire status 2)."""

    status_code = STATUS_RETRYABLE


class EngineOverloaded(RetryableError):
    """The bounded queue is full: the request was shed."""


class DeadlineExceeded(RetryableError):
    """The request's deadline passed before its batch dispatched; it was
    dropped without spending compute."""


class EngineClosed(RuntimeError):
    pass


def bucket_rows(n, max_batch_size):
    """Next power of two >= n, clamped to max_batch_size."""
    if n <= 0:
        raise ValueError(f"need at least one row, got {n}")
    if n >= max_batch_size:
        return max_batch_size
    return min(max_batch_size, 1 << (n - 1).bit_length())


def _signature(arrays):
    """Batch-compatibility key: dtype + trailing dims of every input."""
    return tuple((a.dtype.str, a.shape[1:]) for a in arrays)


class _Request:
    __slots__ = ("inputs", "rows", "sig", "event", "outputs", "error",
                 "t_enqueue", "min_bucket", "deadline")

    def __init__(self, inputs, rows, sig, min_bucket=1, deadline=None):
        self.inputs = inputs
        self.rows = rows
        self.sig = sig
        self.event = threading.Event()
        self.outputs = None
        self.error = None
        self.t_enqueue = time.monotonic()
        # split chunks of a >= 2-row request pad to at least 2 rows, as
        # their rows came from a >= 2-row request
        self.min_bucket = min_bucket
        self.deadline = deadline  # absolute time.monotonic(), or None

    def fail(self, error):
        if not self.event.is_set():
            self.error = error
            self.event.set()


class _BucketStats:
    __slots__ = ("batches", "requests", "rows", "padded_rows", "total_ms",
                 "max_ms")

    def __init__(self):
        self.batches = 0
        self.requests = 0
        self.rows = 0
        self.padded_rows = 0
        self.total_ms = 0.0
        self.max_ms = 0.0

    def as_dict(self):
        return {
            "batches": self.batches,
            "requests": self.requests,
            "rows": self.rows,
            "padded_rows": self.padded_rows,
            "total_ms": round(self.total_ms, 3),
            "avg_ms": round(self.total_ms / self.batches, 3) if self.batches else 0.0,
            "max_ms": round(self.max_ms, 3),
        }


class CallableRunner:
    """Runner over any ``fn(*arrays) -> output or list of outputs``; each
    output comes back as a numpy array (torch tensors are copied to the
    host, which is the point the device work is waited for)."""

    def __init__(self, fn):
        self._fn = fn

    def run(self, batch_arrays):
        out = self._fn(*batch_arrays)
        if not isinstance(out, (list, tuple)):
            out = [out]
        return [o.detach().cpu().numpy() if hasattr(o, "detach") else np.asarray(o)
                for o in out]


class BatchingEngine:
    """Shared dynamic-batching front end for a served model.

    ``infer(inputs)`` blocks the calling thread until its rows come back
    from a coalesced batch; any number of threads may call it::

        engine = BatchingEngine.for_callable(fn, max_batch_size=8,
                                             max_wait_ms=2.0, max_queue=256)
        engine.warmup(signature=[("int32", (128,))])
        outs = engine.infer([x])   # x: [rows, ...]

    ``max_batch_size`` caps the coalesced rows per fired batch,
    ``max_wait_ms`` fires a partial batch once the oldest pending request
    has waited that long, and ``max_queue`` bounds the pending requests
    (beyond it ``infer`` sheds with EngineOverloaded).
    """

    def __init__(self, runner, max_batch_size=32, max_wait_ms=2.0,
                 max_queue=256, name="engine"):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self._runner = runner
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending = []  # FIFO of _Request
        self._bucket_stats = {}  # (bucket, sig) -> _BucketStats
        self._declared = []  # bucket row counts from warmup()
        self._requests = 0
        self._rows = 0
        self._shed = 0
        self._deadline_expired = 0
        self._closed = False
        self._scheduler = threading.Thread(target=self._scheduler_loop,
                                           name=f"{name}-scheduler", daemon=True)
        self._scheduler.start()

    @classmethod
    def for_callable(cls, fn, **kw):
        """Engine over any ``fn(*arrays) -> outputs`` callable."""
        return cls(CallableRunner(fn), **kw)

    # ------------------------------------------------------------- submit
    def infer(self, inputs, timeout=None, deadline=None):
        """Run one request (arrays sharing dim 0 = rows); returns the list
        of output arrays for those rows. ``timeout`` bounds this caller's
        wait; ``deadline`` (absolute ``time.monotonic()``) is also honoured
        by the scheduler. A request of more than max_batch_size rows is
        split into chunks that each take a queue slot."""
        inputs = [np.ascontiguousarray(a) for a in inputs]
        if not inputs:
            raise ValueError("infer() needs at least one input array")
        rows = int(inputs[0].shape[0]) if inputs[0].ndim else 0
        if rows <= 0:
            raise ValueError("inputs must have a leading batch dim >= 1")
        for a in inputs:
            if a.ndim == 0 or a.shape[0] != rows:
                raise ValueError("all inputs of one request must share dim 0 "
                                 f"(got {[tuple(x.shape) for x in inputs]})")
        if deadline is not None and time.monotonic() >= deadline:
            with self._lock:
                self._deadline_expired += 1
            raise DeadlineExceeded(f"{self.name}: deadline passed before submission")
        if rows <= self.max_batch_size:
            return self._wait(self._submit([inputs], 1, deadline)[0], timeout)
        n_chunks = -(-rows // self.max_batch_size)
        if n_chunks > self.max_queue:
            # a request that can never fit is a permanent error, not a shed
            raise ValueError(f"request of {rows} rows needs {n_chunks} chunks of "
                             f"max_batch_size={self.max_batch_size} but the queue "
                             f"cap is {self.max_queue}")
        chunks = [[a[lo:lo + self.max_batch_size] for a in inputs]
                  for lo in range(0, rows, self.max_batch_size)]
        reqs = self._submit(chunks, min(2, self.max_batch_size), deadline)
        wait_until = None if timeout is None else time.monotonic() + timeout
        parts = []
        for i, r in enumerate(reqs):
            left = None if wait_until is None else max(0.0, wait_until - time.monotonic())
            try:
                parts.append(self._wait(r, left))
            except BaseException as e:
                # the joined result can never be produced: free the sibling
                # chunks' queue slots and fail them
                with self._cond:
                    for rest in reqs[i + 1:]:
                        if rest in self._pending:
                            self._pending.remove(rest)
                for rest in reqs[i + 1:]:
                    rest.fail(e)
                raise
        return [np.concatenate([p[j] for p in parts]) for j in range(len(parts[0]))]

    def _submit(self, chunks, min_bucket, deadline):
        """Admit every chunk or none (one queue slot per chunk)."""
        with self._cond:
            if self._closed:
                raise EngineClosed(f"{self.name} is closed")
            if len(self._pending) + len(chunks) > self.max_queue:
                self._shed += 1
                raise EngineOverloaded(
                    f"{self.name} queue full ({len(self._pending)} pending, cap "
                    f"{self.max_queue}, need {len(chunks)} slots); request shed")
            reqs = []
            for chunk in chunks:
                rows = int(chunk[0].shape[0])
                req = _Request(chunk, rows, _signature(chunk), min_bucket, deadline)
                self._pending.append(req)
                self._requests += 1
                self._rows += rows
                reqs.append(req)
            self._cond.notify_all()
        return reqs

    def _wait(self, req, timeout):
        if req.deadline is not None:
            # the scheduler purges expired requests; the grace lets that
            # cleaner error win over a bare TimeoutError
            dl_left = max(0.0, req.deadline - time.monotonic()) + 0.25
            timeout = dl_left if timeout is None else min(timeout, dl_left)
        if not req.event.wait(timeout):
            with self._cond:
                if req in self._pending:
                    self._pending.remove(req)
            if req.deadline is not None and time.monotonic() >= req.deadline:
                raise DeadlineExceeded(f"{self.name}: deadline passed while the "
                                       "request was in flight; result discarded")
            raise TimeoutError("engine did not answer within timeout")
        if req.error is not None:
            raise req.error
        return req.outputs

    # ---------------------------------------------------------- scheduler
    def _scheduler_loop(self):
        while True:
            group = self._next_group()
            if group is None:
                return
            try:
                self._run_group(group)
            except Exception as e:  # noqa: BLE001 - fail this group only
                for r in group:
                    r.fail(e)

    def _purge_expired_locked(self, now):
        expired = [r for r in self._pending
                   if r.deadline is not None and now >= r.deadline]
        for r in expired:
            self._pending.remove(r)
            self._deadline_expired += 1
            r.fail(DeadlineExceeded(f"{self.name}: deadline passed while queued; "
                                    "request dropped before dispatch"))

    def _next_group(self):
        """Block until a same-signature group is ready to fire: either
        max_batch_size rows are pending, the oldest request has waited
        max_wait_ms, or the tightest deadline in the group is about to
        pass. Returns None once the engine is closed and drained."""
        with self._cond:
            while True:
                now = time.monotonic()
                self._purge_expired_locked(now)
                if not self._pending:
                    if self._closed:
                        return None
                    self._cond.wait()
                    continue
                head = self._pending[0]
                group, rows = [], 0
                for r in self._pending:
                    if r.sig != head.sig:
                        continue
                    if rows + r.rows > self.max_batch_size:
                        break
                    group.append(r)
                    rows += r.rows
                fire_at = head.t_enqueue + self.max_wait_s
                tight = min((r.deadline for r in group if r.deadline is not None),
                            default=None)
                if tight is not None:
                    # dispatch before the tightest deadline, not at it
                    fire_at = min(fire_at, tight - 0.005)
                if rows >= self.max_batch_size or now >= fire_at or self._closed:
                    for r in group:
                        self._pending.remove(r)
                    return group
                self._cond.wait(fire_at - now)

    def _group_bucket(self, group):
        want = max(sum(r.rows for r in group), max(r.min_bucket for r in group))
        return bucket_rows(want, self.max_batch_size)

    def _run_group(self, group):
        rows = sum(r.rows for r in group)
        sig = group[0].sig
        bucket = self._group_bucket(group)
        batch = []
        for i in range(len(sig)):
            parts = [r.inputs[i] for r in group]
            if bucket > rows:
                parts.append(np.zeros((bucket - rows,) + parts[0].shape[1:],
                                      parts[0].dtype))
            batch.append(np.concatenate(parts) if len(parts) > 1 else parts[0])
        t0 = time.monotonic()
        outs = self._runner.run(batch)
        dt_ms = (time.monotonic() - t0) * 1000.0
        for j, o in enumerate(outs):
            if o.ndim == 0 or o.shape[0] != bucket:
                raise ValueError(
                    f"output {j} has shape {tuple(o.shape)} but the batch has "
                    f"{bucket} rows: every output must keep the batch dim as "
                    "dim 0 so per-request rows can be sliced back")
        off = 0
        for r in group:
            r.outputs = [o[off:off + r.rows] for o in outs]
            off += r.rows
            r.event.set()
        with self._lock:
            st = self._bucket_stats.get((bucket, sig))
            if st is None:
                st = self._bucket_stats[(bucket, sig)] = _BucketStats()
            st.batches += 1
            st.requests += len(group)
            st.rows += rows
            st.padded_rows += bucket - rows
            st.total_ms += dt_ms
            st.max_ms = max(st.max_ms, dt_ms)

    # ------------------------------------------------------------- warmup
    def warmup(self, buckets=None, signature=None):
        """Run a zero batch through each bucket (default: every power of
        two up to max_batch_size) so no request pays a first-call cost
        (for the CUDA path: the kernel build and the allocator's growth).
        ``signature`` is ``[(dtype, trailing_shape), ...]``. Returns the
        declared bucket list."""
        if signature is None:
            raise ValueError("warmup needs signature=[(dtype, trailing_shape), ...]")
        sig = [(np.dtype(dt), tuple(tr)) for dt, tr in signature]
        if buckets is None:
            buckets = [1 << i for i in range(self.max_batch_size.bit_length())]
            buckets.append(self.max_batch_size)
        buckets = sorted({bucket_rows(int(b), self.max_batch_size) for b in buckets})
        for b in buckets:
            self._runner.run([np.zeros((b,) + tr, dt) for dt, tr in sig])
        with self._lock:
            self._declared = buckets
        return buckets

    # -------------------------------------------------------------- stats
    def stats(self):
        """Snapshot of the engine counters (the `stats` wire command),
        taken under one lock acquisition."""
        with self._lock:
            buckets = {}
            for (bucket, sig), st in sorted(self._bucket_stats.items(),
                                            key=lambda kv: kv[0][0]):
                d = st.as_dict()
                d["signature"] = [[dt, list(tr)] for dt, tr in sig]
                buckets.setdefault(str(bucket), []).append(d)
            return {
                "name": self.name,
                "max_batch_size": self.max_batch_size,
                "max_wait_ms": round(self.max_wait_s * 1000.0, 3),
                "max_queue": self.max_queue,
                "declared_buckets": list(self._declared),
                "queue_depth": len(self._pending),
                "requests": self._requests,
                "rows": self._rows,
                "shed_count": self._shed,
                "deadline_expired": self._deadline_expired,
                "buckets": buckets,
            }

    def health(self):
        """Liveness snapshot for the `health` wire command."""
        with self._lock:
            alive = self._scheduler.is_alive()
            return {
                "ok": alive and not self._closed,
                "closed": self._closed,
                "scheduler_alive": alive,
                "queue_depth": len(self._pending),
                "declared_buckets": list(self._declared),
            }

    # -------------------------------------------------------------- close
    def close(self, timeout=5.0):
        """Stop the scheduler; pending requests still fire (partial
        batches), new submissions raise EngineClosed."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._scheduler.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
