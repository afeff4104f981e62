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

**Robustness** (the reference's): a batch that raises fails only its own
group, and every ``(bucket, signature)`` has a circuit breaker
(:class:`_Breaker`): ``breaker_threshold`` consecutive failures quarantine
the bucket, which then sheds its groups with :class:`BucketQuarantined`
(wire status 2) while the other buckets keep serving, until one probe
after ``breaker_cooldown`` s succeeds. A watchdog thread (every
``watchdog_interval`` s; 0 turns it off and a dying scheduler restarts
itself) restarts a scheduler that died or wedged (heartbeat and the
oldest waiting request both older than ``wedge_timeout``): the group in
flight fails with :class:`SchedulerRestarted` (retryable), the queued
requests are served by the replacement thread, and a superseded thread
exits without delivering. The port reads no environment: the defaults
are the reference's environment defaults (3, 5.0 s, 0.5 s, 30.0 s).

**Telemetry**: the engine's counters are obs instruments (const label
``engine=<name>``), exposed by a collector in ``obs.metrics.REGISTRY``
until ``close``; ``infer(trace_id=...)`` records the ``serving.request``,
``serving.queue`` and ``serving.execute`` spans. Chaos sites:
``serving.submit``, ``serving.scheduler.loop``, ``serving.execute`` and
``serving.execute.bucket{n}``.

The ``quant`` label (compiles, ``stats``) is the served layer's
``_quant_mode`` (``jit.save(quant=)`` sets it), else "f32", as in the
reference: a layer quantized in place (``quantization.quantize_weights``)
behind ``for_callable`` serves as "f32" there too.

``for_layer`` serves a ``jit.load``-ed, batch-polymorphic
``TranslatedLayer`` (``AotLayerRunner``: dim 0 of every input symbolic,
the rest concrete). **Determinism contract** (the reference's,
paddle_tpu/inference/batching.py:88-99): a request of >= 2 rows served
through the engine is bitwise ``Predictor.run`` of the same rows, and so
is a solo 1-row request. On the card cuBLAS picks its GEMM per M, so a
batch of 8 rows and a direct call of 2 round differently; the layer
therefore runs every batch, and ``Predictor.run`` every direct call, in
slabs of one row count (``TranslatedLayer.run_slabs``, the last slab
padded): a row's bits in a GEMM depend on (M, N, K), not on its position,
K1 keeps a row's bits beside any neighbours and LayerNorm is per row. A
1-row tail chunk of a split request pads to bucket 2, as in the
reference.

**Meshed serving** (the reference's): ``for_layer(layer, mesh="tp2",
mesh_devices=...)`` serves the layer's sharded form
(``TranslatedLayer.sharded``, inference/sharding.py): the weights are
split once, at construction (too few devices raise there), and every
bucket runs the same rewritten program, whose products run per shard.
The mesh is the ``mesh`` const label of the compiles and ``stats()`` /
``health()["mesh"]``. Integer and bool replies are bitwise the single
mesh's; float replies sit within ``sharding.SHARDED_FLOAT_TOL``.

Not ported: cold-compile threads, and the artifact store of compiled
programs (``for_layer``'s ``artifact_store`` raises; ROADMAP Queue 3
(b)). The port's runners compile nothing: the first batch of a bucket
(or its warmup) is counted as its one ``inline`` compile, as it builds
the kernels and grows the allocator; a loaded layer's is a compile-ledger
event (obs/ledger.py), ``serving/bucket{b}``, with the program's ATen
ops.
"""
import threading
import time
import traceback
import weakref

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import tracing as obs_tracing
from ..obs.ledger import LEDGER
from ..resilience import chaos
from . import sharding
from .wire_spec import STATUS_RETRYABLE


class RetryableError(RuntimeError):
    """Transient serving failure: back off and retry (wire status 2)."""

    status_code = STATUS_RETRYABLE


class EngineOverloaded(RetryableError):
    """The bounded queue is full: the request was shed."""


class BucketQuarantined(RetryableError):
    """This request's program breaker is open after repeated failures;
    the program sheds fast while it cools down. Other programs keep
    serving."""


class SchedulerRestarted(RetryableError):
    """The scheduler died or wedged while this request was in flight; the
    watchdog restarted it. Its results (if any) were discarded, never
    delivered, so a retry cannot observe a double answer."""


class DeadlineExceeded(RetryableError):
    """The request's deadline passed before its batch dispatched; it was
    dropped without spending compute."""


class EngineClosed(RuntimeError):
    pass


class _Breaker:
    """Per-program circuit breaker (the reference's ``_Breaker``). All
    methods are called under the owning engine's lock.

    closed --threshold consecutive failures--> open --cooldown--> half_open
      ^                                          ^                    |
      +----------- probe succeeds ---------------+--- probe fails ----+
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    __slots__ = ("threshold", "cooldown", "state", "failures", "opened_at", "trips", "shed")

    def __init__(self, threshold, cooldown):
        self.threshold = threshold
        self.cooldown = cooldown
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.trips = 0
        self.shed = 0

    def allow(self, now):
        """May a call of this program run now? OPEN past its cooldown
        admits exactly one probe (HALF_OPEN); another call while the
        probe is out is refused."""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN and now - self.opened_at >= self.cooldown:
            self.state = self.HALF_OPEN
            return True
        return False

    def record_success(self):
        self.failures = 0
        self.state = self.CLOSED

    def record_failure(self, now):
        self.failures += 1
        if self.threshold <= 0:
            return  # disabled: count, never trip
        if self.state == self.HALF_OPEN or self.failures >= self.threshold:
            self.state = self.OPEN
            self.opened_at = now
            self.trips += 1

    def as_dict(self):
        return {"state": self.state, "consecutive_failures": self.failures,
                "trips": self.trips, "shed": self.shed}


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
                 "t_enqueue", "min_bucket", "deadline", "trace_id")

    def __init__(self, inputs, rows, sig, min_bucket=1, deadline=None, trace_id=None):
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
        self.trace_id = trace_id

    def fail(self, error):
        if not self.event.is_set():
            self.error = error
            self.event.set()


class _BucketStats:
    __slots__ = ("batches", "requests", "rows", "padded_rows", "total_ms",
                 "max_ms", "program_calls", "k1_launches")

    def __init__(self):
        self.batches = 0
        self.requests = 0
        self.rows = 0
        self.padded_rows = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        # the port's: a loaded layer's program calls (slabs) and the K1
        # launches made in them, over the bucket's batches (None for a
        # runner that does not count them, a callable's)
        self.program_calls = None
        self.k1_launches = None

    def as_dict(self):
        return {
            "batches": self.batches,
            "requests": self.requests,
            "rows": self.rows,
            "padded_rows": self.padded_rows,
            "total_ms": round(self.total_ms, 3),
            "avg_ms": round(self.total_ms / self.batches, 3) if self.batches else 0.0,
            "max_ms": round(self.max_ms, 3),
            "program_calls": self.program_calls,
            "k1_launches": self.k1_launches,
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


class AotLayerRunner:
    """Execute batches of a ``jit.load``-ed ``TranslatedLayer`` (the
    reference's ``AotLayerRunner``): its program must be batch-polymorphic
    in dim 0 of every input and concrete elsewhere. The weights stay on
    the layer's device, shared by every bucket; each batch runs the
    layer's slabs (the module docstring's contract).

    ``mesh`` (None reads ``PADDLE_TPU_SERVING_MESH``, else "single"): a
    sharded serving mesh (inference/sharding.py) is built here, failing
    fast without enough devices, and the layer is replaced by its sharded
    form over ``mesh_devices`` (or the launcher's ranks), once; the runner
    keeps no reference to the whole weights. A save that recorded another
    mesh's shard count is refused (``sharding.check_nr_devices``)."""

    def __init__(self, layer, mesh=None, mesh_devices=None):
        self._mesh = sharding.resolve(mesh)
        self.mesh_desc = self._mesh.descriptor
        self.quant_mode = getattr(layer, "_quant_mode", None)
        self.mesh_devices = None
        sharding.check_nr_devices(getattr(layer, "_serving_mesh", None), self._mesh)
        if not self._mesh.is_single:
            placement = self._mesh.build(mesh_devices)
            if self.quant_mode is not None:
                raise NotImplementedError(
                    f"serving a {self.quant_mode} save under mesh {self.mesh_desc!r}: "
                    "quantized weights under a mesh are a ROADMAP follow-up (meshed serving)")
            layer = layer.sharded(placement)
            self.mesh_devices = placement.describe()
        self._layer = layer
        # the port's counters (stats' "program_calls", "k1_launches"): the
        # layer's program calls (slabs) and the K1 launches made in them
        self.program_calls = 0
        self.k1_launches = 0
        specs = getattr(layer, "_input_specs", None) or []
        if not specs:
            raise ValueError("layer has no input specs; was it jit-saved?")
        if not getattr(layer, "_polymorphic", False):
            raise ValueError(
                "dynamic batching needs a batch-polymorphic saved model: re-save with "
                "paddle.jit.save(..., input_spec=[InputSpec([None, ...], dtype)]) so dim 0 "
                "exports as a symbolic size (BatchingEngine.for_callable is the fallback "
                "for fixed-shape models)")
        self._trailing, self._dtypes = [], []
        for shape, dtype in specs:
            if shape and shape[0] is not None:
                raise ValueError(f"input spec {shape} has a concrete dim 0; every input must "
                                 "be batch-polymorphic for bucket batching")
            if any(d is None for d in shape[1:]):
                raise ValueError(
                    f"input spec {shape} has a symbolic non-batch dim; the batching engine "
                    "buckets dim 0 only: re-save with concrete trailing dims (or pad/bucket "
                    "those dims client-side before submitting)")
            self._trailing.append(tuple(int(d) for d in shape[1:]))
            self._dtypes.append(np.dtype(dtype))

    def default_signature(self):
        """The saved model's batch signature (for warmup)."""
        return tuple((dt.str, tr) for dt, tr in zip(self._dtypes, self._trailing))

    def record_first_run(self, bucket, sig, seconds):
        """A bucket's first run, as the reference records its compile: a
        compile-ledger event ``serving/bucket{b}`` with the program's ATen
        ops, tagged with the quant mode and the mesh where they are not
        f32 and "single"."""
        extra = {"bucket": bucket, "signature": [[dt, list(tr)] for dt, tr in sig]}
        if self.quant_mode:
            extra["quant"] = self.quant_mode
        if self.mesh_desc != sharding.SINGLE:
            extra["mesh"] = self.mesh_desc
        LEDGER.record(f"serving/bucket{bucket}", duration_s=seconds,
                      graph=self._layer.program_graph(), kind="aot", extra=extra)

    def run(self, batch_arrays):
        import torch

        from ..ops import flash_attention

        dev = self._layer.device
        before = flash_attention.launches
        # a request decoded off the wire is a read-only view: copied once
        outs = self._layer.run_slabs([torch.from_numpy(a if a.flags.writeable else a.copy())
                                      .to(dev) for a in batch_arrays])
        self.k1_launches += flash_attention.launches - before
        self.program_calls += -(-int(batch_arrays[0].shape[0]) // self._layer._slab_rows)
        return [o.cpu().numpy() for o in outs]


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
    ``breaker_threshold``/``breaker_cooldown``: every bucket's circuit
    breaker; ``watchdog_interval``/``wedge_timeout``: the scheduler's
    watchdog (module docstring).
    """

    def __init__(self, runner, max_batch_size=32, max_wait_ms=2.0,
                 max_queue=256, name="engine", breaker_threshold=None,
                 breaker_cooldown=None, watchdog_interval=None, wedge_timeout=None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self._runner = runner
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.name = name
        self.breaker_threshold = int(3 if breaker_threshold is None else breaker_threshold)
        self.breaker_cooldown = float(5.0 if breaker_cooldown is None else breaker_cooldown)
        self.watchdog_interval = float(0.5 if watchdog_interval is None else watchdog_interval)
        self.wedge_timeout = float(30.0 if wedge_timeout is None else wedge_timeout)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending = []  # FIFO of _Request
        self._bucket_stats = {}  # (bucket, sig) -> _BucketStats
        self._breakers = {}  # (bucket, sig) -> _Breaker
        self._warm = set()  # (bucket, sig) run at least once
        self._declared = []  # bucket row counts from warmup()
        self._closed = False
        self._closed_ev = threading.Event()
        self._init_metrics()
        # a restart bumps the generation; a superseded scheduler sees it
        # and exits without delivering
        self._sched_gen = 0
        self._heartbeat = time.monotonic()  # bumped every scheduler iteration
        self._inflight = {}  # gen -> the group popped and not yet answered
        self._watchdog = None  # before the scheduler starts: its crash path reads it
        self._scheduler = threading.Thread(target=self._run_scheduler, args=(0,),
                                           name=f"{name}-scheduler", daemon=True)
        self._scheduler.start()
        if self.watchdog_interval > 0:
            self._watchdog = threading.Thread(target=self._run_watchdog,
                                              name=f"{name}-watchdog", daemon=True)
            self._watchdog.start()

    @classmethod
    def for_callable(cls, fn, **kw):
        """Engine over any ``fn(*arrays) -> outputs`` callable."""
        return cls(CallableRunner(fn), **kw)

    @classmethod
    def for_layer(cls, layer, artifact_store=None, mesh=None, mesh_devices=None, **kw):
        """Engine over a ``jit.load``-ed batch-polymorphic TranslatedLayer
        (``AotLayerRunner``; ``mesh`` and ``mesh_devices``: its serving
        mesh, built here, so too few devices raise at once).
        ``artifact_store`` (the reference's store of each bucket's compiled
        program) is not ported and raises: the
        loaded layer is already one ``torch.export`` program with no
        per-bucket compile to keep, and the port's engine programs are
        CUDA graphs, which have no serialized form across processes
        (ROADMAP Queue 3 (b))."""
        if artifact_store is not None:
            raise NotImplementedError(
                "BatchingEngine.for_layer(artifact_store=...): a loaded layer is one "
                "torch.export program with no per-bucket compile for a store to keep, and "
                "CUDA graphs have no serialized form across processes (ROADMAP Queue 3 (b))")
        return cls(AotLayerRunner(layer, mesh=mesh, mesh_devices=mesh_devices), **kw)

    @property
    def quant(self):
        """The served layer's quant mode, "f32" for none."""
        return getattr(self._runner, "quant_mode", None) or "f32"

    @property
    def mesh(self):
        """The served layer's serving mesh descriptor, "single" for none."""
        return getattr(self._runner, "mesh_desc", None) or sharding.SINGLE

    # ---------------------------------------------------------- telemetry
    def _init_metrics(self):
        """The engine's counters as obs instruments (the reference's
        families, names, labels and buckets; const label ``engine``, and
        ``quant``/``mesh`` on the compiles), exposed through a collector
        in the process registry until ``close``. ``stats`` and ``health``
        read them under the engine lock."""
        cl = {"engine": self.name}
        M = obs_metrics
        lat = M.log_buckets(0.0001, 4.0, 10)
        self._m_requests = M.Counter("paddle_serving_requests_total",
                                     "Requests admitted to the batching engine",
                                     const_labels=cl)
        self._m_rows = M.Counter("paddle_serving_rows_total",
                                 "Input rows admitted to the batching engine", const_labels=cl)
        self._m_shed = M.Counter("paddle_serving_shed_total",
                                 "Requests shed (reason: queue_full | quarantine)",
                                 labelnames=("reason",), const_labels=cl)
        self._m_deadline = M.Counter(
            "paddle_serving_deadline_total",
            "Deadline outcomes (stage: expired = dropped pre-dispatch, zero compute; late = "
            "expired in flight, compute spent)", labelnames=("stage",), const_labels=cl)
        self._m_restarts = M.Counter("paddle_serving_scheduler_restarts_total",
                                     "Watchdog scheduler restarts", const_labels=cl)
        self._m_compiles = M.Counter(
            "paddle_serving_compiles_total",
            "Bucket program materializations (source: inline = the bucket's first run; "
            "quant: the serving quantization mode; mesh: the serving mesh descriptor)",
            labelnames=("bucket", "source"),
            const_labels={**cl, "quant": self.quant, "mesh": self.mesh})
        self._m_batches = M.Counter("paddle_serving_batches_total", "Batches executed",
                                    labelnames=("bucket",), const_labels=cl)
        self._m_batch_rows = M.Counter("paddle_serving_batch_rows_total",
                                       "Real rows executed per bucket",
                                       labelnames=("bucket",), const_labels=cl)
        self._m_padded = M.Counter("paddle_serving_padded_rows_total",
                                   "Padding rows executed per bucket",
                                   labelnames=("bucket",), const_labels=cl)
        self._m_queue_depth = M.Gauge("paddle_serving_queue_depth",
                                      "Pending requests in the bounded queue", const_labels=cl)
        self._m_queue_wait = M.Histogram("paddle_serving_queue_wait_seconds",
                                         "Enqueue-to-dispatch wait per request",
                                         const_labels=cl, buckets=lat)
        self._m_occupancy = M.Histogram(
            "paddle_serving_batch_occupancy", "Real rows / bucket size per executed batch",
            const_labels=cl, buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        self._m_exec = M.Histogram("paddle_serving_batch_exec_seconds",
                                   "Batch execute duration", labelnames=("bucket",),
                                   const_labels=cl, buckets=lat)
        self._instruments = [
            self._m_requests, self._m_rows, self._m_shed, self._m_deadline, self._m_restarts,
            self._m_compiles, self._m_batches, self._m_batch_rows, self._m_padded,
            self._m_queue_depth, self._m_queue_wait, self._m_occupancy, self._m_exec]
        # weakly held: an engine dropped without close() is collected, and
        # its collector then unregisters itself (it returns None)
        ref = weakref.ref(self)

        def collector():
            eng = ref()
            return eng._collect_families() if eng is not None else None

        self._obs_collector = collector
        obs_metrics.REGISTRY.register_collector(collector)

    def _collect_families(self):
        with self._lock:
            self._m_queue_depth.set(len(self._pending))
            return [m.collect() for m in self._instruments]

    # ------------------------------------------------------------- submit
    def infer(self, inputs, timeout=None, deadline=None, trace_id=None):
        """Run one request (arrays sharing dim 0 = rows); returns the list
        of output arrays for those rows. ``timeout`` bounds this caller's
        wait; ``deadline`` (absolute ``time.monotonic()``) is also honoured
        by the scheduler. A request of more than max_batch_size rows is
        split into chunks that each take a queue slot. ``trace_id``
        (default: the thread's ambient obs.tracing id) tags the request's
        ``serving.request``, ``serving.queue`` and ``serving.execute``
        spans."""
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
        if trace_id is None:
            trace_id = obs_tracing.current_trace_id()
        t0 = time.perf_counter()
        try:
            if deadline is not None and time.monotonic() >= deadline:
                self._m_deadline.inc(stage="expired")
                raise DeadlineExceeded(f"{self.name}: deadline passed before submission")
            if rows <= self.max_batch_size:
                out = self._wait(self._submit([inputs], 1, deadline, trace_id)[0], timeout)
            else:
                out = self._infer_split(inputs, rows, timeout, deadline, trace_id)
        except BaseException as e:
            self._span_request(trace_id, t0, rows, type(e).__name__)
            raise
        self._span_request(trace_id, t0, rows, "ok")
        return out

    def _span_request(self, trace_id, t0, rows, outcome):
        """The whole request's span for a traced request; the summary
        table only for an untraced one."""
        dt = time.perf_counter() - t0
        if trace_id is not None:
            obs_tracing.record_span("serving.request", dt, trace_id=trace_id,
                                    engine=self.name, rows=rows, outcome=outcome)
        else:
            obs_tracing.observe("serving.request", dt)

    def _infer_split(self, inputs, rows, timeout, deadline, trace_id):
        n_chunks = -(-rows // self.max_batch_size)
        if n_chunks > self.max_queue:
            # a request that can never fit is a permanent error, not a shed
            raise ValueError(f"request of {rows} rows needs {n_chunks} chunks of "
                             f"max_batch_size={self.max_batch_size} but the queue "
                             f"cap is {self.max_queue}")
        chunks = [[a[lo:lo + self.max_batch_size] for a in inputs]
                  for lo in range(0, rows, self.max_batch_size)]
        reqs = self._submit(chunks, min(2, self.max_batch_size), deadline, trace_id)
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

    def _submit(self, chunks, min_bucket, deadline, trace_id=None):
        """Admit every chunk or none (one queue slot per chunk)."""
        chaos.hit("serving.submit")
        with self._cond:
            if self._closed:
                raise EngineClosed(f"{self.name} is closed")
            if len(self._pending) + len(chunks) > self.max_queue:
                self._m_shed.inc(reason="queue_full")
                raise EngineOverloaded(
                    f"{self.name} queue full ({len(self._pending)} pending, cap "
                    f"{self.max_queue}, need {len(chunks)} slots); request shed")
            reqs = []
            for chunk in chunks:
                rows = int(chunk[0].shape[0])
                req = _Request(chunk, rows, _signature(chunk), min_bucket, deadline, trace_id)
                self._pending.append(req)
                self._m_requests.inc()
                self._m_rows.inc(rows)
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
                self._m_deadline.inc(stage="late")
                raise DeadlineExceeded(f"{self.name}: deadline passed while the "
                                       "request was in flight; result discarded")
            raise TimeoutError("engine did not answer within timeout")
        if req.error is not None:
            raise req.error
        return req.outputs

    # ---------------------------------------------------------- scheduler
    def _run_scheduler(self, gen):
        try:
            self._scheduler_loop(gen)
        except Exception:  # noqa: BLE001 - the watchdog owns recovery
            # die with the group still in _inflight: the restart fails it
            # retryable and a replacement serves the queue
            traceback.print_exc()
            if self._watchdog is None:
                self._restart_scheduler(gen, "died (watchdog disabled)")

    def _scheduler_loop(self, gen):
        while True:
            # a float store: the watchdog only compares it with a threshold
            self._heartbeat = time.monotonic()
            group = self._next_group(gen)
            if group is None:
                return  # closed and drained, or superseded by a restart
            with self._lock:
                self._inflight[gen] = group
            # an exception from here to the hand-off kills this thread with
            # the group in _inflight: the watchdog fails exactly that group
            chaos.hit("serving.scheduler.loop")
            key = (self._group_bucket(group), group[0].sig)
            with self._lock:
                br = self._breaker_for(key)
                allowed = br.allow(time.monotonic())
                if not allowed:
                    br.shed += len(group)
                    self._m_shed.inc(len(group), reason="quarantine")
            if not allowed:
                err = BucketQuarantined(
                    f"{self.name} bucket {key[0]} is quarantined after {br.failures} "
                    f"consecutive failures; retry after cooldown ({self.breaker_cooldown}s)")
                for r in group:
                    r.fail(err)
                with self._lock:
                    self._inflight.pop(gen, None)
                continue
            err = None
            try:
                self._run_group(group, gen)
            except Exception as e:  # noqa: BLE001 - fail this group only
                err = e
            with self._lock:
                # answered either way: a later restart must not fail it
                # again; a superseded thread's outcome is no news for the
                # breaker (the restart judged a stranded probe already)
                self._inflight.pop(gen, None)
                if self._sched_gen == gen:
                    if err is None:
                        br.record_success()
                    else:
                        br.record_failure(time.monotonic())
            if err is not None:
                for r in group:
                    r.fail(err)

    def _purge_expired_locked(self, now):
        expired = [r for r in self._pending
                   if r.deadline is not None and now >= r.deadline]
        for r in expired:
            self._pending.remove(r)
            self._m_deadline.inc(stage="expired")
            r.fail(DeadlineExceeded(f"{self.name}: deadline passed while queued; "
                                    "request dropped before dispatch"))

    def _next_group(self, gen):
        """Block until a same-signature group is ready to fire: either
        max_batch_size rows are pending, the oldest request has waited
        max_wait_ms, or the tightest deadline in the group is about to
        pass. Returns None once the engine is closed and drained, or this
        scheduler's generation is over."""
        with self._cond:
            while True:
                if self._sched_gen != gen:
                    return None  # a restart superseded this thread
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
                    t_pop = time.monotonic()
                    for r in group:
                        self._pending.remove(r)
                        wait = t_pop - r.t_enqueue
                        self._m_queue_wait.observe(wait)
                        if r.trace_id is not None:
                            obs_tracing.record_span("serving.queue", wait, trace_id=r.trace_id,
                                                    engine=self.name, rows=r.rows)
                    return group
                self._cond.wait(fire_at - now)

    def _group_bucket(self, group):
        want = max(sum(r.rows for r in group), max(r.min_bucket for r in group))
        return bucket_rows(want, self.max_batch_size)

    def _run_group(self, group, gen):
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
        chaos.hit("serving.execute")
        chaos.hit(f"serving.execute.bucket{bucket}")
        counted = getattr(self._runner, "k1_launches", None) is not None
        if counted:
            calls0, k1_0 = self._runner.program_calls, self._runner.k1_launches
        t0 = time.monotonic()
        outs = self._runner.run(batch)
        dt = time.monotonic() - t0
        # one execute per group: each traced request gets a span of it,
        # untraced traffic only feeds the summary table
        tids = {r.trace_id for r in group if r.trace_id is not None}
        for tid in tids:
            obs_tracing.record_span("serving.execute", dt, trace_id=tid, engine=self.name,
                                    bucket=bucket, rows=rows)
        if not tids:
            obs_tracing.observe("serving.execute", dt)
        for j, o in enumerate(outs):
            if o.ndim == 0 or o.shape[0] != bucket:
                raise ValueError(
                    f"output {j} has shape {tuple(o.shape)} but the batch has "
                    f"{bucket} rows: every output must keep the batch dim as "
                    "dim 0 so per-request rows can be sliced back")
        with self._lock:
            if self._sched_gen != gen:
                # a restart failed this group while it ran: its results go
                # nowhere (the waiters already hold SchedulerRestarted)
                return
            self._count_first_run((bucket, sig), dt)
            st = self._bucket_stats.get((bucket, sig))
            if st is None:
                st = self._bucket_stats[(bucket, sig)] = _BucketStats()
            st.batches += 1
            st.requests += len(group)
            st.rows += rows
            st.padded_rows += bucket - rows
            st.total_ms += dt * 1e3
            st.max_ms = max(st.max_ms, dt * 1e3)
            if counted:
                st.program_calls = (st.program_calls or 0) + self._runner.program_calls - calls0
                st.k1_launches = (st.k1_launches or 0) + self._runner.k1_launches - k1_0
            bs = str(bucket)
            self._m_batches.inc(bucket=bs)
            self._m_batch_rows.inc(rows, bucket=bs)
            self._m_padded.inc(bucket - rows, bucket=bs)
            self._m_exec.observe(dt, bucket=bs)
            self._m_occupancy.observe(rows / bucket)
        off = 0
        for r in group:
            r.outputs = [o[off:off + r.rows] for o in outs]
            off += r.rows
            r.event.set()

    def _count_first_run(self, key, seconds):
        """Under the lock: a bucket's first run (warmup or a batch, of
        ``seconds``) is its one ``inline`` materialization, and a loaded
        layer's runner records it in the compile ledger."""
        if key not in self._warm:
            self._warm.add(key)
            self._m_compiles.inc(bucket=str(key[0]), source="inline")
            record = getattr(self._runner, "record_first_run", None)
            if record is not None:
                record(key[0], key[1], seconds)

    def _breaker_for(self, key):
        """Under the lock: the bucket's breaker, made at first use."""
        br = self._breakers.get(key)
        if br is None:
            br = self._breakers[key] = _Breaker(self.breaker_threshold, self.breaker_cooldown)
        return br

    # ----------------------------------------------------------- watchdog
    def _run_watchdog(self):
        """Restart a dead or wedged scheduler (heartbeat stale AND the
        oldest waiting request, or the group in flight, stale: a long
        execute with a fresh queue is no wedge). Makes no device call."""
        while not self._closed_ev.wait(self.watchdog_interval):
            with self._lock:
                if self._closed:
                    return
                gen, th, hb = self._sched_gen, self._scheduler, self._heartbeat
                head = self._pending[0] if self._pending else None
                group = self._inflight.get(gen)
            now = time.monotonic()
            if head is not None:
                oldest = head.t_enqueue
            elif group:
                oldest = min(r.t_enqueue for r in group)
            else:
                oldest = None
            if not th.is_alive():
                self._restart_scheduler(gen, "died")
            elif (oldest is not None and now - hb > self.wedge_timeout
                    and now - oldest > self.wedge_timeout):
                self._restart_scheduler(gen, "wedged (heartbeat stale)")

    def _restart_scheduler(self, observed_gen, reason):
        with self._cond:
            if self._closed or observed_gen != self._sched_gen:
                return  # already restarted, or closing
            self._sched_gen += 1
            gen = self._sched_gen
            stranded = self._inflight.pop(observed_gen, None)
            if stranded:
                # a stranded half-open probe counts as a failed probe (back
                # to OPEN, fresh cooldown): a breaker left HALF_OPEN would
                # shed its bucket for ever. A closed one is left alone: a
                # scheduler death is not the bucket's fault
                br = self._breakers.get((self._group_bucket(stranded), stranded[0].sig))
                if br is not None and br.state == _Breaker.HALF_OPEN:
                    br.record_failure(time.monotonic())
            self._m_restarts.inc()
            self._heartbeat = time.monotonic()
            t = threading.Thread(target=self._run_scheduler, args=(gen,),
                                 name=f"{self.name}-scheduler-g{gen}", daemon=True)
            self._scheduler = t
            # started under the lock: close() never joins an unstarted thread
            t.start()
            self._cond.notify_all()  # a superseded thread parked in wait()
        if stranded:
            err = SchedulerRestarted(
                f"{self.name} scheduler {reason} and was restarted; this request's group "
                "was in flight and its results (if any) were discarded; retry it")
            for r in stranded:
                r.fail(err)

    # ------------------------------------------------------------- warmup
    def warmup(self, buckets=None, signature=None):
        """Run a zero batch through each bucket (default: every power of
        two up to max_batch_size) so no request pays a first-call cost
        (for the CUDA path: the kernel build and the allocator's growth).
        ``signature`` is ``[(dtype, trailing_shape), ...]`` (default: a
        loaded layer's saved signature). Returns the declared bucket
        list."""
        if signature is None:
            default = getattr(self._runner, "default_signature", None)
            signature = default() if default is not None else None
        if signature is None:
            raise ValueError("warmup needs signature=[(dtype, trailing_shape), ...]")
        sig = [(np.dtype(dt), tuple(tr)) for dt, tr in signature]
        if buckets is None:
            buckets = [1 << i for i in range(self.max_batch_size.bit_length())]
            buckets.append(self.max_batch_size)
        buckets = sorted({bucket_rows(int(b), self.max_batch_size) for b in buckets})
        for b in buckets:
            batch = [np.zeros((b,) + tr, dt) for dt, tr in sig]
            t0 = time.monotonic()
            self._runner.run(batch)
            with self._lock:
                self._count_first_run((b, _signature(batch)), time.monotonic() - t0)
        with self._lock:
            self._declared = buckets
        return buckets

    def declared_buckets(self):
        """The bucket sizes the last ``warmup`` declared."""
        with self._lock:
            return list(self._declared)

    # -------------------------------------------------------------- stats
    def stats(self):
        """Snapshot of the engine counters (the `stats` wire command),
        taken under one lock acquisition: a view over the obs
        instruments."""
        with self._lock:
            buckets = {}
            for (bucket, sig), st in sorted(self._bucket_stats.items(),
                                            key=lambda kv: kv[0][0]):
                d = st.as_dict()
                d["signature"] = [[dt, list(tr)] for dt, tr in sig]
                br = self._breakers.get((bucket, sig))
                if br is not None:
                    d["breaker"] = br.as_dict()
                buckets.setdefault(str(bucket), []).append(d)
            states = [br.state for br in self._breakers.values()]
            return {
                "name": self.name,
                "quant": self.quant,
                "max_batch_size": self.max_batch_size,
                "max_wait_ms": round(self.max_wait_s * 1000.0, 3),
                "max_queue": self.max_queue,
                "declared_buckets": list(self._declared),
                "queue_depth": len(self._pending),
                "requests": int(self._m_requests.value()),
                "rows": int(self._m_rows.value()),
                "shed_count": int(self._m_shed.value(reason="queue_full")),
                "quarantine_shed": int(self._m_shed.value(reason="quarantine")),
                "deadline_expired": int(self._m_deadline.value(stage="expired")),
                "deadline_late": int(self._m_deadline.value(stage="late")),
                "scheduler_restarts": int(self._m_restarts.value()),
                "breaker": {
                    "threshold": self.breaker_threshold,
                    "cooldown_s": self.breaker_cooldown,
                    "open": states.count(_Breaker.OPEN),
                    "half_open": states.count(_Breaker.HALF_OPEN),
                    "trips": sum(br.trips for br in self._breakers.values()),
                },
                "compiles": len(self._warm),
                # no artifact store (ROADMAP Queue 3 (b)): the reference's
                # key, at what it reads here
                "store_loads": 0,
                "mesh": self.mesh,
                "buckets": buckets,
            }

    def health(self):
        """Liveness snapshot for the `health` wire command."""
        now = time.monotonic()
        with self._lock:
            alive = self._scheduler.is_alive()
            return {
                "ok": alive and not self._closed,
                "closed": self._closed,
                "scheduler_alive": alive,
                "heartbeat_age_s": round(now - self._heartbeat, 3),
                "scheduler_restarts": int(self._m_restarts.value()),
                "queue_depth": len(self._pending),
                "quarantined_buckets": sorted(b for (b, _), br in self._breakers.items()
                                              if br.state != _Breaker.CLOSED),
                "declared_buckets": list(self._declared),
                "cold_compiles_inflight": 0,
                "artifact_store": None,
                "mesh": self.mesh,
            }

    # -------------------------------------------------------------- close
    def close(self, timeout=5.0):
        """Stop the scheduler and the watchdog; pending requests still fire
        (partial batches), new submissions raise EngineClosed. The
        engine's metrics leave the registry."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._closed_ev.set()
            self._cond.notify_all()
            sched = self._scheduler
        obs_metrics.REGISTRY.unregister_collector(self._obs_collector)
        sched.join(timeout)
        if self._watchdog is not None:
            self._watchdog.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
