"""Front-tier fleet router (counterpart of
paddle_tpu/inference/router.py, ported whole).

Speaks the exact PredictorServer wire protocol on its front socket, so
every existing client (Go/R/C, plain sockets) points at the router
instead of a replica and nothing else changes, and it routes to the
reference's replicas as to the port's: the bytes it relays are the
wire's. Behind it, a :class:`~.registry.ReplicaRegistry` of
``serve_model`` or decode replicas. Per cmd-1 infer request the router:

1. **admits** through a weighted-fair gate: per-tenant FIFO queues
   (tenant = the optional ``0x7E`` trailing wire field, see
   :func:`tenant_id`; untagged requests share the ``default`` tenant)
   scheduled by start-time fair queueing — each grant consumes
   ``1/weight`` of virtual time, so a noisy tenant saturating its queue
   cannot starve a polite one — over a bounded total concurrency; a
   tenant whose own queue is full is shed *immediately* (status 2,
   accounted to that tenant alone);
2. **routes** to the least-loaded routable replica (router in-flight +
   last heartbeat queue depth, warm-bucket count breaking ties toward
   replicas whose ladder is already compiled), chaos site
   ``fleet.route``;
3. **retries**: a replica answering the retryable status 2 (shed /
   quarantined / restarting) is retried on a *different* replica with
   bounded exponential backoff + jitter (the ``resilience/retry.py``
   shape); a replica that dies mid-request (connect/read error or
   timeout) is reported to the registry — poisoned, ejected, probed
   back in — and the request fails over to another replica immediately
   (no backoff: the failure was detected, not load-signalled);
4. **accounts**: per-tenant request/shed/deadline counters in the
   port's ``obs`` registry and a serving-goodput ledger entry
   (``obs.goodput.SERVING_LEDGER``) per finished request.

The client contract under ANY single-replica failure is: every request
ends with status 0 (correct tensors) or status 2 (retryable) — never a
hang, never a wrong answer, never a status-1 error caused by fleet
topology. Status 1 is reserved for genuine request errors the replica
itself reported.

Draining (zero-drop reload / scale-down): :meth:`FleetRouter.drain`
marks a replica not-routable, optionally tells the replica itself (wire
cmd 8, so its own health announces ``accepting: false``), then waits
for the router's in-flight count on that replica to reach zero.
In-flight requests finish; new ones go elsewhere; nothing drops. The
port's replica admits no new request once it drains (it answers status
2, where the reference's keeps serving): a request that races the drain
gets that status 2 and is retried on another replica like any shed, so
the client never sees it.

Stream resume: for relayed decode streams the "fails over to
another replica" promise extends PAST the first token. The router
stamps its snapshot cadence into the forwarded decode field, retains
the newest kv-snapshot frame each replica interleaves into its stream
(stripped before clients that never opted in — their bytes are
identical with the feature on or off), and on a mid-stream replica
death re-drives the remainder on another replica via the kv_resume
command: delivered tokens are trimmed by sequence position (zero
duplicated, zero lost), the resumed suffix is bitwise what the dead
replica would have produced (the engine's solo-vs-batch contract), the
per-token deadline clock keeps running across the outage, and a
replica with a different model fingerprint / weights digest / quant
mode / mesh refuses the hand-off (status 2, tried elsewhere) instead
of decoding garbage. No snapshot yet, or every candidate refused →
today's status-2 terminal frame. The held snapshot is a counted
resource: every hold comes from ``_snap_hold`` and ends in one
``_snap_release``, and :meth:`FleetRouter.live_snapshots` (the
counterpart of the reference's restrace census) counts the snapshots
held, 0 once every relay path has dropped its own.

Disaggregated serving: when the fleet is split into phase
pools (``Fleet(pools=...)`` — the registry's health probes carry each
replica's ``phase``), a genuine decode stream is served as a
prefill->decode HANDOFF: the prefill leg runs the handoff-bit cmd 1 on
a prefill replica (one kv-snapshot frame + the first token back), the
first token goes straight to the client (TTFT never waits for decode
placement), and the decode leg seeds a decode replica via kv_resume —
retried once on a *different* decode replica, then on any surviving
replica (outcome ``degraded``). A pure pool with nothing routable
degrades the stream to plain colocated dispatch on whatever survives:
counted (``paddle_handoff_total{outcome="degraded"}``), logged, and
self-recovering. Every handoff path keeps the ok-or-retryable client
contract, and the handoff snapshot rides the same declared
kv_snapshot resource pair as stream resume.

The port reads no environment: the reference's knobs are arguments
with its defaults (``FleetRouter``: ``retry_attempts`` 3, ``retry_base``
0.05 s, ``retry_max`` 1.0 s, ``max_inflight`` 64, ``admit_timeout`` 5.0
s, ``backend_timeout`` 30.0 s, ``handoff_timeout`` 5.0 s,
``snapshot_every`` 8 tokens (0 disables); ``TenantPolicy``:
``max_queue`` 32).
"""
import hashlib
import json
import logging
import random
import socket
import struct
import threading
import time

from ..obs import goodput as obs_goodput
from ..obs import metrics as obs_metrics
from ..obs import prometheus as obs_prometheus
from ..resilience import chaos
from ..resilience.retry import backoff_delays
from .registry import ReplicaRegistry
from .server import MAX_BODY_BYTES, BodyTooLarge, _read_all
# wire constants come from the one table (wire_spec.py)
from .wire_spec import (CMD_DRAIN, CMD_HEALTH, CMD_INFER, CMD_KV_RESUME,
                        CMD_METRICS, CMD_STATS, CMD_STOP, DEADLINE_MARKER,
                        DECODE_HANDOFF_BIT, DECODE_MARKER,
                        DECODE_ONESHOT_BIT, DECODE_SNAPSHOT_EVERY_MASK,
                        DECODE_SNAPSHOT_EVERY_SHIFT, STATUS_ERROR,
                        STATUS_OK, STATUS_STREAM, TENANT_MARKER,
                        TRACE_MARKER, build_request,
                        decode_kv_snapshot_header, encode_arrays,
                        is_kv_snapshot)
from .wire_spec import STATUS_RETRYABLE as STATUS_OVERLOADED
from .wire_spec import decode_arrays_off as _decode_arrays_off

DEFAULT_TENANT = "default"

# Lock order: the fair gate's condition lock and the registry lock are
# LEAVES of the router — no router code path holds one while taking the
# other, and neither is ever held across socket I/O. The gate's shed
# accounting bumps a metric under its lock (the metric's lock is a leaf).


def tenant_id(name):
    """Stable 64-bit wire id for a tenant name (sha256 prefix): clients
    compute it once and send it as the ``0x7E`` trailing field; router
    policies declare the same names."""
    return int.from_bytes(
        hashlib.sha256(str(name).encode("utf-8")).digest()[:8], "little")


class TenantPolicy:
    """Admission policy for one tenant: scheduling ``weight`` (shares
    of the fleet under contention), ``max_queue`` (bound on requests
    WAITING in the router for this tenant; overflow sheds immediately)
    and an optional ``slo_ms`` used for deadline-hit accounting when a
    request carries no explicit wire deadline."""

    def __init__(self, name, weight=1.0, max_queue=None, slo_ms=None):
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        self.name = str(name)
        self.weight = float(weight)
        self.max_queue = int(32 if max_queue is None else max_queue)
        self.slo_ms = slo_ms
        self.tid = tenant_id(self.name)


class ShedError(RuntimeError):
    """Router-side shed (wire status 2): tenant queue full, admission
    deadline expired, no routable replica, or retries exhausted."""

    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


class _Waiter:
    __slots__ = ("finish", "seq", "granted")

    def __init__(self, finish, seq):
        self.finish = finish
        self.seq = seq
        self.granted = False


class _TenantState:
    __slots__ = ("policy", "queue", "vfinish", "granted", "shed")

    def __init__(self, policy):
        self.policy = policy
        self.queue = []  # FIFO of _Waiter
        self.vfinish = 0.0  # finish tag of the last admitted request
        self.granted = 0
        self.shed = 0


_M_SHEDS = obs_metrics.counter(
    "paddle_fleet_sheds_total",
    "Requests the router shed (wire status 2), by tenant and reason",
    labelnames=("tenant", "reason"))
_M_REQUESTS = obs_metrics.counter(
    "paddle_fleet_requests_total",
    "Requests finished by the router, by tenant and wire status",
    labelnames=("tenant", "status"))
_M_RETRIES = obs_metrics.counter(
    "paddle_fleet_retries_total",
    "Per-request replica retries, by cause (shed = status-2 rerouted "
    "with backoff, io = dead-replica failover, stream_resume = "
    "mid-stream decode failover re-driven from a kv snapshot, "
    "handoff = a disaggregated prefill or decode leg re-run on "
    "another replica)",
    labelnames=("cause",))
_M_DEADLINE = obs_metrics.counter(
    "paddle_fleet_deadline_total",
    "Deadline accounting at the router, by tenant and outcome",
    labelnames=("tenant", "outcome"))
_M_INFLIGHT = obs_metrics.gauge(
    "paddle_fleet_inflight",
    "Requests currently admitted through the router's fair gate")
_M_RESUMES = obs_metrics.counter(
    "paddle_decode_resumes_total",
    "Mid-stream decode failovers at the router, by outcome (ok = the "
    "stream was re-driven on another replica from a kv snapshot, "
    "refused = every candidate refused or failed the hand-off, "
    "no_snapshot = the replica died before any resume point existed)",
    labelnames=("outcome",))
_M_RESUME_SECONDS = obs_metrics.histogram(
    "paddle_decode_resume_seconds",
    "Replica-death-to-first-resumed-frame latency of successful "
    "mid-stream decode failovers")
_M_HANDOFF = obs_metrics.counter(
    "paddle_handoff_total",
    "Disaggregated prefill->decode handoffs at the router, by outcome "
    "(ok = first placement served the stream, retried = a prefill or "
    "decode leg was re-run before success, degraded = served "
    "colocated because a pure pool was empty or refused every "
    "attempt, failed = the client saw a retryable terminal after the "
    "handoff began)",
    labelnames=("outcome",))
_M_HANDOFF_SECONDS = obs_metrics.histogram(
    "paddle_handoff_seconds",
    "Prefill-snapshot-held to decode-replica-accepted latency of "
    "successful disaggregated handoffs")

_LOG = logging.getLogger("paddle_tpu_torch.inference.router")


class FairGate:
    """Start-time weighted fair queueing over a bounded concurrency.

    ``acquire(tenant)`` blocks until one of the ``capacity`` permits is
    granted to this request in WFQ order, sheds immediately when the
    tenant's own waiting queue is at ``max_queue``, and sheds on
    timeout. Each grant advances the tenant's virtual finish tag by
    ``1/weight``; the waiter with the smallest finish tag among queue
    heads is granted first — the classic SFQ guarantee that a tenant's
    long-run share under contention is proportional to its weight,
    regardless of how hard another tenant storms."""

    def __init__(self, capacity, policies=(), default_policy=None):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._tenants = {}  # tid -> _TenantState
        self._by_name = {}  # name -> _TenantState
        self._vtime = 0.0
        self._permits = self.capacity
        self._seq = 0
        self._default = default_policy or TenantPolicy(DEFAULT_TENANT)
        for p in policies:
            self._add(p)
        self._add(self._default)

    def _add(self, policy):
        st = _TenantState(policy)
        self._tenants.setdefault(policy.tid, st)
        self._by_name.setdefault(policy.name, st)

    def add_tenant(self, policy):
        with self._lock:
            self._add(policy)

    def _state_for(self, tid):
        # unknown tenant ids share the default tenant's queue/weight
        # (an unconfigured tenant must not mint itself a fresh share)
        if tid is None:
            return self._by_name[self._default.name]
        st = self._tenants.get(tid)
        return st if st is not None else self._by_name[self._default.name]

    def acquire(self, tid, timeout):
        """Admit one request for tenant id `tid` (None = default).
        Returns the tenant name. Raises :class:`ShedError` on a full
        tenant queue or timeout."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cond:
            st = self._state_for(tid)
            name = st.policy.name
            if len(st.queue) >= st.policy.max_queue:
                st.shed += 1
                raise ShedError("tenant_queue_full")
            start = max(self._vtime, st.vfinish)
            w = _Waiter(start + 1.0 / st.policy.weight, self._seq)
            self._seq += 1
            st.queue.append(w)
            try:
                while not w.granted:
                    self._grant_locked()
                    if w.granted:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise ShedError("admission_timeout")
                    self._cond.wait(min(remaining, 0.5))
            except ShedError:
                st.queue.remove(w)
                st.shed += 1
                raise
            st.granted += 1
        _M_INFLIGHT.inc()
        return name

    def _grant_locked(self):
        """Hand out permits to queue heads in WFQ order (caller holds
        the lock)."""
        while self._permits > 0:
            best = None
            for st in self._tenants.values():
                if not st.queue:
                    continue
                head = st.queue[0]
                if (best is None
                        or (head.finish, head.seq)
                        < (best[1].finish, best[1].seq)):
                    best = (st, head)
            if best is None:
                return
            st, head = best
            st.queue.pop(0)
            head.granted = True
            self._permits -= 1
            self._vtime = max(self._vtime, head.finish - 1.0
                              / st.policy.weight)
            st.vfinish = head.finish
            self._cond.notify_all()

    def release(self):
        with self._cond:
            self._permits += 1
            self._grant_locked()
        _M_INFLIGHT.dec()

    def stats(self):
        with self._lock:
            return {st.policy.name: {
                "weight": st.policy.weight,
                "waiting": len(st.queue),
                "granted": st.granted,
                "shed": st.shed,
            } for st in self._by_name.values()}


def _split_meta(body):
    """Split a cmd-1 body into (arrays_bytes, fields) where
    arrays_bytes is the cmd byte + array payload (trailing fields
    EXCLUDED), fields is a list of (marker, raw8) in wire order, and
    tail is any unparsed remainder (an unknown marker stops the scan,
    mirroring the server; the bytes are preserved for forwarding);
    also extract (tenant_id, budget_s, trace_id)."""
    payload = body[1:]
    _, arrays_end = _decode_arrays_off(payload)
    off = arrays_end
    fields = []
    tid = budget = trace = None
    while len(payload) - off >= 9:
        marker = payload[off]
        raw = payload[off + 1:off + 9]
        if marker == DEADLINE_MARKER and budget is None:
            (ms,) = struct.unpack("<d", raw)
            budget = max(0.0, float(ms)) / 1000.0
        elif marker == TRACE_MARKER and trace is None:
            (t,) = struct.unpack("<Q", raw)
            trace = t or None
        elif marker == TENANT_MARKER and tid is None:
            (tid,) = struct.unpack("<Q", raw)
        elif marker == DECODE_MARKER:
            # a streaming decode request: kept in ``fields`` so it
            # forwards to the replica; its presence switches dispatch
            # into chunk-relay mode. Parsed here (not treated unknown)
            # so fields BEHIND it still split correctly.
            pass
        else:
            break
        fields.append((marker, raw))
        off += 9
    return (body[:1 + arrays_end], fields, payload[off:],
            tid, budget, trace)


class _Streamed:
    """Sentinel result of a relayed chunk stream: the reply frames
    already went to the client; only accounting remains."""

    __slots__ = ("status", "tokens", "max_gap_s", "replica_ok")

    def __init__(self, status, tokens, max_gap_s, replica_ok=True):
        self.status = status
        self.tokens = tokens
        self.max_gap_s = max_gap_s
        self.replica_ok = replica_ok


class _ClientGone(ConnectionError):
    """The CLIENT vanished mid-relay (its socket write failed): there
    is nobody to answer — the handler just closes."""


class FleetRouter:
    """TCP front tier over a :class:`ReplicaRegistry` (see module
    docstring). Construct with an existing registry (``own_registry=
    False``) or let it build one; ``tenants`` is an iterable of
    :class:`TenantPolicy`."""

    def __init__(self, registry=None, port=0, host="127.0.0.1",
                 tenants=(), max_inflight=None, retry_attempts=None,
                 retry_base=None, retry_max=None, admit_timeout=None,
                 backend_timeout=None, own_registry=None,
                 max_body=MAX_BODY_BYTES, rng=random.random,
                 snapshot_every=None, handoff_timeout=None):
        own = registry is None if own_registry is None else own_registry
        self.registry = registry if registry is not None \
            else ReplicaRegistry()
        self._own_registry = own
        self.retry_attempts = max(1, int(3 if retry_attempts is None
                                         else retry_attempts))
        self.retry_base = float(0.05 if retry_base is None else retry_base)
        self.retry_max = float(1.0 if retry_max is None else retry_max)
        self.admit_timeout = float(5.0 if admit_timeout is None
                                   else admit_timeout)
        self.backend_timeout = float(30.0 if backend_timeout is None
                                     else backend_timeout)
        # per-attempt cap on one disaggregated handoff leg (prefill
        # run or decode placement): a stuck pool member must cost at
        # most this before the leg moves to another replica
        self.handoff_timeout = float(5.0 if handoff_timeout is None
                                     else handoff_timeout)
        self.max_body = max_body
        # snapshot cadence stamped onto forwarded decode requests so
        # replicas interleave resume points into their streams; the
        # router holds the newest one and fails a broken stream over
        # to another replica. 0 disables router-managed resume.
        self.snapshot_every = min(DECODE_SNAPSHOT_EVERY_MASK, max(0, int(
            8 if snapshot_every is None else snapshot_every)))
        self._rng = rng
        self.gate = FairGate(64 if max_inflight is None else max_inflight,
                             policies=tenants)
        # held kv snapshots (_snap_hold/_snap_release), the census
        self._snaps = 0
        self._snaps_lock = threading.Lock()
        self._pools = {}  # rid -> [idle sockets]
        self._pools_lock = threading.Lock()
        self._stop = threading.Event()
        self._conns = {}  # handler thread -> socket
        self._conns_lock = threading.Lock()
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve,
                                        name="fleet-router-accept",
                                        daemon=True)
        self._thread.start()

    # --------------------------------------------------------- membership
    def add_tenant(self, policy):
        self.gate.add_tenant(policy)

    # ----------------------------------------------------------- backend
    # Replica-connection lifecycle: every checkout comes from
    # _pool_get/_conn_open and every checked-out socket ends in exactly
    # one of _pool_put (clean reuse) or _conn_close (poison).
    def _pool_get(self, rid):
        with self._pools_lock:
            pool = self._pools.get(rid)
            if pool:
                return pool.pop()
        return None

    def _conn_open(self, view):
        """Dial one replica connection. TCP_NODELAY is set before the
        socket escapes — a raise after the dial must close it, or the
        half-configured socket leaks."""
        sock = socket.create_connection((view.host, view.port),
                                        timeout=self.registry.dial_timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            sock.close()
            raise
        return sock

    def _conn_close(self, sock):
        """Poison one checked-out replica connection (best-effort,
        never raises): timed-out, desynced, or client-gone sockets
        must die here, never return to the pool."""
        try:
            sock.close()
        except OSError:
            pass

    def _pool_put(self, rid, sock):
        with self._pools_lock:
            if not self._stop.is_set():
                self._pools.setdefault(rid, []).append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def _pool_drop(self, rid):
        with self._pools_lock:
            socks = self._pools.pop(rid, [])
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    # Kv-snapshot lifecycle: a relayed stream RETAINS at most one
    # resume point (a full KV copy — holding it past the stream's end
    # pins a model's KV rows per request). Every hold comes from
    # _snap_hold and ends in exactly one _snap_release, and the pair
    # counts: live_snapshots() is 0 once every path dropped its own.
    def _snap_hold(self, blob):
        """Retain one kv-snapshot block as the stream's resume point."""
        with self._snaps_lock:
            self._snaps += 1
        return bytes(blob)

    def _snap_release(self, snap):
        """Drop a held resume point."""
        with self._snaps_lock:
            self._snaps -= 1
        return None

    def live_snapshots(self):
        """Kv snapshots the router holds now (relays in flight that
        keep a resume point): the census every relay path returns to 0."""
        with self._snaps_lock:
            return self._snaps

    def _forward(self, view, frame, timeout, client_conn=None,
                 stream_ctx=None):
        """Send one framed request to replica `view` over a pooled
        connection; return the raw response body (status byte +
        payload). Raises OSError/ConnectionError/TimeoutError on a
        dead/stalled replica (the connection is NOT returned to the
        pool in that case — a desynced stream must never be reused).

        ``client_conn`` (streaming decode requests): if the first
        reply frame is a status-3 chunk, frames are RELAYED to the
        client until the terminal frame and a :class:`_Streamed`
        summary is returned instead of a body; from the first relayed
        byte on there is no retry (the client already consumed part of
        the stream) — a replica that dies mid-relay ends the stream
        with a status-2 terminal frame, so the client sees retryable,
        never truncated-but-ok. A normal single first frame (shed,
        error, one-shot reply) returns exactly like the plain path, so
        the caller's retry logic still applies to it."""
        sock = self._pool_get(view.rid)
        fresh = sock is None
        if fresh:
            sock = self._conn_open(view)
        hdr = b""
        t_send = time.monotonic()
        try:
            sock.settimeout(timeout)
            sock.sendall(frame)
            hdr = _read_all(sock, 4)
            (blen,) = struct.unpack("<I", hdr)
            body = _read_all(sock, blen)
        except socket.timeout:
            # a SLOW replica, not a dead stream: resending would
            # double-execute the request and double the latency —
            # surface the timeout (caller ejects + fails over)
            self._conn_close(sock)
            raise
        except (OSError, ConnectionError):
            self._conn_close(sock)
            if not fresh and not hdr:
                # the pooled connection was stale (closed by a replica
                # restart between requests — reset/EOF before any
                # reply byte): one transparent retry on a fresh dial.
                # Inference is read-only, so even the worst case (the
                # replica executed but died pre-reply) cannot corrupt
                # state, and a genuinely dead replica fails the fresh
                # dial immediately. Nothing was relayed yet, so this
                # is equally safe for the streaming path.
                return self._forward_fresh(view, frame, timeout,
                                           client_conn, stream_ctx)
            raise
        if body and body[0] == STATUS_STREAM:
            if client_conn is not None:
                return self._relay(view, sock, body, client_conn, timeout,
                                   t_send, stream_ctx)
            # a replica streaming at a NON-streaming dispatch (version
            # skew): the socket is mid-stream and desynced — poison it;
            # pooling it would corrupt the next request on this replica
            self._conn_close(sock)
            return body
        self._pool_put(view.rid, sock)
        return body

    @staticmethod
    def _chunk_tokens(body):
        """Token count of one chunk frame body (status + arrays)."""
        if len(body) <= 1:
            return 0
        try:
            arrays, _ = _decode_arrays_off(body[1:])
        except Exception:  # noqa: BLE001 - counting is best-effort
            return 0
        return sum(int(a.size) for a in arrays)

    @staticmethod
    def _trim_chunk(body, skip):
        """Drop up to ``skip`` leading tokens from one chunk frame
        (the dedup step of a resumed stream: the new leg replays from
        its snapshot position, which may trail what the client already
        received). Returns ``(new_body_or_None, dropped)``; None means
        the whole frame was already-delivered tokens on a non-terminal
        chunk — nothing to forward. A frame whose payload is not a
        token array passes through untouched."""
        status = body[0]
        try:
            arrays, _ = _decode_arrays_off(body[1:])
            arr = arrays[0]
        except Exception:  # noqa: BLE001 - not a token chunk
            return body, 0
        dropped = min(int(skip), int(arr.size))
        if dropped == 0:
            return body, 0
        arr = arr[dropped:]
        if arr.size == 0 and status == STATUS_STREAM:
            return None, dropped
        return struct.pack("<B", status) + encode_arrays([arr]), dropped

    def _resume_leg(self, snap, fields, timeout, dead, phase=None,
                    max_attempts=None, tried=None):
        """Re-drive a broken decode stream from the held snapshot
        ``snap`` on each live replica not in ``dead``. On success
        returns ``(view, sock, first_body)`` with the registry
        in-flight slot for ``view.rid`` HELD by the caller; returns
        None when no candidate accepted. The forwarded marker
        ``fields`` ride along so the new leg keeps the original
        per-token budget, trace id, snapshot cadence — and, for the
        disaggregated decode leg, the REAL max-new-tokens that
        overrides the prefill snapshot's 1. A status-2 first frame is
        a refusal (identity skew or shed) and a status-1 frame a hard
        reject — both leave the socket at a frame boundary, so it is
        pooled and the next candidate tried.

        ``phase`` restricts candidates to one pool (the handoff's
        decode placement — free-slot-richest first), ``max_attempts``
        bounds distinct replicas tried this call, and ``tried`` (a
        set) records and excludes candidates ACROSS calls so the
        handoff's one retry provably lands on a different replica."""
        payload = snap + b"".join(
            struct.pack("<B", m) + raw for m, raw in fields)
        frame = build_request(CMD_KV_RESUME, payload)
        attempts = 0
        for v in self.registry.routable(phase):
            if v.rid in dead or (tried is not None and v.rid in tried):
                continue
            if max_attempts is not None and attempts >= max_attempts:
                break
            attempts += 1
            if tried is not None:
                tried.add(v.rid)
            self.registry.acquire(v.rid)
            sock = None
            try:
                sock = self._pool_get(v.rid)
                if sock is None:
                    sock = self._conn_open(v)
                sock.settimeout(timeout)
                sock.sendall(frame)
                (blen,) = struct.unpack("<I", _read_all(sock, 4))
                body = _read_all(sock, blen)
            except (OSError, ConnectionError):
                if sock is not None:
                    self._conn_close(sock)
                self.registry.report_io_error(v.rid)
                self._pool_drop(v.rid)
                self.registry.release(v.rid)
                continue
            if body and body[0] in (STATUS_STREAM, STATUS_OK):
                return v, sock, body
            self._pool_put(v.rid, sock)
            self.registry.release(v.rid)
        return None

    def _relay(self, view, sock, first_body, client_conn, timeout,
               t_send, stream_ctx=None, init_snap=None, init_tokens=0,
               init_max_gap=0.0, owns_slot=False):
        """Pump chunk frames replica -> client until the terminal
        frame, surviving mid-stream replica death when a resume point
        is held. Owns ``sock`` (and every failover socket it dials)
        from here on: pools it on a clean terminal (the stream ends
        exactly at a frame boundary), poisons it on every other exit.
        ``t_send`` is when the request hit the replica's socket, so the
        FIRST gap really is time-to-first-token — the per-token SLO
        treats the first chunk as a token, and anchoring at relay
        start would hide exactly the slow-admission case the SLO
        exists to catch.

        With ``stream_ctx`` the replica leg was asked for kv-snapshot
        frames: the newest one is RETAINED (``_snap_hold`` /
        ``_snap_release``), and on a mid-stream replica death the
        stream is re-driven on another replica via the kv_resume
        command. Already-delivered tokens are trimmed by sequence
        position (never duplicated, never lost — a snapshot frame only
        arrives after every token it covers is on the wire, so the
        delivered count can never trail the held position), the
        inter-token gap clock keeps running across the outage (a
        failover does NOT refresh the last-frame timestamp or reset
        TTFT accounting — the client really did wait), and a client
        that never asked for snapshots sees byte-identical framing
        throughout because injected snapshot frames are stripped here.
        Without a held snapshot a death stays today's status-2
        terminal.

        The disaggregated decode leg enters here mid-stream:
        ``init_snap`` is the prefill handoff snapshot, held by the
        caller, whose ownership passes to this function,
        ``init_tokens`` tokens were already delivered by the prefill
        leg (the dedup arithmetic counts them), ``init_max_gap``
        carries the client's observed TTFT gap, and ``owns_slot=True``
        says ``view.rid``'s registry in-flight slot was acquired by
        ``_resume_leg`` and is ours to drop."""
        strip = bool(stream_ctx and stream_ctx.get("strip"))
        fields = [] if stream_ctx is None else stream_ctx["fields"]
        can_resume = stream_ctx is not None
        tokens = init_tokens
        max_gap = init_max_gap
        t_last = t_send
        rid = view.rid  # replica serving the CURRENT leg
        owned = owns_slot  # True while rid's in-flight slot is OURS
        skip = 0        # duplicate tokens still to trim on this leg
        dead = set()
        # the handoff's snapshot arrives held (the caller's _snap_hold):
        # its ownership moves here, and every exit below releases it
        snap = init_snap

        def send(body):
            try:
                client_conn.sendall(struct.pack("<I", len(body)) + body)
            except (OSError, ConnectionError) as e:
                # the client vanished: close the REPLICA socket too
                # (never pooled — mid-stream), which makes the
                # replica's own send fail and purge the KV slot
                self._conn_close(sock)
                raise _ClientGone(str(e)) from e

        try:
            body = first_body
            while True:
                if (can_resume and body[0] == STATUS_STREAM
                        and is_kv_snapshot(body[1:])):
                    # a resume point, not tokens: retain the newest
                    if snap is not None:
                        self._snap_release(snap)
                    snap = self._snap_hold(body[1:])
                    if not strip:
                        # the client set its own cadence: it gets the
                        # frame verbatim AND the router still uses it
                        send(body)
                else:
                    if skip:
                        body, dropped = self._trim_chunk(body, skip)
                        skip -= dropped
                    if body is not None:
                        # duplicate-only frames are dropped above and
                        # deliberately do NOT touch the gap clock: the
                        # client is still waiting for its next NEW
                        # token, so the outage counts against the
                        # per-token budget
                        now = time.monotonic()
                        max_gap = max(max_gap, now - t_last)
                        t_last = now
                        tokens += self._chunk_tokens(body)
                        send(body)
                        if body[0] != STATUS_STREAM:
                            self._pool_put(rid, sock)
                            if rid != view.rid:
                                # the stream finished on a failover
                                # replica: report THAT one healthy (the
                                # original was already reported dead;
                                # replica_ok=False keeps the caller
                                # from overwriting that report)
                                self.registry.report_ok(rid)
                            return _Streamed(body[0], tokens, max_gap,
                                             replica_ok=rid == view.rid)
                try:
                    (blen,) = struct.unpack("<I", _read_all(sock, 4))
                    body = _read_all(sock, blen)
                except (OSError, ConnectionError):
                    # replica died mid-stream: the client already
                    # consumed a prefix, so no transparent re-send of
                    # the request — fail over from the held resume
                    # point, or terminate the stream retryably
                    self._conn_close(sock)
                    self.registry.report_io_error(rid)
                    self._pool_drop(rid)
                    dead.add(rid)
                    if owned:
                        self.registry.release(rid)
                        owned = False
                    t_died = time.monotonic()
                    nxt = None
                    if snap is not None:
                        nxt = self._resume_leg(snap, fields, timeout,
                                               dead)
                    if nxt is None:
                        _M_RESUMES.inc(
                            outcome="no_snapshot" if snap is None
                            else "refused")
                        send(struct.pack("<B", STATUS_OVERLOADED))
                        return _Streamed(STATUS_OVERLOADED, tokens,
                                         max_gap, replica_ok=False)
                    nview, sock, body = nxt
                    rid = nview.rid
                    owned = True
                    _M_RETRIES.inc(cause="stream_resume")
                    _M_RESUMES.inc(outcome="ok")
                    _M_RESUME_SECONDS.observe(
                        time.monotonic() - t_died)
                    hdr = decode_kv_snapshot_header(snap)
                    skip = max(0, tokens - int(hdr["n_generated"]))
        finally:
            if owned:
                self.registry.release(rid)
            if snap is not None:
                self._snap_release(snap)

    # ------------------------------------------------- disaggregation
    def _disagg_plan(self):
        """Placement decision for one genuine decode stream: ``None``
        = colocated (poolless fleet — every routable replica serves
        both phases), ``"handoff"`` = disaggregated prefill->decode
        handoff (both pure pools have a routable member), and
        ``"degraded"`` = the fleet IS pooled but a pure pool has
        nothing routable — serve colocated on whatever survives
        (counted + logged; recovers by itself once the missing pool
        scales back up or its replicas probe back in)."""
        views = self.registry.routable()
        if not any(v.phase != "both" for v in views):
            return None
        has_pre = any(v.phase == "prefill" for v in views)
        has_dec = any(v.phase == "decode" for v in views)
        return "handoff" if (has_pre and has_dec) else "degraded"

    @staticmethod
    def _handoff_frame(arrays_bytes, fwd_fields, tail):
        """The prefill leg's wire frame: the forwarded request with
        the handoff bit set on its decode field — the replica runs
        ONLY the prefill step and replies with one kv-snapshot frame
        then the terminal first-token frame."""
        out = []
        for m, raw in fwd_fields:
            if m == DECODE_MARKER:
                (val,) = struct.unpack("<Q", raw)
                raw = struct.pack("<Q", val | DECODE_HANDOFF_BIT)
            out.append((m, raw))
        body = arrays_bytes + b"".join(
            struct.pack("<B", m) + raw for m, raw in out) + tail
        return struct.pack("<I", len(body)) + body

    def _prefill_leg(self, frame, timeout, deadline):
        """Run the prefill step of a disaggregated stream on the
        prefill pool (warm-bucket-first placement) and retry another
        prefill replica on death or refusal — the client has seen
        NOTHING yet, so a prefill replica SIGKILLed mid-handoff is
        invisible: the prefill re-runs elsewhere. Returns
        ``(view, raw_snap, term_body, t_send, retried)`` where
        ``raw_snap`` is the raw handoff-snapshot blob — NOT yet held;
        the caller takes ownership via ``_snap_hold`` — ``("error",
        body)`` for a genuine status-1 request error (forwarded to
        the client verbatim, never retried), or None when every
        prefill replica refused or failed."""
        attempts = 0
        retried = False
        for v in self.registry.routable("prefill"):
            if attempts >= self.retry_attempts:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            attempts += 1
            self.registry.acquire(v.rid)
            sock = None
            t_send = time.monotonic()
            try:
                sock = self._pool_get(v.rid)
                if sock is None:
                    sock = self._conn_open(v)
                sock.settimeout(timeout)
                sock.sendall(frame)
                (blen,) = struct.unpack("<I", _read_all(sock, 4))
                body = _read_all(sock, blen)
                term = None
                if body and body[0] == STATUS_STREAM \
                        and is_kv_snapshot(body[1:]):
                    (blen,) = struct.unpack("<I", _read_all(sock, 4))
                    term = _read_all(sock, blen)
            except (OSError, ConnectionError):
                if sock is not None:
                    self._conn_close(sock)
                self.registry.report_io_error(v.rid)
                self._pool_drop(v.rid)
                _M_RETRIES.inc(cause="handoff")
                retried = True
                continue
            finally:
                self.registry.release(v.rid)
            if term is not None and term[0] == STATUS_OK:
                self._pool_put(v.rid, sock)
                self.registry.report_ok(v.rid)
                return v, body[1:], term, t_send, retried
            if term is None and body and body[0] == STATUS_OVERLOADED:
                # refusal at a frame boundary: pool it, try the next
                self._pool_put(v.rid, sock)
                _M_RETRIES.inc(cause="handoff")
                retried = True
                continue
            if term is None and body and body[0] == STATUS_ERROR:
                # the REQUEST is bad, not the replica: no retry
                self._pool_put(v.rid, sock)
                return ("error", body)
            # surprise framing (version skew): poison, try another
            self._conn_close(sock)
            _M_RETRIES.inc(cause="handoff")
            retried = True
        return None

    def _dispatch_handoff(self, arrays_bytes, fwd_fields, tail,
                          deadline, client_conn, stream_ctx, max_new):
        """Disaggregated dispatch of one decode stream (README
        "Disaggregated serving"): prefill leg on the prefill pool
        (handoff-bit cmd 1 -> kv snapshot + first token), the first
        token straight to the client (TTFT never waits for decode
        placement), then the decode leg seeds a decode replica via
        kv_resume — retried once on a DIFFERENT decode replica, then
        on any surviving replica (outcome ``degraded``) — and relays
        the rest with the full mid-stream resume machinery behind it.
        Returns a :class:`_Streamed` (the stream finished or ended
        with a retryable terminal — the client always sees
        ok-or-retryable, never a torn stream), a raw status-1 body
        (genuine request error from prefill, nothing relayed), or
        None (nothing reached the client and no prefill replica
        cooperated: the caller degrades to colocated dispatch)."""
        chaos.hit("fleet.handoff")
        timeout = min(self.handoff_timeout, self.backend_timeout)
        if deadline is not None:
            timeout = min(timeout,
                          max(0.05, deadline - time.monotonic()) + 1.0)
        pre = self._prefill_leg(
            self._handoff_frame(arrays_bytes, fwd_fields, tail),
            timeout, deadline)
        if pre is None:
            return None
        if pre[0] == "error":
            return pre[1]
        view, raw_snap, term, t_send, retried = pre
        snap = self._snap_hold(raw_snap)
        t_snap = time.monotonic()
        try:
            n_tok = self._chunk_tokens(term)
            if max_new <= n_tok:
                # the prefill token IS the whole stream (max_new 1):
                # forward the terminal verbatim, no decode leg at all
                try:
                    client_conn.sendall(
                        struct.pack("<I", len(term)) + term)
                except (OSError, ConnectionError) as e:
                    raise _ClientGone(str(e)) from e
                _M_HANDOFF.inc(
                    outcome="retried" if retried else "ok")
                return _Streamed(STATUS_OK, n_tok,
                                 time.monotonic() - t_send)
            # first token to the client NOW, as a stream chunk
            chunk = struct.pack("<B", STATUS_STREAM) + term[1:]
            try:
                client_conn.sendall(
                    struct.pack("<I", len(chunk)) + chunk)
            except (OSError, ConnectionError) as e:
                raise _ClientGone(str(e)) from e
            t_tok = time.monotonic()
            # decode placement: best decode replica, one retry on a
            # provably different one, then anywhere (degraded)
            tried = set()
            nxt = self._resume_leg(snap, fwd_fields, timeout, set(),
                                   phase="decode", max_attempts=1,
                                   tried=tried)
            outcome = "retried" if retried else "ok"
            if nxt is None and any(
                    v.rid not in tried
                    for v in self.registry.routable("decode")):
                _M_RETRIES.inc(cause="handoff")
                outcome = "retried"
                nxt = self._resume_leg(snap, fwd_fields, timeout,
                                       set(), phase="decode",
                                       max_attempts=1, tried=tried)
            if nxt is None:
                nxt = self._resume_leg(snap, fwd_fields, timeout,
                                       set(), tried=tried)
                if nxt is not None:
                    outcome = "degraded"
                    _LOG.warning(
                        "decode pool refused handoff: stream resumed "
                        "on %s (degraded to colocated)", nxt[0].rid)
            if nxt is None:
                # a token was already delivered, so this stream can
                # only END retryably — never silently torn
                _M_HANDOFF.inc(outcome="failed")
                try:
                    client_conn.sendall(struct.pack(
                        "<IB", 1, STATUS_OVERLOADED))
                except (OSError, ConnectionError) as e:
                    raise _ClientGone(str(e)) from e
                return _Streamed(STATUS_OVERLOADED, n_tok,
                                 t_tok - t_send, replica_ok=True)
            dview, dsock, dbody = nxt
            _M_HANDOFF.inc(outcome=outcome)
            _M_HANDOFF_SECONDS.observe(time.monotonic() - t_snap)
            # placement done: the relay reads at the normal per-reply
            # cap, not the short per-attempt handoff cap
            dsock.settimeout(self.backend_timeout)
            # ownership of the held snapshot transfers to _relay (it
            # releases it on every exit path) — our finally must not
            # release it again
            relay_snap, snap = snap, None
            streamed = self._relay(dview, dsock, dbody, client_conn,
                                   self.backend_timeout, t_tok,
                                   stream_ctx=stream_ctx,
                                   init_snap=relay_snap,
                                   init_tokens=n_tok,
                                   init_max_gap=t_tok - t_send,
                                   owns_slot=True)
            if streamed.replica_ok:
                self.registry.report_ok(dview.rid)
            return streamed
        finally:
            if snap is not None:
                self._snap_release(snap)

    def _forward_fresh(self, view, frame, timeout, client_conn=None,
                       stream_ctx=None):
        sock = self._conn_open(view)
        t_send = time.monotonic()
        try:
            sock.settimeout(timeout)
            sock.sendall(frame)
            (blen,) = struct.unpack("<I", _read_all(sock, 4))
            body = _read_all(sock, blen)
        except (OSError, ConnectionError):
            self._conn_close(sock)
            raise
        if body and body[0] == STATUS_STREAM:
            if client_conn is not None:
                return self._relay(view, sock, body, client_conn, timeout,
                                   t_send, stream_ctx)
            # same version-skew poison as _forward: mid-stream sockets
            # never reach the pool
            self._conn_close(sock)
            return body
        self._pool_put(view.rid, sock)
        return body

    # ------------------------------------------------------------ routing
    def _route_once(self, tried):
        """Pick the next replica: least-loaded routable one not yet
        tried this request; falls back to an already-tried one (it may
        have shed transiently) rather than giving up while anything is
        routable. Returns a ReplicaView or None."""
        chaos.hit("fleet.route")
        routable = self.registry.routable()
        for view in routable:
            if view.rid not in tried:
                return view
        return routable[0] if routable else None

    def _dispatch(self, arrays_bytes, fields, tail, deadline,
                  stream=False, client_conn=None):
        """Route one admitted cmd-1 request with shed-aware retry.
        Returns the raw response body to send to the client — or a
        :class:`_Streamed` summary when the reply was a chunk stream
        already relayed to ``client_conn`` (streaming retries happen
        only BEFORE the first relayed frame: an immediate status-2
        shed re-routes exactly like a one-shot request, but once the
        client consumed a chunk the stream ends retryably instead).
        Never raises for fleet-topology failures — those become
        status 2 (except :class:`_ClientGone`: nobody left to tell)."""
        # forward everything except the tenant field (admission
        # happened here; replicas predating the field would stop
        # parsing at it and miss a deadline/trace field behind it).
        # For a relayed stream with router-managed resume enabled, the
        # forwarded decode field additionally gets the router's
        # snapshot cadence stamped into its spare bits when the client
        # set none — the replica then interleaves resume points that
        # the relay strips before the client (byte-identical framing
        # for clients that never opted in) and uses for failover. A
        # client that set its OWN cadence keeps it; its snapshot
        # frames are forwarded verbatim AND double as the router's
        # resume points.
        fwd_fields = []
        strip_snaps = False
        client_cadence = 0
        decode_val = 0
        for m, raw in fields:
            if m == TENANT_MARKER:
                continue
            if m == DECODE_MARKER and stream:
                (val,) = struct.unpack("<Q", raw)
                decode_val = val
                client_cadence = ((val >> DECODE_SNAPSHOT_EVERY_SHIFT)
                                  & DECODE_SNAPSHOT_EVERY_MASK)
                if not client_cadence and self.snapshot_every:
                    val |= (self.snapshot_every
                            << DECODE_SNAPSHOT_EVERY_SHIFT)
                    raw = struct.pack("<Q", val)
                    strip_snaps = True
            fwd_fields.append((m, raw))
        fwd_body = arrays_bytes + b"".join(
            struct.pack("<B", m) + raw for m, raw in fwd_fields) + tail
        frame = struct.pack("<I", len(fwd_body)) + fwd_body
        stream_ctx = None
        if stream and (strip_snaps or client_cadence):
            stream_ctx = {"fields": fwd_fields, "strip": strip_snaps}
        if stream_ctx is not None and client_conn is not None:
            # phase-pooled fleet: serve genuine streams as a
            # prefill->decode handoff; degrade to plain colocated
            # dispatch (below) when a pure pool has nothing routable
            # or no prefill replica cooperated
            plan = self._disagg_plan()
            if plan is not None:
                reason = "pool_empty"
                if plan == "handoff":
                    max_new = int(decode_val & 0xFFFFFFFF) or 64
                    resp = self._dispatch_handoff(
                        arrays_bytes, fwd_fields, tail, deadline,
                        client_conn, stream_ctx, max_new)
                    if resp is not None:
                        return resp
                    reason = "no_prefill_placement"
                _M_HANDOFF.inc(outcome="degraded")
                _LOG.warning(
                    "disaggregated serving degraded to colocated "
                    "(%s)", reason)
        delays = backoff_delays(self.retry_attempts, self.retry_base,
                                self.retry_max, 0.5, self._rng)
        tried = set()
        last_shed = None
        for attempt in range(1, self.retry_attempts + 1):
            if deadline is not None and time.monotonic() >= deadline:
                raise ShedError("deadline")
            view = self._route_once(tried)
            if view is None:
                raise ShedError("no_replica")
            tried.add(view.rid)
            timeout = self.backend_timeout
            if deadline is not None:
                timeout = min(timeout,
                              max(0.05, deadline - time.monotonic()) + 1.0)
            self.registry.acquire(view.rid)
            try:
                resp = self._forward(
                    view, frame, timeout,
                    client_conn=client_conn if stream else None,
                    stream_ctx=stream_ctx)
            except _ClientGone:
                raise
            except (OSError, ConnectionError):
                # dead / stalled replica: poison it and fail over to a
                # different one immediately — detection, not load
                self.registry.report_io_error(view.rid)
                self._pool_drop(view.rid)
                _M_RETRIES.inc(cause="io")
                continue
            finally:
                self.registry.release(view.rid)
            if isinstance(resp, _Streamed):
                # frames already went to the client; a mid-relay
                # replica death was reported inside the relay and must
                # not be overwritten by an ok report here
                if resp.replica_ok:
                    self.registry.report_ok(view.rid)
                return resp
            self.registry.report_ok(view.rid)
            if resp and resp[0] == STATUS_OVERLOADED:
                last_shed = resp
                if attempt == self.retry_attempts:
                    break
                delay = next(delays)
                if deadline is not None and \
                        time.monotonic() + delay >= deadline:
                    raise ShedError("deadline")
                _M_RETRIES.inc(cause="shed")
                time.sleep(delay)
                continue
            return resp
        if last_shed is not None:
            return last_shed  # retries exhausted: the shed stands
        raise ShedError("retries_exhausted")

    def _infer(self, body, client_conn=None):
        """Admission + dispatch + accounting for one cmd-1 request.
        Returns the response body bytes — or None when the reply was a
        chunk stream already relayed to ``client_conn``."""
        t0 = time.perf_counter()
        arrays_bytes, fields, tail, tid, budget, _trace = \
            _split_meta(body)
        decode_val = next((struct.unpack("<Q", raw)[0]
                           for m, raw in fields if m == DECODE_MARKER),
                          None)
        oneshot = (decode_val is not None
                   and bool(decode_val & DECODE_ONESHOT_BIT))
        # only a chunk-relay dispatch for genuine streams: a one-shot
        # decode is a normal single reply with normal retry semantics
        stream = decode_val is not None and not oneshot
        budget_total = budget
        if budget is not None and decode_val is not None:
            # for decode requests the 0xDD field is a PER-TOKEN budget
            # (TTFT + every inter-token gap), not an end-to-end
            # deadline: the router's whole-request bound scales by the
            # token count (+1 for the first token), or a legitimate
            # 64-token one-shot reply would blow a 500ms per-token
            # budget, time out the read, and eject the healthy replica
            # that was busy completing it
            max_new = int(decode_val & 0xFFFFFFFF) or 64
            budget_total = budget * (max_new + 1)
        deadline = (None if budget_total is None
                    else time.monotonic() + budget_total)
        # the SLO used for deadline-hit accounting: per-token for a
        # stream (checked against the max inter-chunk gap), whole-reply
        # for everything else; fall back to the tenant policy's slo_ms
        slo_s = budget if stream else budget_total
        if slo_s is None:
            slo_ms = self.gate._state_for(tid).policy.slo_ms
            slo_s = None if slo_ms is None else slo_ms / 1000.0
        tenant_name = None
        outcome = "error"
        status = STATUS_ERROR
        tokens = 0
        try:
            admit_timeout = (budget_total if budget_total is not None
                             else self.admit_timeout)
            try:
                tenant_name = self.gate.acquire(tid, admit_timeout)
            except ShedError as e:
                tenant_name = tenant_name or self._tenant_name(tid)
                _M_SHEDS.inc(tenant=tenant_name, reason=e.reason)
                outcome = "shed"
                status = STATUS_OVERLOADED
                return struct.pack("<B", STATUS_OVERLOADED)
            try:
                resp = self._dispatch(arrays_bytes, fields, tail,
                                      deadline, stream=stream,
                                      client_conn=client_conn)
            except ShedError as e:
                _M_SHEDS.inc(tenant=tenant_name, reason=e.reason)
                outcome = "shed"
                status = STATUS_OVERLOADED
                return struct.pack("<B", STATUS_OVERLOADED)
            except _ClientGone:
                # the client vanished mid-relay: nobody to answer,
                # accounted as a shed (the fleet did not fail)
                outcome = "shed"
                status = STATUS_OVERLOADED
                raise
            except Exception:  # noqa: BLE001 — router fault, not the
                # request's fault: the contract is ok-or-retryable, so
                # an internal routing failure (including an armed
                # chaos fault on fleet.route) sheds instead of erroring
                _M_SHEDS.inc(tenant=tenant_name, reason="router_fault")
                outcome = "shed"
                status = STATUS_OVERLOADED
                return struct.pack("<B", STATUS_OVERLOADED)
            finally:
                self.gate.release()
            if isinstance(resp, _Streamed):
                # chunk stream, already relayed: per-token SLO — the
                # request is "late" when any inter-chunk gap (incl.
                # time to the first chunk) blew the budget
                status = resp.status
                tokens = resp.tokens
                if status == STATUS_OK:
                    met = slo_s is None or resp.max_gap_s <= slo_s
                    outcome = "ok" if met else "late"
                elif status == STATUS_OVERLOADED:
                    outcome = "shed"
                else:
                    outcome = "error"
                return None
            status = resp[0] if resp else STATUS_ERROR
            if status == STATUS_OK:
                met = (slo_s is None
                       or time.perf_counter() - t0 <= slo_s)
                outcome = "ok" if met else "late"
            elif status == STATUS_OVERLOADED:
                outcome = "shed"
            else:
                outcome = "error"
            return resp
        finally:
            name = tenant_name or self._tenant_name(tid)
            dt = time.perf_counter() - t0
            _M_REQUESTS.inc(tenant=name, status=str(status))
            if slo_s is not None:
                # every request of an SLO-carrying tenant is a hit or
                # a miss — a shed/error against a deadline is a miss
                _M_DEADLINE.inc(tenant=name,
                                outcome="hit" if outcome == "ok"
                                else "miss")
            obs_goodput.SERVING_LEDGER.record(name, outcome, dt,
                                              tokens=tokens)

    def _tenant_name(self, tid):
        return self.gate._state_for(tid).policy.name

    # ------------------------------------------------------------- drains
    def drain(self, rid, deadline_s=10.0, notify_replica=True):
        """Zero-drop drain of one replica: stop routing new work to it,
        tell the replica itself (wire cmd 8) so its own health
        announces the drain, then wait until the router's in-flight
        count on it reaches zero. Returns True when drained, False on
        timeout (in-flight work still running — the caller decides
        whether to stop anyway)."""
        self.registry.set_draining(rid, True)
        if notify_replica:
            ep = self.registry.endpoints().get(rid)
            if ep is not None:
                try:
                    with socket.create_connection(
                            ep, timeout=self.registry.dial_timeout) as s:
                        s.settimeout(self.registry.dial_timeout)
                        payload = struct.pack("<Bd", CMD_DRAIN, float(deadline_s))
                        s.sendall(struct.pack("<I", len(payload)) + payload)
                        (blen,) = struct.unpack("<I", _read_all(s, 4))
                        _read_all(s, blen)
                except (OSError, ConnectionError):
                    pass  # dead replica drains trivially
        t_end = time.monotonic() + max(0.0, deadline_s)
        while time.monotonic() < t_end:
            if self.registry.inflight(rid) == 0:
                return True
            time.sleep(0.01)
        return self.registry.inflight(rid) == 0

    def undrain(self, rid, notify_replica=True):
        """Re-admit a drained replica for routing (after a reload
        finished, say)."""
        if notify_replica:
            ep = self.registry.endpoints().get(rid)
            if ep is not None:
                try:
                    with socket.create_connection(
                            ep, timeout=self.registry.dial_timeout) as s:
                        s.settimeout(self.registry.dial_timeout)
                        payload = struct.pack("<Bd", CMD_DRAIN, -1.0)
                        s.sendall(struct.pack("<I", len(payload)) + payload)
                        (blen,) = struct.unpack("<I", _read_all(s, 4))
                        _read_all(s, blen)
                except (OSError, ConnectionError):
                    pass
        self.registry.set_draining(rid, False)

    # ------------------------------------------------------------- server
    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            with self._conns_lock:
                self._conns[t] = conn
            t.start()

    def _handle(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                conn.settimeout(None)
                first = conn.recv(1)
                if not first:
                    raise ConnectionError("peer closed")
                conn.settimeout(self.backend_timeout)
                (blen,) = struct.unpack("<I", first + _read_all(conn, 3))
                if blen == 0:
                    conn.sendall(struct.pack("<IB", 1, STATUS_ERROR))
                    continue
                try:
                    body = _read_all(conn, blen, limit=self.max_body)
                except BodyTooLarge:
                    # same hardening as the replica server: a bogus
                    # length prefix must not buffer gigabytes on the
                    # front tier; the stream can't be resynced — error
                    # status, then close
                    conn.sendall(struct.pack("<IB", 1, STATUS_ERROR))
                    return
                cmd = body[0]
                if cmd == CMD_STOP:
                    conn.sendall(struct.pack("<IB", 1, STATUS_OK))
                    threading.Thread(target=self.stop,
                                     daemon=True).start()
                    return
                if cmd == CMD_HEALTH:
                    enc = json.dumps(self.health()).encode("utf-8")
                    conn.sendall(struct.pack("<IB", 1 + len(enc),
                                             STATUS_OK) + enc)
                    continue
                if cmd == CMD_STATS:
                    enc = json.dumps(self.stats()).encode("utf-8")
                    conn.sendall(struct.pack("<IB", 1 + len(enc),
                                             STATUS_OK) + enc)
                    continue
                if cmd == CMD_METRICS:
                    enc = obs_prometheus.render().encode("utf-8")
                    conn.sendall(struct.pack("<IB", 1 + len(enc),
                                             STATUS_OK) + enc)
                    continue
                if cmd != CMD_INFER:
                    # reload/stop of individual replicas goes through
                    # Fleet.rolling_reload — a router-wide cmd 4 would
                    # be ambiguous about which replica it names
                    conn.sendall(struct.pack("<IB", 1, STATUS_ERROR))
                    continue
                try:
                    resp = self._infer(body, client_conn=conn)
                    if resp is not None:
                        conn.sendall(struct.pack("<I", len(resp)) + resp)
                    # resp None: chunk stream already relayed
                except _ClientGone:
                    raise ConnectionError("client gone mid-stream")
                except Exception:  # noqa: BLE001 - wire error status
                    conn.sendall(struct.pack("<IB", 1, STATUS_ERROR))
        except socket.timeout:
            pass
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conns_lock:
                self._conns.pop(threading.current_thread(), None)

    # -------------------------------------------------------------- views
    def health(self):
        """Fleet-level health JSON (wire cmd 3 on the router): replica
        table with states, plus the gate view. ``ok`` is true while at
        least one replica is routable."""
        replicas = [v.as_dict() for v in self.registry.snapshot()]
        routable = sum(1 for r in replicas if r["state"] == "ok")
        pools = {}
        for r in replicas:
            ph = r.get("phase") or "both"
            pools[ph] = pools.get(ph, 0) + 1
        return {
            "ok": routable > 0 and not self._stop.is_set(),
            "router": True,
            "draining": self._stop.is_set(),
            "accepting": not self._stop.is_set(),
            "routable_replicas": routable,
            "replicas": replicas,
            "pools": pools,
            "tenants": self.gate.stats(),
        }

    def stats(self):
        replicas = [v.as_dict() for v in self.registry.snapshot()]
        pools = {}
        for r in replicas:
            ph = r.get("phase") or "both"
            pools[ph] = pools.get(ph, 0) + 1
        return {
            "router": True,
            "port": self.port,
            "retry_attempts": self.retry_attempts,
            "max_inflight": self.gate.capacity,
            "tenants": self.gate.stats(),
            "replicas": replicas,
            "pools": pools,
            "serving_goodput": obs_goodput.SERVING_LEDGER.report(),
        }

    # -------------------------------------------------------------- close
    def stop(self):
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns.values())
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        # quiesce in-flight handler threads: their finally blocks
        # release every held kv_snapshot and backend socket, so
        # stop() returning means live_snapshots() has drained.
        # Bounded — a handler wedged in a backend read must not hang
        # shutdown (its daemon thread dies with the process).
        with self._conns_lock:
            handlers = list(self._conns.keys())
        deadline = time.monotonic() + 5.0
        me = threading.current_thread()
        for t in handlers:
            if t is me:
                continue
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._pools_lock:
            pools = list(self._pools.values())
            self._pools = {}
        for pool in pools:
            for s in pool:
                try:
                    s.close()
                except OSError:
                    pass
        if self._own_registry:
            self.registry.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
