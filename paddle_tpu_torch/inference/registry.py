"""Replica registry for the fleet tier (counterpart of
paddle_tpu/inference/registry.py, ported whole).

One registry per router process. ``serve_model`` replicas are
*registered* (by the Fleet supervisor that spawned them, or manually
for replicas managed elsewhere) and then *heartbeated*: a single
background thread polls each replica's ``health`` wire command (cmd 3)
— the JSON the server already exposes, read over a fresh short-lived
connection so the replica's serving hot path never grows a new lock —
and folds the reply into a per-replica view the router's routing
decision reads:

- ``queue_depth`` / ``declared_buckets``: load and bucket warmth for
  least-loaded, warmth-preferring replica selection;
- ``accepting`` / ``draining_deadline_s`` (absent on old replicas =
  accepting): a draining replica stops receiving NEW work but is not
  poisoned — its in-flight requests finish (zero-drop reload /
  scale-down);
- liveness: a replica whose heartbeat fails ``eject_misses`` times in
  a row — or that the router reports a connection error / timeout on —
  is POISONED (ejected): no routing, no traffic. After
  ``probe_cooldown`` seconds the next heartbeat acts as the single
  half-open probe (the engines' circuit-breaker shape): success readmits,
  failure re-ejects and restarts the cooldown.

Chaos sites: ``fleet.heartbeat`` fires once per replica probe, and
``fleet.heartbeat.<rid>`` once per probe of that replica, so tests can
deterministically fail/delay heartbeats.

The port reads no environment: the reference's knobs are the
constructor's arguments with its defaults (``heartbeat_interval`` 0.25
s, ``eject_misses`` 2, ``probe_cooldown`` 1.0 s, ``dial_timeout`` 2.0 s).
"""
import json
import socket
import struct
import threading
import time

from ..obs import metrics as obs_metrics
from ..resilience import chaos
from .wire_spec import CMD_HEALTH, REPLICA_PHASES, STATUS_OK

# replica lifecycle (the eject/readmit state machine)
OK = "ok"            # routable
DRAINING = "draining"  # alive, accepting=false: no NEW work
EJECTED = "ejected"  # poisoned: no routing until a probe succeeds
PROBING = "probing"  # cooldown over; next heartbeat is the probe

_STATES = (OK, DRAINING, EJECTED, PROBING)


_M_HEARTBEATS = obs_metrics.counter(
    "paddle_fleet_heartbeats_total",
    "Replica heartbeat probes, by result",
    labelnames=("result",))
_M_EJECTS = obs_metrics.counter(
    "paddle_fleet_ejects_total",
    "Replica ejections (poisoned by heartbeat misses or router I/O "
    "errors)")
_M_READMITS = obs_metrics.counter(
    "paddle_fleet_readmits_total",
    "Replicas readmitted by a successful half-open probe")
_M_REPLICAS = obs_metrics.gauge(
    "paddle_fleet_replicas",
    "Registered replicas by state",
    labelnames=("state",))


class ReplicaView:
    """Immutable-ish routing snapshot of one replica (what
    ``ReplicaRegistry.snapshot()`` hands the router)."""

    __slots__ = ("rid", "host", "port", "state", "queue_depth",
                 "warm_buckets", "inflight", "draining_deadline_s",
                 "heartbeat_age_s", "pid", "metrics_port", "phase",
                 "free_slots")

    def __init__(self, rid, host, port, state, queue_depth, warm_buckets,
                 inflight, draining_deadline_s, heartbeat_age_s, pid,
                 metrics_port=None, phase="both", free_slots=None):
        self.rid = rid
        self.host = host
        self.port = port
        self.state = state
        self.queue_depth = queue_depth
        self.warm_buckets = warm_buckets
        self.inflight = inflight
        self.draining_deadline_s = draining_deadline_s
        self.heartbeat_age_s = heartbeat_age_s
        self.pid = pid
        self.metrics_port = metrics_port
        # pool membership (wire_spec.REPLICA_PHASES): registered intent,
        # refreshed from the replica's own health body once it reports
        self.phase = phase
        # decode free KV slots from the last health probe (None until a
        # decode engine reports) — the router's decode-placement signal
        self.free_slots = free_slots

    def as_dict(self):
        return {s: getattr(self, s) for s in self.__slots__}


class _Replica:
    """Mutable registry record. Every field is guarded by the
    registry's single lock — probes and routing I/O happen OUTSIDE it
    on local snapshots."""

    def __init__(self, rid, host, port, pid=None, metrics_port=None,
                 phase="both"):
        self.rid = rid
        self.host = host
        self.port = port
        self.pid = pid  # for supervisors that respawn subprocesses
        self.phase = phase  # pool membership (prefill | decode | both)
        self.free_slots = None  # decode KV slots free at last probe
        # the replica's /metrics HTTP endpoint (obs.httpd.MetricsServer
        # reports the ephemeral port it bound as `.port`) so scrapers
        # can discover the whole fleet from the registry
        self.metrics_port = metrics_port
        self.state = OK
        self.misses = 0
        # True only for ROUTER-initiated drains (set_draining): sticky
        # until the router lifts it. A drain the replica itself
        # announced (cmd 8 / stop()) clears as soon as its health says
        # accepting again — without this bit the two cases are
        # indistinguishable and an undrained replica could stay
        # unroutable forever.
        self.drain_hold = False
        self.queue_depth = 0
        self.warm_buckets = 0
        self.inflight = 0  # router-held in-flight requests
        self.draining_deadline_s = None
        self.ejected_at = None  # monotonic of the last ejection
        self.last_heartbeat = None  # monotonic of the last OK probe


def _probe_health(host, port, timeout):
    """One health probe: fresh connection, cmd 3, parse the JSON.
    Raises OSError/ConnectionError/TimeoutError on a dead replica."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(struct.pack("<IB", 1, CMD_HEALTH))
        hdr = b""
        while len(hdr) < 4:
            chunk = s.recv(4 - len(hdr))
            if not chunk:
                raise ConnectionError("peer closed during health probe")
            hdr += chunk
        (blen,) = struct.unpack("<I", hdr)
        body = b""
        while len(body) < blen:
            chunk = s.recv(blen - len(body))
            if not chunk:
                raise ConnectionError("peer closed during health probe")
            body += chunk
    if not body or body[0] != STATUS_OK:
        raise ConnectionError(f"health probe returned status "
                              f"{body[0] if body else 'empty'}")
    return json.loads(body[1:].decode("utf-8"))


class ReplicaRegistry:
    """Thread-safe replica table + one heartbeat thread (started on
    construction, stopped by :meth:`close`)."""

    def __init__(self, heartbeat_interval=None, eject_misses=None,
                 probe_cooldown=None, dial_timeout=None,
                 probe_fn=_probe_health):
        self.heartbeat_interval = float(
            0.25 if heartbeat_interval is None else heartbeat_interval)
        self.eject_misses = int(2 if eject_misses is None else eject_misses)
        self.probe_cooldown = float(1.0 if probe_cooldown is None else probe_cooldown)
        self.dial_timeout = float(2.0 if dial_timeout is None else dial_timeout)
        self._probe_fn = probe_fn
        self._lock = threading.Lock()
        self._replicas = {}
        self._closed = threading.Event()
        self._thread = None
        if self.heartbeat_interval > 0:
            self._thread = threading.Thread(
                target=self._heartbeat_loop, name="fleet-heartbeat",
                daemon=True)
            self._thread.start()
        obs_metrics.REGISTRY.register_collector(self._collect)

    # --------------------------------------------------------- membership
    def register(self, rid, host, port, pid=None, metrics_port=None,
                 phase="both"):
        """Add (or re-add after a respawn) a replica. A re-registered
        rid starts fresh: OK state, zero misses. ``metrics_port`` is
        the replica's /metrics HTTP endpoint (advertise the ephemeral
        port ``obs.httpd.MetricsServer`` bound). ``phase`` is the pool
        the replica was spawned into (wire_spec.REPLICA_PHASES); the
        replica's own health body overrides it once probes land."""
        if phase not in REPLICA_PHASES:
            raise ValueError(f"unknown replica phase {phase!r} "
                             f"(expected one of {REPLICA_PHASES})")
        with self._lock:
            self._replicas[rid] = _Replica(rid, str(host), int(port),
                                           pid=pid,
                                           metrics_port=metrics_port,
                                           phase=phase)

    def deregister(self, rid):
        with self._lock:
            self._replicas.pop(rid, None)

    def endpoints(self):
        with self._lock:
            return {r.rid: (r.host, r.port)
                    for r in self._replicas.values()}

    # ------------------------------------------------------------ routing
    def snapshot(self):
        """All replicas as :class:`ReplicaView` rows (every state —
        the router filters; the autoscaler and supervisor want the
        ejected ones too)."""
        now = time.monotonic()
        with self._lock:
            return [ReplicaView(
                r.rid, r.host, r.port, r.state, r.queue_depth,
                r.warm_buckets, r.inflight, r.draining_deadline_s,
                (None if r.last_heartbeat is None
                 else round(now - r.last_heartbeat, 3)), r.pid,
                r.metrics_port, r.phase, r.free_slots)
                for r in self._replicas.values()]

    def routable(self, phase=None):
        """Replicas the router may send NEW work to, least-loaded
        first: OK state, ordered by (router in-flight + last reported
        queue depth, colder-first warmth tie-break inverted — warmer
        replicas win a tie because their bucket ladder is compiled).

        ``phase`` narrows to ONE pool of a disaggregated fleet
        (replicas whose phase matches exactly — "both" replicas serve
        the phase-blind default but belong to neither pure pool).
        Decode placement sorts most-free-KV-slots first instead:
        prefill cares about warm prompt buckets, decode about where a
        resumed sequence can actually get a slot."""
        with self._lock:
            rows = [ReplicaView(
                r.rid, r.host, r.port, r.state, r.queue_depth,
                r.warm_buckets, r.inflight, r.draining_deadline_s,
                None, r.pid, r.metrics_port, r.phase, r.free_slots)
                for r in self._replicas.values()
                if r.state == OK and (phase is None or r.phase == phase)]
        if phase == "decode":
            rows.sort(key=lambda v: (
                -(v.free_slots if v.free_slots is not None else 0),
                v.inflight + v.queue_depth, v.rid))
        else:
            rows.sort(key=lambda v: (v.inflight + v.queue_depth,
                                     -v.warm_buckets, v.rid))
        return rows

    def acquire(self, rid):
        """Router bookkeeping: one more in-flight request on `rid`."""
        with self._lock:
            r = self._replicas.get(rid)
            if r is not None:
                r.inflight += 1

    def release(self, rid):
        with self._lock:
            r = self._replicas.get(rid)
            if r is not None and r.inflight > 0:
                r.inflight -= 1

    def inflight(self, rid):
        with self._lock:
            r = self._replicas.get(rid)
            return 0 if r is None else r.inflight

    # ------------------------------------------------------ state changes
    def report_io_error(self, rid):
        """Router saw a connection error / timeout talking to `rid`:
        poison it immediately (don't wait for heartbeat misses)."""
        with self._lock:
            r = self._replicas.get(rid)
            if r is None or r.state == EJECTED:
                return
            r.state = EJECTED
            r.ejected_at = time.monotonic()
            r.misses = 0
        _M_EJECTS.inc()

    def report_ok(self, rid):
        """Router completed a request on `rid` (any wire status): the
        replica is alive even if its heartbeat is lagging."""
        with self._lock:
            r = self._replicas.get(rid)
            if r is not None and r.state == OK:
                r.misses = 0

    def set_draining(self, rid, draining=True):
        """Router-side drain mark (no wire round-trip needed): stop
        routing new work to `rid`. STICKY — the heartbeat keeps
        probing it but only ``set_draining(rid, False)`` (or death ->
        EJECTED) moves it out of DRAINING. Replica-announced drains
        (health accepting=false with no router hold) clear themselves
        on the next accepting heartbeat."""
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                return
            r.drain_hold = bool(draining)
            if draining and r.state in (OK, PROBING):
                r.state = DRAINING
            elif not draining and r.state == DRAINING:
                r.state = OK
                r.misses = 0

    # ---------------------------------------------------------- heartbeat
    def heartbeat_once(self):
        """One full probe round (the loop body; tests call it
        directly). Probes run OUTSIDE the lock and CONCURRENTLY (one
        short-lived thread per target) — a dead replica burning its
        full dial timeout must not delay detecting the next one;
        results fold back in under the lock."""
        with self._lock:
            now = time.monotonic()
            targets = []
            for r in self._replicas.values():
                if r.state == EJECTED:
                    if (r.ejected_at is None
                            or now - r.ejected_at >= self.probe_cooldown):
                        r.state = PROBING  # one half-open probe
                    else:
                        continue  # still cooling down: no traffic at all
                targets.append((r.rid, r.host, r.port, r.state))
        if not targets:
            return
        if len(targets) == 1:
            self._probe_one(*targets[0])
            return
        threads = [threading.Thread(target=self._probe_one, args=t,
                                    name=f"fleet-probe-{t[0]}",
                                    daemon=True) for t in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.dial_timeout + 2.0)

    def _probe_one(self, rid, host, port, state):
        try:
            chaos.hit(f"fleet.heartbeat.{rid}")
            chaos.hit("fleet.heartbeat")
            health = self._probe_fn(host, port, self.dial_timeout)
        except (OSError, ConnectionError, TimeoutError, ValueError):
            self._heartbeat_miss(rid, state)
            _M_HEARTBEATS.inc(result="miss")
        except Exception:  # noqa: BLE001 — an exotic probe failure
            # (chaos-armed RuntimeError, JSON of the wrong shape) is
            # still just a miss, never a dead heartbeat thread
            self._heartbeat_miss(rid, state)
            _M_HEARTBEATS.inc(result="miss")
        else:
            self._heartbeat_ok(rid, state, health)
            _M_HEARTBEATS.inc(result="ok")

    def _heartbeat_ok(self, rid, probed_state, health):
        accepting = bool(health.get("accepting",
                                    not health.get("draining", False)))
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                return
            r.misses = 0
            r.last_heartbeat = time.monotonic()
            r.queue_depth = int((health.get("engine") or {})
                                .get("queue_depth", 0))
            r.warm_buckets = len((health.get("engine") or {})
                                 .get("declared_buckets") or [])
            r.draining_deadline_s = health.get("draining_deadline_s")
            # the replica's own phase declaration wins over what the
            # supervisor registered (a reconfigured replica re-pools
            # itself on its next heartbeat); unknown values are ignored
            # so a newer replica can't poison routing
            phase = health.get("phase")
            if phase in REPLICA_PHASES:
                r.phase = phase
            free = (health.get("decode") or {}).get("free_slots")
            r.free_slots = int(free) if free is not None else None
            readmitted = False
            if r.state == PROBING:
                # the half-open probe succeeded: readmit (into
                # DRAINING while a drain is announced or held)
                r.state = (OK if accepting and not r.drain_hold
                           else DRAINING)
                readmitted = True
            elif r.state in (OK, DRAINING):
                # replica-announced drains (cmd 8 / stop()) flip here
                # in BOTH directions without router action; a
                # router-initiated drain (set_draining) holds DRAINING
                # until the router lifts it — drain_hold keeps a stale
                # not-accepting probe that raced an undrain from
                # parking the replica out of routing forever
                if not accepting:
                    r.state = DRAINING
                    r.ejected_at = None
                elif r.state == DRAINING and not r.drain_hold:
                    r.state = OK
                    r.misses = 0
        if readmitted:
            _M_READMITS.inc()

    def _heartbeat_miss(self, rid, probed_state):
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                return
            if r.state == PROBING:
                # failed half-open probe: back to a full cooldown
                r.state = EJECTED
                r.ejected_at = time.monotonic()
                return
            r.misses += 1
            if r.misses >= self.eject_misses and r.state in (OK, DRAINING):
                r.state = EJECTED
                r.ejected_at = time.monotonic()
                ejected = True
            else:
                ejected = False
        if ejected:
            _M_EJECTS.inc()

    def _heartbeat_loop(self):
        while not self._closed.wait(self.heartbeat_interval):
            try:
                self.heartbeat_once()
            except Exception:  # noqa: BLE001 — heartbeat must survive
                # a single bad round (e.g. chaos-injected) must not
                # kill the thread: the next tick retries
                pass

    def _collect(self):
        # refresh the (already-registered) state gauge at scrape time;
        # return [] so the family is not rendered twice
        with self._lock:
            counts = {s: 0 for s in _STATES}
            for r in self._replicas.values():
                counts[r.state] += 1
        for s, n in counts.items():
            _M_REPLICAS.set(n, state=s)
        return []

    # -------------------------------------------------------------- close
    def close(self):
        self._closed.set()
        obs_metrics.REGISTRY.unregister_collector(self._collect)
        if self._thread is not None:
            self._thread.join(5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
