"""Fleet tier: self-healing multi-replica serving (counterpart of
paddle_tpu/inference/fleet.py, ported whole).

Ties the pieces together into one operable unit::

    clients ──> FleetRouter ──┬──> serve_model replica 0
      (wire protocol,         ├──> serve_model replica 1
       any existing client)   └──> serve_model replica 2

    Fleet = ReplicaRegistry (heartbeats, eject/probe)
          + FleetRouter     (WFQ admission, shed-aware retry, drains)
          + supervisor      (respawn dead replicas, autoscale)

A :class:`Fleet` owns N replicas produced by a ``spawn_fn`` — either
:func:`subprocess_spawner` (a fresh ``serve_model`` process per
replica, ``python -m paddle_tpu_torch.inference.fleet --replica``; the
replicas of one card share it, each with its own CUDA context) or
anything else returning a :class:`ReplicaHandle`-shaped object (tests
use in-process servers; ``chip_smoke.py --decode-replica`` is a decode
replica process). The reference's warm respawn through the artifact
store of compiled programs has no counterpart: a loaded model is one
``torch.export`` program, and the decode engine's CUDA graphs have no
serialized form (ROADMAP Queue 3 (b)); a decode replica's persistent
prefix tier is its ``prefix_dir`` argument.

The supervisor thread:

- **respawns** replicas whose process died (SIGKILL, OOM, crash): the
  dead rid is deregistered and a replacement spawned and registered —
  the router routes around the corpse from the first failed heartbeat
  or I/O error, so the only client-visible effect is a few retryable
  status-2 replies, never a hang or a wrong tensor;
- **autoscales**: sustained admission-queue pressure (requests waiting
  in the router's fair gate, or deep per-replica engine queues) spawns
  a replica up to ``max_replicas``; a sustained idle fleet drains one
  replica (zero-drop: new work routes elsewhere, in-flight finishes)
  and stops it, down to ``min_replicas``.

``rolling_reload`` hot-swaps weights across the fleet one replica at a
time: drain -> wire cmd 4 reload -> undrain, so the fleet never has
fewer than N-1 replicas taking traffic and no request ever drops.

``pools`` disaggregates the fleet into phase pools: ``Fleet(spawn_fn,
pools={"prefill": 1,
"decode": 2})`` spawns phase-tagged replicas
(``registry.register(..., phase=...)``), buries and respawns each
pool's dead independently, and runs one :class:`Autoscaler` per pool
over pool-local signals only (:meth:`Fleet.pool_signals`): the
prefill controller sees admission-gate waiting (TTFT pressure), the
decode controller sees its own replicas' backlog plus KV-slot
saturation (inter-token pressure). A prefill burst therefore never
scales the decode pool, and vice versa. Without ``pools`` nothing
changes — one ``both`` pool, fleet-global signals, the 1-arg
``spawn_fn`` contract.

The port reads no environment, and neither do its replicas: the
reference's knobs are arguments with its defaults (``Autoscaler``:
``min_replicas`` 1, ``max_replicas`` 4, ``scale_up_pressure`` 4.0,
``scale_down_ticks`` 20; ``Fleet``: ``supervise_interval`` 0.5 s;
``subprocess_spawner``: ``spawn_timeout`` 120 s), and what the
reference hands a child in its environment the spawner passes as
arguments.
"""
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

from ..obs import metrics as obs_metrics
from .registry import EJECTED, ReplicaRegistry
from .router import FleetRouter, TenantPolicy, tenant_id  # noqa: F401
from .server import _read_all
from .wire_spec import CMD_RELOAD, CMD_STOP, REPLICA_PHASES

_M_RESPAWNS = obs_metrics.counter(
    "paddle_fleet_respawns_total",
    "Dead replicas replaced by the fleet supervisor")
_M_SCALE = obs_metrics.counter(
    "paddle_fleet_scale_events_total",
    "Autoscaler actions", labelnames=("direction",))
_M_POOL_REPLICAS = obs_metrics.gauge(
    "paddle_fleet_pool_replicas",
    "Live replicas per phase pool (refreshed each supervisor tick)",
    labelnames=("phase",))


class ReplicaHandle:
    """One spawned replica: its endpoint plus enough process handle to
    supervise it. ``proc`` is a subprocess.Popen or None (in-process
    replicas override :meth:`alive`/:meth:`stop`)."""

    def __init__(self, rid, host, port, proc=None):
        self.rid = rid
        self.host = host
        self.port = int(port)
        self.proc = proc

    @property
    def pid(self):
        return None if self.proc is None else self.proc.pid

    def alive(self):
        # a proc-less (in-process) handle counts as alive unless a
        # subclass says otherwise
        return self.proc is None or self.proc.poll() is None

    def stop(self, timeout=10.0):
        """Graceful stop: wire cmd 7, then wait, then SIGKILL."""
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=2.0) as s:
                s.settimeout(2.0)
                s.sendall(struct.pack("<IB", 1, CMD_STOP))
                (blen,) = struct.unpack("<I", _read_all(s, 4))
                _read_all(s, blen)
        except (OSError, ConnectionError):
            pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                try:
                    self.proc.wait(5.0)
                except subprocess.TimeoutExpired:
                    pass  # un-reapable zombie; the OS owns it now


# Portfile-dir lifecycle: a spawn's rendezvous dir lives exactly as
# long as the spawn attempt — _portdir_done on every path (the replica
# wrote its port into it; nothing reads it again).
def _portdir_create():
    """One private dir for a replica's port rendezvous file."""
    return tempfile.mkdtemp(prefix="fleet-")


def _portdir_done(path):
    """Retire a port-rendezvous dir (bound, crashed, or timed out)."""
    shutil.rmtree(path, ignore_errors=True)


def wait_portfile(portfile, proc, rid, timeout):
    """The port a replica process wrote to ``portfile`` (atomically, once
    it serves), waiting up to ``timeout`` seconds; a replica that exits
    first raises RuntimeError, one that does not bind in time is killed
    and raises TimeoutError."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if os.path.exists(portfile):
            with open(portfile) as f:
                return int(f.read())
        if proc.poll() is not None:
            raise RuntimeError(f"replica {rid} exited rc={proc.returncode} before binding")
        time.sleep(0.02)
    proc.kill()
    proc.wait()
    raise TimeoutError(f"replica {rid} did not bind within {timeout:.0f}s")


def subprocess_spawner(prefix, host="127.0.0.1", spawn_timeout=None, max_batch_size=8,
                       max_wait_ms=2.0, max_queue=256, device=None, slab_rows=None):
    """Build a ``spawn_fn`` that starts each replica as a fresh
    ``serve_model`` process (``python -m paddle_tpu_torch.inference.fleet
    --replica ...``) of the save at ``prefix``, on ``device`` (the
    card by default; "cpu" asks for the CPU) at ``slab_rows`` rows a
    program call (serve_model's). The child is given every setting as an
    argument and reads no environment; it gets this process's
    environment with the checkout on ``PYTHONPATH``, so that it imports
    the same package."""
    timeout = float(120.0 if spawn_timeout is None else spawn_timeout)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    def spawn(rid, phase=None):
        portdir = _portdir_create()
        try:
            portfile = os.path.join(portdir, f"{rid}.port")
            env = dict(os.environ)
            env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
            argv = [sys.executable, "-m", "paddle_tpu_torch.inference.fleet", "--replica",
                    prefix, portfile, str(max_batch_size), str(max_wait_ms), str(max_queue)]
            if phase:  # pooled fleets spawn phase-tagged replicas
                argv.append(phase)
            if device is not None:
                argv += ["--device", str(device)]
            if slab_rows is not None:
                argv += ["--slab-rows", str(int(slab_rows))]
            proc = subprocess.Popen(argv, env=env)
            return ReplicaHandle(rid, host, wait_portfile(portfile, proc, rid, timeout),
                                 proc=proc)
        finally:
            _portdir_done(portdir)

    return spawn


class Autoscaler:
    """Pure scale decision over one supervisor tick's observations
    (kept side-effect free so tests drive it directly):
    ``decide(n_replicas, waiting, backlog)`` -> +1 / 0 / -1 where
    ``waiting`` is requests queued in the router's fair gate and
    ``backlog`` is the summed per-replica (router in-flight + engine
    queue depth)."""

    def __init__(self, min_replicas=None, max_replicas=None,
                 scale_up_pressure=None, scale_down_ticks=None):
        self.min_replicas = max(1, int(1 if min_replicas is None else min_replicas))
        self.max_replicas = int(4 if max_replicas is None else max_replicas)
        self.scale_up_pressure = float(4.0 if scale_up_pressure is None
                                       else scale_up_pressure)
        self.scale_down_ticks = int(20 if scale_down_ticks is None
                                    else scale_down_ticks)
        self._idle_ticks = 0

    def decide(self, n_replicas, waiting, backlog):
        if n_replicas < self.min_replicas:
            return 1
        pressure = waiting + backlog
        per_replica = pressure / max(1, n_replicas)
        if per_replica >= self.scale_up_pressure \
                and n_replicas < self.max_replicas:
            self._idle_ticks = 0
            return 1
        if pressure == 0:
            self._idle_ticks += 1
            if self._idle_ticks >= self.scale_down_ticks \
                    and n_replicas > self.min_replicas:
                self._idle_ticks = 0
                return -1
        else:
            self._idle_ticks = 0
        return 0


class _Pool:
    """One phase pool's supervision state: a spawn callable already
    bound to the phase, an independent :class:`Autoscaler`, and the
    pool's rid counter. The poolless (legacy) fleet is one ``both``
    pool with ``replica-{n}`` rids; pooled fleets name replicas
    ``{phase}-{n}`` so pool membership survives in logs and stats."""

    def __init__(self, phase, spawn, autoscaler, n0, legacy=False):
        self.phase = phase
        self.spawn = spawn
        self.autoscaler = autoscaler
        self.n0 = n0
        self.legacy = legacy
        self.next_rid = 0

    def new_rid(self):
        n = self.next_rid
        self.next_rid += 1
        return f"replica-{n}" if self.legacy else f"{self.phase}-{n}"


class Fleet:
    """Spawn, register, route, supervise (see module docstring).

    ``spawn_fn(rid) -> ReplicaHandle`` produces replicas;
    :func:`subprocess_spawner` builds the production one. With
    ``supervise=False`` nothing respawns or autoscales (tests drive
    :meth:`supervise_once` manually).

    ``pools`` disaggregates the fleet into phase pools::

        Fleet(spawn_fn, pools={"prefill": 1, "decode": 2})
        Fleet(None, pools={
            "prefill": {"replicas": 1, "spawn": spawn_p,
                        "autoscaler": Autoscaler(max_replicas=2)},
            "decode":  {"replicas": 2, "spawn": spawn_d},
        })

    With ``pools``, the shared ``spawn_fn`` (or a pool's own ``spawn``)
    is called ``fn(rid, phase)`` so spawners can start phase-shaped
    replicas (:func:`subprocess_spawner`'s spawn takes the second
    argument); each pool gets its own :class:`Autoscaler` — pass one
    via the dict form, int-form pools build a default — fed only
    pool-local signals (:meth:`pool_signals`); a dead replica respawns
    into its own pool. Without ``pools`` nothing changes: one ``both``
    pool, the 1-arg ``spawn_fn`` contract, fleet-global autoscaling."""

    def __init__(self, spawn_fn, replicas=None, tenants=(),
                 registry=None, router_kwargs=None, autoscaler=None,
                 supervise=True, supervise_interval=None, pools=None):
        self._spawn_fn = spawn_fn
        self.autoscaler = autoscaler or Autoscaler()
        self._pools = self._build_pools(spawn_fn, replicas, pools)
        self.registry = registry or ReplicaRegistry()
        self.router = FleetRouter(self.registry, tenants=tenants,
                                  own_registry=False,
                                  **(router_kwargs or {}))
        self._lock = threading.Lock()
        self._handles = {}  # rid -> ReplicaHandle
        self._phases = {}   # rid -> phase (pool membership)
        self._closed = threading.Event()
        self.respawns = 0
        for pool in self._pools.values():
            for _ in range(pool.n0):
                self._spawn_one(pool.phase)
        self._thread = None
        if supervise:
            self._interval = float(0.5 if supervise_interval is None
                                   else supervise_interval)
            self._thread = threading.Thread(target=self._supervise_loop,
                                            name="fleet-supervisor",
                                            daemon=True)
            self._thread.start()

    def _build_pools(self, spawn_fn, replicas, pools):
        if pools is None:
            if spawn_fn is None:
                raise ValueError("Fleet needs a spawn_fn")
            n0 = (replicas if replicas is not None
                  else self.autoscaler.min_replicas)
            return {"both": _Pool("both", spawn_fn, self.autoscaler,
                                  n0, legacy=True)}
        out = {}
        for phase, cfg in pools.items():
            if phase not in REPLICA_PHASES:
                raise ValueError(
                    f"unknown pool phase {phase!r}; "
                    f"expected one of {REPLICA_PHASES}")
            if isinstance(cfg, dict):
                fn = cfg.get("spawn") or spawn_fn
                scaler = cfg.get("autoscaler") or Autoscaler()
                n0 = cfg.get("replicas")
            else:
                fn, scaler, n0 = spawn_fn, Autoscaler(), int(cfg)
            if fn is None:
                raise ValueError(
                    f"pool {phase!r} has no spawn callable (pass a "
                    "shared spawn_fn or a per-pool 'spawn')")
            if n0 is None:
                n0 = scaler.min_replicas
            # pooled contract: the spawn callable sees the phase so it
            # can start a phase-shaped replica (warmup ladder, health)
            bound = (lambda rid, _fn=fn, _ph=phase: _fn(rid, _ph))
            out[phase] = _Pool(phase, bound, scaler, n0)
        if not out:
            raise ValueError("pools must name at least one phase")
        return out

    @property
    def port(self):
        """The router's client-facing port."""
        return self.router.port

    def handles(self):
        with self._lock:
            return dict(self._handles)

    def pools(self):
        """Live pool membership: ``{phase: [rid, ...]}`` (sorted)."""
        with self._lock:
            out = {phase: [] for phase in self._pools}
            for rid in sorted(self._phases):
                out[self._phases[rid]].append(rid)
        return out

    # ------------------------------------------------------------ scaling
    def _only_pool(self):
        if len(self._pools) == 1:
            return next(iter(self._pools))
        raise ValueError("phase required for a multi-pool fleet "
                         f"(pools: {sorted(self._pools)})")

    def _spawn_one(self, phase=None):
        pool = self._pools[phase if phase is not None
                           else self._only_pool()]
        with self._lock:
            rid = pool.new_rid()
        handle = pool.spawn(rid)
        with self._lock:
            # a close() that raced this spawn (it can take the whole
            # subprocess startup) must not leak an orphan replica: the
            # handle table is already cleared, so stop the newborn
            # instead of inserting it
            aborted = self._closed.is_set()
            if not aborted:
                self._handles[rid] = handle
                self._phases[rid] = pool.phase
        if aborted:
            handle.stop()
            return None
        self.registry.register(rid, handle.host, handle.port,
                               pid=handle.pid, phase=pool.phase)
        return rid

    def _remove_one(self, rid, drain_deadline=10.0):
        """Zero-drop scale-down: drain (router stops routing, replica
        announces it, in-flight finishes), then stop."""
        self.router.drain(rid, deadline_s=drain_deadline)
        with self._lock:
            handle = self._handles.pop(rid, None)
            self._phases.pop(rid, None)
        self.registry.deregister(rid)
        if handle is not None:
            handle.stop()

    def _members(self, phase):
        """Locked read of one pool's live rids, sorted."""
        with self._lock:
            return sorted(r for r, p in self._phases.items()
                          if p == phase)

    def scale_to(self, n, phase=None):
        """Imperative scale of one pool (the autoscalers do this on
        pressure). ``phase`` may be omitted for a single-pool fleet.
        Scaling a pure pool to zero is legal: the router degrades the
        affected handoffs to colocated serving on the surviving pool."""
        phase = phase if phase is not None else self._only_pool()
        if phase not in self._pools:
            raise ValueError(f"no such pool: {phase!r}")
        while True:
            members = self._members(phase)
            current = len(members)
            if current < n:
                if self._spawn_one(phase) is None:  # closing: stop
                    return
            elif current > n:
                self._remove_one(members[-1])
            else:
                return

    # --------------------------------------------------------- supervisor
    def pool_signals(self, phase, views=None):
        """One pool's autoscaling signals: ``(waiting, backlog)``.

        Admission-gate waiting is attributed to the pool that runs a
        request's FIRST leg — the prefill pool when one exists (gate
        pressure is TTFT pressure), else the colocated ``both`` pool,
        else the decode pool — so a prefill burst never scales the
        decode pool. Backlog sums router in-flight + engine queue
        depth over this pool's replicas only; the decode pool
        additionally counts KV-slot saturation (a replica reporting
        zero free slots adds one scale-up-pressure unit — inter-token
        pressure exists even when its admission queues are shallow).
        The poolless fleet's single ``both`` pool sees the fleet-global
        signals, exactly the pre-pool behavior."""
        if views is None:
            views = self.registry.snapshot()
        first_leg = ("prefill" if "prefill" in self._pools
                     else "both" if "both" in self._pools else "decode")
        waiting = 0
        if phase == first_leg:
            waiting = sum(t["waiting"]
                          for t in self.router.gate.stats().values())
        with self._lock:
            phases = dict(self._phases)
        backlog = 0
        for v in views:
            if phases.get(v.rid, "both") != phase:
                continue
            backlog += v.inflight + v.queue_depth
            if phase == "decode" and v.free_slots == 0:
                backlog += self._pools[phase].autoscaler.scale_up_pressure
        return waiting, backlog

    def supervise_once(self):
        """One supervisor tick: bury+respawn dead replicas into their
        own pool, then ask each pool's autoscaler over pool-local
        signals. Runs unlocked except for handle-table reads and
        writes — spawning (seconds) must not block drains or stats."""
        if self._closed.is_set():
            return {"dead": 0, "action": 0, "waiting": 0,
                    "backlog": 0, "ejected": 0, "pools": {}}
        with self._lock:
            dead = [(rid, h, self._phases.get(rid))
                    for rid, h in self._handles.items() if not h.alive()]
        for rid, handle, phase in dead:
            with self._lock:
                self._handles.pop(rid, None)
                self._phases.pop(rid, None)
            self.registry.deregister(rid)
            try:
                handle.stop(timeout=0.1)  # reap the corpse
            except Exception:  # noqa: BLE001 — already dead
                pass
            if phase not in self._pools:  # pool was reconfigured away
                phase = next(iter(self._pools))
            if self._spawn_one(phase) is not None:
                self.respawns += 1
                _M_RESPAWNS.inc()
        views = self.registry.snapshot()
        ejected = sum(v.state == EJECTED for v in views)
        total_waiting = sum(t["waiting"]
                            for t in self.router.gate.stats().values())
        total_backlog = sum(v.inflight + v.queue_depth for v in views)
        pools_out = {}
        net_action = 0
        for phase, pool in self._pools.items():
            waiting, backlog = self.pool_signals(phase, views=views)
            action = pool.autoscaler.decide(len(self._members(phase)),
                                            waiting, backlog)
            if action > 0:
                self._spawn_one(phase)
                _M_SCALE.inc(direction="up")
            elif action < 0:
                members = self._members(phase)
                if members:
                    self._remove_one(members[-1])
                    _M_SCALE.inc(direction="down")
            n_now = len(self._members(phase))
            _M_POOL_REPLICAS.set(n_now, phase=phase)
            net_action += action
            pools_out[phase] = {"replicas": n_now, "waiting": waiting,
                                "backlog": backlog, "action": action}
        return {"dead": len(dead), "action": net_action,
                "waiting": total_waiting, "backlog": total_backlog,
                "ejected": ejected, "pools": pools_out}

    def _supervise_loop(self):
        while not self._closed.wait(self._interval):
            try:
                self.supervise_once()
            except Exception:  # noqa: BLE001 — supervisor must survive
                # a failed spawn (transient exec error) must not kill
                # supervision; the next tick retries
                pass

    # ------------------------------------------------------------ reloads
    def rolling_reload(self, prefix=None, drain_deadline=10.0):
        """Hot weight swap across the fleet, one replica at a time,
        zero dropped requests: drain -> cmd 4 reload -> undrain. The
        fleet keeps serving on the other replicas throughout. Pooled
        fleets reload grouped by phase, still one replica at a time
        fleet-wide — a single-replica pool briefly empties, which the
        router covers by degrading its handoffs to colocated serving.
        Returns the per-replica reload JSON replies."""
        out = {}
        with self._lock:
            order = sorted(self._handles, key=lambda r: (
                self._phases.get(r, "both"), r))
            todo = [(r, self._handles[r]) for r in order]
        for rid, handle in todo:
            self.router.drain(rid, deadline_s=drain_deadline)
            try:
                payload = struct.pack("<B", CMD_RELOAD) + (
                    (prefix or "").encode("utf-8"))
                with socket.create_connection(
                        (handle.host, handle.port), timeout=300) as s:
                    s.settimeout(300)
                    s.sendall(struct.pack("<I", len(payload)) + payload)
                    (blen,) = struct.unpack("<I", _read_all(s, 4))
                    body = _read_all(s, blen)
                out[rid] = {"status": body[0],
                            "body": body[1:].decode("utf-8",
                                                    errors="replace")}
            finally:
                self.router.undrain(rid)
        return out

    # -------------------------------------------------------------- close
    def close(self):
        self._closed.set()
        if self._thread is not None:
            self._thread.join(5.0)
        self.router.stop()
        with self._lock:
            handles = list(self._handles.values())
            self._handles = {}
            self._phases = {}
        for h in handles:
            try:
                h.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self.registry.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _replica_main(argv):
    """``python -m paddle_tpu_torch.inference.fleet --replica PREFIX
    PORTFILE [max_batch max_wait_ms max_queue [phase]] [--device D]
    [--slab-rows N]`` — one serve_model replica that writes its bound
    port atomically and serves until cmd 7. ``phase`` tags the replica's
    pool (prefill | decode | both) in its cmd-3 health body; ``--device``
    is where it serves (the card by default) and ``--slab-rows`` the rows
    of its program calls."""
    opts = {}
    for flag in ("--device", "--slab-rows"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i:i + 2]
    prefix, portfile = argv[0], argv[1]
    max_batch = int(argv[2]) if len(argv) > 2 else 8
    max_wait_ms = float(argv[3]) if len(argv) > 3 else 2.0
    max_queue = int(argv[4]) if len(argv) > 4 else 256
    phase = argv[5] if len(argv) > 5 else None
    slab_rows = int(opts["--slab-rows"]) if "--slab-rows" in opts else None
    from .server import serve_model

    srv = serve_model(prefix, dynamic_batching=True, max_batch_size=max_batch,
                      max_wait_ms=max_wait_ms, max_queue=max_queue, phase=phase,
                      device=opts.get("--device"), slab_rows=slab_rows)
    with open(portfile + ".tmp", "w") as f:
        f.write(str(srv.port))
    os.replace(portfile + ".tmp", portfile)
    srv._thread.join()  # serve until the stop command (cmd 7)
    return 0


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "--replica":
        sys.exit(_replica_main(sys.argv[2:]))
    print("usage: python -m paddle_tpu_torch.inference.fleet --replica PREFIX PORTFILE "
          "[max_batch max_wait_ms max_queue [phase]] [--device D] [--slab-rows N]",
          file=sys.stderr)
    sys.exit(2)
