"""Elastic pod-scale training: preemption consensus, straggler
detection and host-loss recovery over a small TCP coordinator
(counterpart of paddle_tpu/resilience/elastic.py; its protocol and its
``PADDLE_TPU_ELASTIC_*`` knobs, so that a client of either package takes
part in a consensus that a coordinator of the other runs).

A SIGTERM'd trainer that saves alone tears a pod's sharded checkpoint:
every rank must save the same step. Two more failure shapes cost time at
scale: slow hosts (stragglers) and hosts that die without the grace
signal.

- :class:`ElasticCoordinator`: rank 0 owns it; a threaded TCP server
  (newline-delimited JSON, one request per connection) tracking each
  rank's heartbeats (step, step duration), straggler flags, dead hosts,
  the preemption-consensus state machine and named barriers.
- :class:`ElasticClient`: every rank (0 too) connects as a client; a
  daemon heartbeat thread gossips (step, step_s) and relays the local
  :class:`~.preemption.PreemptionHandler`'s requested flag; the training
  loop calls :meth:`ElasticClient.note_step` and
  :meth:`ElasticClient.check_boundary` at every step boundary.

Consensus:

1. Any trigger (a rank's SIGTERM handler fires, a host misses
   heartbeats past ``dead_timeout``, or :meth:`ElasticClient.request_save`)
   flips the coordinator into ``save_requested``.
2. Each alive rank, at its next step boundary, proposes the step it has
   just completed; a blocking client waits (bounded by
   ``consensus_timeout``) until consensus resolves, a non-blocking one
   (training with collectives) keeps training.
3. Once every alive rank has proposed, consensus = max(proposals) plus
   the largest margin a rank asked for (0 for blocking clients). Ranks
   behind it train the missing steps, then all save step C (the sharded
   manager's barriers) and exit 143 together.

A host whose latest step duration exceeds ``straggler_k`` x the median of
the other alive hosts for ``straggler_n`` consecutive steps is flagged
(counter and log), never killed.

Telemetry through the port's obs: ``paddle_elastic_consensus_saves_total``,
``_dead_hosts_total`` and ``_stragglers_total``; ``note_step`` accounts a
step's seconds to goodput's ``step`` category.

Environment (all ``PADDLE_TPU_ELASTIC_*``, the reference's):

    PADDLE_TPU_ELASTIC_COORD         host:port of the coordinator
                                     (set per attempt by the launcher)
    PADDLE_TPU_ELASTIC_HB_INTERVAL   heartbeat period, s     (0.5)
    PADDLE_TPU_ELASTIC_DEAD_TIMEOUT  missed-heartbeat window, s (10)
    PADDLE_TPU_ELASTIC_STRAGGLER_K   slowdown multiplier     (3.0)
    PADDLE_TPU_ELASTIC_STRAGGLER_N   consecutive strikes     (3)
    PADDLE_TPU_ELASTIC_CONSENSUS_TIMEOUT  propose wait, s    (60)
    PADDLE_TPU_ELASTIC_BARRIER_TIMEOUT    barrier wait, s    (120)
    PADDLE_TPU_ELASTIC_MARGIN        non-blocking consensus margin (2)
    PADDLE_TPU_ELASTIC_EXIT_GRACE    launcher consensus-exit grace (30)
"""
import json
import os
import socket
import socketserver
import sys
import threading
import time

from ..obs import goodput as _goodput
from ..obs import metrics as _obs
from . import preemption
from .retry import _env_float, _env_int, call_with_retry

ENV_COORD = "PADDLE_TPU_ELASTIC_COORD"

_CONSENSUS_SAVES = _obs.counter(
    "paddle_elastic_consensus_saves_total",
    "Multi-host preemption consensus rounds resolved")
_DEAD_HOSTS = _obs.counter(
    "paddle_elastic_dead_hosts_total",
    "Hosts declared dead after missing heartbeats")
_STRAGGLERS = _obs.counter(
    "paddle_elastic_stragglers_total",
    "Hosts flagged as stragglers (k*median for n consecutive steps)")


def _log(msg):
    print(f"[elastic] {msg}", file=sys.stderr, flush=True)


class ElasticError(RuntimeError):
    """Base for elastic-protocol failures."""


class CoordinatorLost(ElasticError):
    """The coordinator stopped answering: save solo is torn, so the
    caller should exit 143 WITHOUT saving and resume from the last
    published checkpoint."""


class ConsensusTimeout(ElasticError):
    """Consensus did not resolve within consensus_timeout."""


# --------------------------------------------------------------- coordinator

class _CoordServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class _CoordHandler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            line = self.rfile.readline(1 << 20)
            if not line:
                return
            msg = json.loads(line.decode("utf-8"))
            reply = self.server.coordinator.handle(msg)
            self.wfile.write(json.dumps(reply).encode("utf-8") + b"\n")
        except (OSError, ValueError):
            pass  # a dying peer mid-request; the protocol is idempotent


class ElasticCoordinator:
    """Rank-0 pod brain: heartbeats, stragglers, dead hosts, consensus.

    All state transitions happen inside :meth:`handle` under one lock;
    socket I/O stays in the per-connection handler threads OUTSIDE the
    lock. Dead-host detection is lazy — evaluated on every incoming
    request — so no extra monitor thread is needed: while any rank
    lives, its heartbeats drive the clock; if all die, the launcher's
    watch loop owns the outcome.
    """

    def __init__(self, world, host="127.0.0.1", port=0, dead_timeout=None,
                 straggler_k=None, straggler_n=None):
        self.world = int(world)
        self.dead_timeout = (_env_float("PADDLE_TPU_ELASTIC_DEAD_TIMEOUT",
                                        10.0)
                             if dead_timeout is None else float(dead_timeout))
        self.straggler_k = (_env_float("PADDLE_TPU_ELASTIC_STRAGGLER_K", 3.0)
                            if straggler_k is None else float(straggler_k))
        self.straggler_n = (_env_int("PADDLE_TPU_ELASTIC_STRAGGLER_N", 3)
                            if straggler_n is None else int(straggler_n))
        self._lock = threading.Lock()
        now = time.monotonic()
        # every expected rank starts "alive as of now": a rank that
        # never says hello still dies after dead_timeout, so a crash
        # during startup cannot hang barriers forever
        self._ranks = {r: {"step": 0, "t_hb": now, "step_s": None,
                           "strikes": 0, "straggler": False}
                       for r in range(self.world)}
        self._dead = set()
        self._save_requested = False
        self._save_reason = None
        self._proposals = {}
        self._margins = {}
        self._consensus = None
        self._barriers = {}
        self._saved = {}
        self._finished = {}
        self._server = _CoordServer((host, int(port)), _CoordHandler)
        self._server.coordinator = self
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        name="elastic-coordinator",
                                        daemon=True)
        self._thread.start()

    @property
    def port(self):
        return self._server.server_address[1]

    @property
    def address(self):
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    # ----------------------------------------------------------- state ops
    def _check_dead(self, now):
        # caller holds self._lock
        for r, info in self._ranks.items():
            if r in self._dead:
                continue
            if now - info["t_hb"] > self.dead_timeout:
                self._dead.add(r)
                self._proposals.pop(r, None)
                _DEAD_HOSTS.inc()
                _log(f"rank {r} declared dead "
                     f"(no heartbeat for {self.dead_timeout:.1f}s)")
                if not self._save_requested:
                    self._save_requested = True
                    self._save_reason = f"dead_host:{r}"

    def _alive(self):
        return [r for r in self._ranks if r not in self._dead]

    def _maybe_consensus(self):
        # caller holds self._lock. consensus = max(latest proposals)
        # [+ margin]: blocking clients (collective-free training) stop
        # at their proposal, so margin 0 and the max IS reachable by
        # every rank; non-blocking clients (collective training, where
        # stopping to wait would wedge the peers inside the next step's
        # collective) keep training while consensus resolves, so the
        # barrier is pushed `margin` steps into the future — with
        # per-step synchronisation the skew a rank can accumulate
        # before its next boundary check is < margin, so no rank can
        # overshoot the agreed step
        if not self._save_requested or self._consensus is not None:
            return
        alive = self._alive()
        if alive and all(r in self._proposals for r in alive):
            margin = max((self._margins.get(r, 0) for r in alive),
                         default=0)
            self._consensus = max(self._proposals[r]
                                  for r in alive) + margin
            _CONSENSUS_SAVES.inc()
            _log(f"consensus save at step {self._consensus} "
                 f"({self._save_reason}; proposals {self._proposals}, "
                 f"margin {margin})")

    def _note_straggler(self, rank, step_s):
        # caller holds self._lock. One sample per completed step; the
        # pod median comes from every rank's LATEST step duration.
        info = self._ranks[rank]
        info["step_s"] = step_s
        # median over the OTHER alive ranks: judging a host against a
        # median that includes its own sample hides the straggler in
        # small pods (2 hosts -> the slow one IS the upper median)
        samples = sorted(i["step_s"] for r, i in self._ranks.items()
                         if r != rank and r not in self._dead
                         and i["step_s"] is not None)
        if not samples:
            return
        mid = len(samples) // 2
        median = (samples[mid] if len(samples) % 2
                  else 0.5 * (samples[mid - 1] + samples[mid]))
        if median > 0 and step_s > self.straggler_k * median:
            info["strikes"] += 1
            if info["strikes"] >= self.straggler_n and not info["straggler"]:
                info["straggler"] = True
                _STRAGGLERS.inc()
                _log(f"rank {rank} flagged as straggler: step {step_s:.3f}s"
                     f" > {self.straggler_k:.1f} x median {median:.3f}s for "
                     f"{info['strikes']} consecutive steps")
        else:
            if info["straggler"]:
                _log(f"rank {rank} recovered: step {step_s:.3f}s back "
                     f"under {self.straggler_k:.1f} x median {median:.3f}s")
            info["strikes"] = 0
            info["straggler"] = False  # recovers when it stops lagging

    def _view(self):
        # caller holds self._lock
        return {"save": self._save_requested,
                "reason": self._save_reason,
                "consensus": self._consensus,
                "dead": sorted(self._dead),
                "stragglers": sorted(r for r, i in self._ranks.items()
                                     if i["straggler"])}

    # ------------------------------------------------------------ protocol
    def handle(self, msg):
        op = msg.get("type")
        rank = int(msg.get("rank", -1))
        now = time.monotonic()
        with self._lock:
            self._check_dead(now)
            if rank in self._ranks:
                self._ranks[rank]["t_hb"] = now
                self._dead.discard(rank)  # a flapping host came back
            if op == "hello":
                return {"ok": True, "world": self.world}
            if op == "hb":
                info = self._ranks.get(rank)
                if info is not None:
                    step = int(msg.get("step", info["step"]))
                    info["step"] = max(info["step"], step)
                    if msg.get("step_s") is not None:
                        self._note_straggler(rank, float(msg["step_s"]))
                if msg.get("preempt") and not self._save_requested:
                    self._save_requested = True
                    self._save_reason = f"preempt:{rank}"
                    _log(f"rank {rank} requested preemption save")
                self._maybe_consensus()
                return self._view()
            if op == "request_save":
                if not self._save_requested:
                    self._save_requested = True
                    self._save_reason = msg.get("reason") or f"request:{rank}"
                self._maybe_consensus()
                return self._view()
            if op == "propose":
                if rank not in self._dead and rank in self._ranks:
                    step = int(msg["step"])
                    prev = self._proposals.get(rank)
                    self._proposals[rank] = max(step, prev or 0)
                    self._margins[rank] = int(msg.get("margin", 0))
                self._maybe_consensus()
                return self._view()
            if op == "barrier":
                arrived = self._barriers.setdefault(str(msg["name"]), set())
                arrived.add(rank)
                alive = set(self._alive())
                return {"done": alive <= arrived, "n": len(arrived)}
            if op == "barrier_status":
                arrived = self._barriers.get(str(msg["name"]), set())
                alive = set(self._alive())
                return {"done": bool(arrived) and alive <= arrived,
                        "n": len(arrived)}
            if op == "finished":
                # a rank that completed its workload: it stops polling
                # check_boundary, so it stands as a PERMANENT proposal
                # at its final step — a consensus triggered afterwards
                # (straggler still training + a host dies) resolves to
                # max(final steps) instead of stalling on a rank that
                # will never propose again
                if rank in self._ranks:
                    step = int(msg.get("step", 0))
                    self._finished[rank] = step
                    prev = self._proposals.get(rank)
                    self._proposals[rank] = max(step, prev or 0)
                self._maybe_consensus()
                view = self._view()
                alive = set(self._alive())
                view["done"] = alive <= set(self._finished)
                return view
            if op == "saved":
                self._saved[rank] = int(msg["step"])
                return {"ok": True}
            if op == "status":
                view = self._view()
                view["ranks"] = {str(r): {"step": i["step"],
                                          "step_s": i["step_s"],
                                          "straggler": i["straggler"],
                                          "age_s": round(now - i["t_hb"], 3)}
                                 for r, i in self._ranks.items()}
                view["saved"] = dict(self._saved)
                view["proposals"] = dict(self._proposals)
                return view
        return {"error": f"unknown op {op!r}"}


# -------------------------------------------------------------------- client

class ElasticClient:
    """Per-rank handle on the pod coordinator.

    The training loop calls ``note_step(step, seconds)`` after every
    completed step and then ``check_boundary(step)``; a non-None return
    C means "save at step C and exit 143" — keep training until
    ``step >= C`` first. The heartbeat thread gossips in the
    background and relays the local preemption handler, so a SIGTERM
    anywhere in the pod converges every rank onto one boundary.
    """

    def __init__(self, address, rank, world, hb_interval=None,
                 handler=None, consensus_timeout=None, barrier_timeout=None,
                 dead_timeout=None, block=True, margin=None):
        if isinstance(address, str):
            host, port = address.rsplit(":", 1)
            address = (host, int(port))
        self._addr = tuple(address)
        self.rank = int(rank)
        self.world = int(world)
        self._hb_interval = (_env_float("PADDLE_TPU_ELASTIC_HB_INTERVAL", 0.5)
                             if hb_interval is None else float(hb_interval))
        self._consensus_timeout = (
            _env_float("PADDLE_TPU_ELASTIC_CONSENSUS_TIMEOUT", 60.0)
            if consensus_timeout is None else float(consensus_timeout))
        self._barrier_timeout = (
            _env_float("PADDLE_TPU_ELASTIC_BARRIER_TIMEOUT", 120.0)
            if barrier_timeout is None else float(barrier_timeout))
        self._dead_timeout = (_env_float("PADDLE_TPU_ELASTIC_DEAD_TIMEOUT",
                                         10.0)
                              if dead_timeout is None else float(dead_timeout))
        self._handler = handler  # None -> process PreemptionHandler
        # block=True: stop at the boundary until consensus resolves —
        # correct ONLY for collective-free training (independent
        # replicas). Training with cross-process collectives MUST use
        # block=False: a rank parked at its boundary would wedge the
        # peers already inside the next step's collective, so instead
        # every rank keeps training, proposals are fire-and-forget, and
        # the coordinator pushes the agreed step `margin` boundaries
        # into the future (always still reachable: per-step sync bounds
        # the skew below margin).
        self._block = bool(block)
        self._margin = (_env_int("PADDLE_TPU_ELASTIC_MARGIN", 2)
                        if margin is None else int(margin))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._step = 0
        self._last_step_s = None
        self._fresh_step_s = False
        self._save_requested = False
        self._save_reason = None
        self._consensus = None
        self._stragglers = []
        self._dead = []
        self._fail_since = None
        self._coordinator = None  # rank 0 owns the server through us
        self._hb_thread = None

    # ------------------------------------------------------------- wiring
    def start(self):
        """Say hello (retrying through coordinator startup races) and
        start the heartbeat thread."""
        call_with_retry(self._rpc, {"type": "hello", "rank": self.rank},
                        retry_on=(OSError, ValueError),
                        max_attempts=20, base_delay=0.05, max_delay=0.5,
                        deadline=self._dead_timeout + 10.0)
        t = threading.Thread(target=self._hb_loop, name="elastic-heartbeat",
                             daemon=True)
        self._hb_thread = t
        t.start()
        return self

    def close(self):
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        if self._coordinator is not None:
            self._coordinator.close()
        _clear_active(self)

    def _rpc(self, msg, timeout=5.0):
        with socket.create_connection(self._addr, timeout=timeout) as s:
            f = s.makefile("rwb")
            f.write(json.dumps(msg).encode("utf-8") + b"\n")
            f.flush()
            line = f.readline(1 << 20)
        if not line:
            raise ConnectionError("empty coordinator reply")
        return json.loads(line.decode("utf-8"))

    def _preempt_pending(self):
        h = self._handler
        if h is None:
            h = preemption.get_preemption_handler()
        return h.requested

    def _send_hb(self):
        """One heartbeat round-trip; folds the reply into local state.
        Returns the reply (or None on coordinator failure).

        A step duration is gossiped AT MOST ONCE: the background
        heartbeat re-sending the same sample between boundaries would
        multiply one slow step into straggler_n strikes (the coordinator
        counts strikes per sample, and the contract is per STEP)."""
        with self._lock:
            payload = {"type": "hb", "rank": self.rank, "step": self._step,
                       "step_s": (self._last_step_s
                                  if self._fresh_step_s else None)}
            self._fresh_step_s = False
        if self._preempt_pending():
            payload["preempt"] = True
        try:
            reply = self._rpc(payload)
        except (OSError, ValueError):
            now = time.monotonic()
            with self._lock:
                if self._fail_since is None:
                    self._fail_since = now
            return None
        self._absorb(reply)
        return reply

    def _absorb(self, reply):
        with self._lock:
            self._fail_since = None
            self._save_requested = bool(reply.get("save"))
            self._save_reason = reply.get("reason")
            if reply.get("consensus") is not None:
                self._consensus = int(reply["consensus"])
            self._stragglers = list(reply.get("stragglers", []))
            self._dead = list(reply.get("dead", []))

    def _hb_loop(self):
        while not self._stop.wait(self._hb_interval):
            self._send_hb()

    def _coordinator_lost(self):
        with self._lock:
            since = self._fail_since
        return since is not None and (time.monotonic() - since
                                      > self._dead_timeout)

    # ----------------------------------------------------- training-loop API
    def note_step(self, step, seconds=None):
        """Record a completed useful step: feeds the goodput ledger and
        stages (step, duration) for the next gossip round —
        :meth:`check_boundary` sends it inline at the boundary, so
        straggler math sees every step even with a slow heartbeat
        interval."""
        if seconds is not None:
            _goodput.account("step", seconds)
        with self._lock:
            self._step = max(self._step, int(step))
            self._last_step_s = (None if seconds is None
                                 else float(seconds))
            self._fresh_step_s = seconds is not None

    def request_save(self, reason=None):
        """Programmatic consensus trigger (tests, a cluster agent
        polling a maintenance-event API)."""
        try:
            reply = self._rpc({"type": "request_save", "rank": self.rank,
                               "reason": reason})
        except (OSError, ValueError):
            return
        self._absorb(reply)

    def check_boundary(self, completed_step):
        """Called at every step boundary with the just-completed step.

        Returns None (keep training) or the consensus step C: train
        until ``completed_step >= C``, save C, call :meth:`saved`, then
        exit 143. Blocks (bounded) while consensus resolves. Raises
        :class:`CoordinatorLost` / :class:`ConsensusTimeout` when the
        protocol cannot complete — exit 143 WITHOUT saving then."""
        # one fresh gossip round per boundary: carries this step's
        # duration (straggler math) + the local preemption flag, and
        # pulls the pod's save/consensus state — never act on a stale
        # heartbeat-thread snapshot
        self._send_hb()
        with self._lock:
            requested = self._save_requested
            consensus = self._consensus
        if not requested:
            if self._coordinator_lost():
                raise CoordinatorLost(
                    "coordinator unreachable at step boundary")
            return None
        if consensus is not None:
            return consensus
        propose = {"type": "propose", "rank": self.rank,
                   "step": int(completed_step),
                   "margin": 0 if self._block else self._margin}
        if not self._block:
            # collective mode: propose and KEEP TRAINING; the consensus
            # step (max + margin) lies ahead, and the next boundary
            # check collects it
            try:
                reply = self._rpc(propose)
            except (OSError, ValueError):
                if self._coordinator_lost():
                    raise CoordinatorLost(
                        "coordinator unreachable during consensus")
                now = time.monotonic()
                with self._lock:
                    if self._fail_since is None:
                        self._fail_since = now
                return None
            self._absorb(reply)
            if reply.get("consensus") is not None:
                return int(reply["consensus"])
            return None
        deadline = time.monotonic() + self._consensus_timeout
        while time.monotonic() < deadline:
            try:
                reply = self._rpc(propose)
            except (OSError, ValueError):
                if self._coordinator_lost():
                    raise CoordinatorLost(
                        "coordinator unreachable during consensus; "
                        "exiting without a (torn) solo save")
                now = time.monotonic()
                with self._lock:
                    if self._fail_since is None:
                        self._fail_since = now
                time.sleep(min(0.2, self._hb_interval))
                continue
            self._absorb(reply)
            if reply.get("consensus") is not None:
                return int(reply["consensus"])
            time.sleep(0.02)
        raise ConsensusTimeout(
            f"no consensus within {self._consensus_timeout:.0f}s "
            f"(proposed step {completed_step})")

    def finish_and_drain(self, final_step, timeout=None):
        """Announce completion and wait for the rest of the pod.

        Keeps rank 0's coordinator alive until every ALIVE rank is done
        — a straggler must not lose its coordinator because the fast
        ranks finished — and keeps this rank responsive to a late
        consensus (another host dies while we drain): returns None on a
        clean pod-wide finish, or the consensus step to save at (always
        our own final step, since a finished rank holds the max
        proposal). Coordinator loss during the drain means rank 0
        finished and exited: treated as done."""
        timeout = self._barrier_timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                reply = self._rpc({"type": "finished", "rank": self.rank,
                                   "step": int(final_step)})
            except (OSError, ValueError):
                if self._coordinator_lost():
                    return None
                now = time.monotonic()
                with self._lock:
                    if self._fail_since is None:
                        self._fail_since = now
                time.sleep(min(0.2, self._hb_interval))
                continue
            self._absorb(reply)
            if reply.get("save") and reply.get("consensus") is not None:
                return int(reply["consensus"])
            if reply.get("done"):
                return None
            time.sleep(min(0.2, self._hb_interval))
        return None  # drained our patience; the launcher owns the rest

    def barrier(self, name, timeout=None):
        """All-alive-ranks barrier through the coordinator (used by the
        multi-process checkpoint staging: dead ranks are excluded, so a
        host loss cannot hang the publish)."""
        timeout = self._barrier_timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        msg = {"type": "barrier", "rank": self.rank, "name": name}
        while time.monotonic() < deadline:
            try:
                reply = self._rpc(msg)
            except (OSError, ValueError):
                if self._coordinator_lost():
                    raise CoordinatorLost(
                        f"coordinator unreachable in barrier {name!r}")
                time.sleep(0.05)
                continue
            if reply.get("done"):
                return
            msg = {"type": "barrier_status", "rank": self.rank,
                   "name": name}
            time.sleep(0.02)
        raise TimeoutError(f"elastic barrier {name!r} timed out "
                           f"after {timeout:.0f}s")

    def saved(self, step):
        try:
            self._rpc({"type": "saved", "rank": self.rank,
                       "step": int(step)})
        except (OSError, ValueError):
            pass  # informational; the barrier already synchronised us

    def status(self):
        return self._rpc({"type": "status", "rank": self.rank})

    @property
    def stragglers(self):
        with self._lock:
            return list(self._stragglers)


class LocalElastic:
    """Single-host fallback with the same surface: consensus degrades
    to saving at the next boundary, barriers are no-ops."""

    rank = 0
    world = 1

    def __init__(self, handler=None):
        self._handler = handler

    def start(self):
        return self

    def close(self):
        _clear_active(self)

    def note_step(self, step, seconds=None):
        if seconds is not None:
            _goodput.account("step", seconds)

    def _requested(self):
        h = self._handler
        if h is None:
            h = preemption.get_preemption_handler()
        return h.requested

    def request_save(self, reason=None):
        h = self._handler
        if h is None:
            h = preemption.get_preemption_handler()
        h.request()

    def check_boundary(self, completed_step):
        return int(completed_step) if self._requested() else None

    def finish_and_drain(self, final_step, timeout=None):
        return int(final_step) if self._requested() else None

    def barrier(self, name, timeout=None):
        return None

    def saved(self, step):
        pass

    def status(self):
        return {"save": self._requested(), "consensus": None,
                "dead": [], "stragglers": [], "ranks": {}}

    @property
    def stragglers(self):
        return []


_active = None
_active_lock = threading.Lock()


def _clear_active(client):
    global _active
    with _active_lock:
        if _active is client:
            _active = None


def active_client():
    """The pod's elastic client, if init_from_env created one (the
    sharded checkpoint manager uses its barrier by default)."""
    with _active_lock:
        return _active


def init_from_env(handler=None, **kwargs):
    """Build the pod's elastic handle from the PADDLE_* env contract.

    Rank 0 starts the coordinator on PADDLE_TPU_ELASTIC_COORD (the
    launcher picks the address per attempt); every rank connects as a
    client. With world <= 1 or no coordinator address, returns the
    :class:`LocalElastic` fallback.
    """
    global _active
    try:
        world = int(os.environ.get("PADDLE_TRAINERS_NUM") or 1)
    except ValueError:
        world = 1
    addr = os.environ.get(ENV_COORD)
    rank = int(os.environ.get("PADDLE_TRAINER_ID") or 0)
    if world <= 1 or not addr:
        client = LocalElastic(handler=handler)
        with _active_lock:
            _active = client
        return client
    host, port = addr.rsplit(":", 1)
    coordinator = None
    if rank == 0:
        coordinator = ElasticCoordinator(world, host=host, port=int(port))
    client = ElasticClient((host, int(port)), rank, world, handler=handler,
                           **kwargs)
    client._coordinator = coordinator
    client.start()
    with _active_lock:
        _active = client
    return client
