"""Inference server (counterpart of paddle_tpu/inference/server.py):
serves a callable over the length-prefixed TCP wire protocol of
inference/wire_spec.py.

Commands served: 1 ``infer`` (one-shot; the 0xDD deadline field is
honoured, the 0x1D trace id is handed to the engine, the tenant field is
parsed and ignored), 3 ``health``, 5 ``stats``, 6 ``metrics`` (the
Prometheus text of ``obs.metrics.REGISTRY``: every live engine's and
server's families), 7 ``stop``, 9 ``kv_put`` and 10 ``kv_resume``.
Statuses: 0 ok, 1 request error, 2 retryable (shed by the engine's
bounded queue, an expired deadline, or a snapshot this replica refuses),
3 stream chunk.

A cmd-1 request carrying the 0x5C decode field goes to the attached
``DecodeEngine`` (inference/decode.py; without one it answers status 1):
low 32 bits max_new_tokens, input 0 the prompt (1-D int32/int64 ids, whose
dtype the token chunks echo), further inputs the model's per-sequence
features; the 0xDD deadline becomes a per-token budget. The reply is a
chunked stream: status-3 frames of one token-array chunk each, then one
terminal frame with status 0 (the last chunk, possibly empty), or 1/2 on
error/shed. With bit 63 (one-shot) it is one status-0 reply of the whole
sequence. A client that vanishes mid-stream cancels its request, so its
slot frees at once. Bit 61 opts the stream into speculative decoding
(the engine's ``submit(speculative=True)``: bursts on an engine with a
draft and ``spec_k`` >= 2, plain steps otherwise; the tokens are the
plain stream's either way). A snapshot cadence N (bits
32-47) adds a status-3 kv-snapshot frame (``wire_spec.is_kv_snapshot``)
every N generated tokens, sent once every token it covers is on the
wire. Bit 62 (prefill handoff) runs the prompt to its first token and
replies with exactly one snapshot frame and then the token.

Cmd 9 (``kv_put``) checks a snapshot block against this replica (status
0 with the header echoed as JSON, 2 on an identity or capacity skew, 1
on a malformed block); cmd 10 (``kv_resume``) resumes it and replies as
a decode stream with the tokens after the snapshot (one-shot: the whole
sequence), or status 2 before any token on a skew. Neither holds the
engine's locks while it reads or writes the socket. Cmds 3 and 5 carry
the engine's health and stats under ``"decode"``.

Cmd 4 (``reload``, optional UTF-8 model prefix; empty = the same) hot-swaps
the served model on a server made by ``serve_model``: the new model loads
and warms (the old engine's declared buckets) to the side while requests
keep flowing, the (run, engine) pair swaps under the backend lock, then
the old engine closes, which drains its in-flight batches; a handler that
raced the swap retries once on the new engine. The reply is the
reference's JSON (``reloaded``, ``prefix``, ``warm_buckets``,
``reloads``), or status 1 with the error (a bare server has no loader).
Cmd 8 (``drain``, optional f64 seconds; negative re-opens) announces a
drain: health reports ``draining``, ``accepting`` false and
``draining_deadline_s``, and the reply is the health JSON. Unlike the
reference, which keeps serving new requests while it drains, the port
then admits no new cmd-1 request: each answers status 2 (retryable: go to
another replica) while the requests already admitted finish. Health's
fields are the reference's (``ok``, ``phase``, ``decode``, ``draining``,
``accepting``, ``draining_deadline_s``, ``connections``, ``reloads``,
``engine``); stats carry ``phase``. ``phase`` ("prefill", "decode" or
"both", the default; an attached decode engine's own phase when none is
given) is the replica's pool in a disaggregated fleet
(inference/fleet.py): placement only, every phase serves every command.
A fleet router (inference/router.py) meets the refusing drain by
retrying the status-2 reply on another replica.

The server's own instruments (the reference's: connections, frames by
cmd, responses by status, open connections, stream frames; const label
``port``) are exposed by a collector until ``stop``. A traced request
(0x1D) gets a ``serving.reply`` span under its id, besides the engines'
spans.
"""
import json
import socket
import struct
import threading
import time
import weakref

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import prometheus as obs_prometheus
from ..obs import tracing as obs_tracing
from . import wire_spec
from .batching import DeadlineExceeded, EngineClosed, RetryableError
from .wire_spec import (CMD_DRAIN, CMD_HEALTH, CMD_INFER, CMD_KV_PUT, CMD_KV_RESUME,
                        CMD_METRICS, CMD_RELOAD, CMD_STATS, CMD_STOP, STATUS_ERROR, STATUS_OK,
                        STATUS_RETRYABLE, STATUS_STREAM, build_reply)

# a 4-byte length prefix from a broken client must not trigger an
# unbounded allocation, and a client that stalls mid-frame must not pin
# a handler thread forever
MAX_BODY_BYTES = 64 * 1024 * 1024
RECV_TIMEOUT = 30.0
DRAIN_TIMEOUT = 10.0
# the longest a decode stream waits for its next token
DECODE_STREAM_TIMEOUT = 300.0
LISTEN_BACKLOG = 128


class BodyTooLarge(ValueError):
    pass


class Draining(RetryableError):
    """The server announced a drain (cmd 8) and admits no new request."""


def _read_all(sock, n, limit=None):
    if limit is not None and n > limit:
        raise BodyTooLarge(f"frame of {n} bytes exceeds cap {limit}")
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


class PredictorServer:
    """Serve ``run_fn`` (any callable taking numpy arrays and returning an
    output or a list of outputs) on a TCP port. With ``engine`` (an
    inference.batching.BatchingEngine) cmd-1 requests from all
    connections go through the engine's scheduler instead, and cmd 5
    returns its counters. ``own_engine=True`` closes the engine on stop.
    With ``decode_engine`` (an inference.decode.DecodeEngine) cmd-1
    requests carrying the 0x5C field are decoded there and streamed back;
    ``own_decode_engine=True`` closes it on stop. With ``loader`` (a
    callable ``prefix -> (run_fn, engine_or_None)``, supplied by
    ``serve_model``) cmd 4 hot-swaps the served model (module
    docstring). ``phase``: the replica's pool (module docstring)."""

    def __init__(self, run_fn, port=0, host="127.0.0.1", max_body=MAX_BODY_BYTES,
                 recv_timeout=RECV_TIMEOUT, engine=None, own_engine=False,
                 decode_engine=None, own_decode_engine=False, loader=None, prefix=None,
                 phase=None):
        self._run = run_fn
        self._engine = engine
        self._own_engine = own_engine and engine is not None
        if phase is None:
            phase = getattr(decode_engine, "phase", None) or "both"
        if phase not in wire_spec.REPLICA_PHASES:
            raise ValueError(f"unknown replica phase {phase!r} (expected one of "
                             f"{wire_spec.REPLICA_PHASES})")
        self.phase = phase
        self._loader = loader
        self._prefix = prefix
        self._backend_lock = threading.Lock()  # guards the (run, engine) swap
        self._reload_lock = threading.Lock()  # one reload at a time
        self._reload_count = 0
        self.last_reload_s = None
        # drain announcement (cmd 8 / begin_drain / stop), under _conns_lock
        self._accepting = True
        self._draining_deadline = None  # monotonic, or None
        # an obs.httpd.MetricsServer attached by serve_model(metrics_port=);
        # stop() closes it
        self.metrics_server = None
        self._decode_engine = decode_engine
        self._own_decode_engine = own_decode_engine and decode_engine is not None
        self._max_body = max_body
        self._recv_timeout = recv_timeout
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        # a backlog above a burst of clients: with the reference's 8, the
        # connects beyond it wait out a SYN retry (1 s on Linux), so 16
        # streams sent at once would arrive in two waves
        self._sock.listen(LISTEN_BACKLOG)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._conns = {}  # thread -> {"conn": socket, "busy": bool}
        self._conns_lock = threading.Lock()
        self._init_metrics()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _init_metrics(self):
        """The server's instruments (the reference's ``_init_metrics``),
        exposed through a collector in the process registry until
        ``stop``."""
        cl = {"port": str(self.port)}
        M = obs_metrics
        self._m_conns = M.Counter("paddle_server_connections_total",
                                  "Accepted client connections", const_labels=cl)
        self._m_frames = M.Counter("paddle_server_frames_total",
                                   "Request frames received, by wire command",
                                   labelnames=("cmd",), const_labels=cl)
        self._m_responses = M.Counter(
            "paddle_server_responses_total",
            "cmd-1 infer responses, by wire status (0 ok, 1 error, 2 retryable)",
            labelnames=("status",), const_labels=cl)
        self._m_open = M.Gauge("paddle_server_connections_open", "Currently-connected clients",
                               const_labels=cl)
        self._m_chunks = M.Counter("paddle_server_stream_chunks_total",
                                   "Streaming decode reply frames sent (status 3 + terminal)",
                                   const_labels=cl)
        self._m_reloads = M.Counter("paddle_server_reloads_total", "Hot model reloads",
                                    const_labels=cl)
        instruments = [self._m_conns, self._m_frames, self._m_responses, self._m_reloads,
                       self._m_open, self._m_chunks]
        ref = weakref.ref(self)

        def collector():
            srv = ref()
            if srv is None:
                return None  # a server dropped without stop(): unregister
            with srv._conns_lock:
                srv._m_open.set(len(srv._conns))
            return [m.collect() for m in instruments]

        self._obs_collector = collector
        obs_metrics.REGISTRY.register_collector(collector)

    def _answer(self, conn, status, payload=b""):
        """Send a request's terminal reply, counted by status."""
        self._m_responses.inc(status=str(status))
        conn.sendall(build_reply(status, payload))

    def _frame(self, conn, status, payload=b""):
        """Send one frame of a decode stream (status 3, or its terminal)."""
        self._m_chunks.inc()
        conn.sendall(build_reply(status, payload))

    def _span_reply(self, trace_id, t0, **attrs):
        if trace_id is not None:
            obs_tracing.record_span("serving.reply", time.perf_counter() - t0,
                                    trace_id=trace_id, port=self.port, **attrs)

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self._m_conns.inc()
            t = threading.Thread(target=self._handle, args=(conn,), daemon=True)
            with self._conns_lock:
                self._conns[t] = {"conn": conn, "busy": False}
            t.start()

    def _set_busy(self, busy):
        with self._conns_lock:
            ent = self._conns.get(threading.current_thread())
            if ent is not None:
                ent["busy"] = busy

    def _backend(self):
        with self._backend_lock:
            return self._run, self._engine

    def _stats_json(self):
        _, engine = self._backend()
        stats = {"engine": None} if engine is None else dict(engine.stats())
        stats["phase"] = self.phase
        if self._decode_engine is not None:
            stats["decode"] = self._decode_engine.stats()
        return json.dumps(stats)

    def _health_json(self):
        _, engine = self._backend()
        eng = engine.health() if engine is not None else None
        dec = self._decode_engine.health() if self._decode_engine is not None else None
        with self._conns_lock:
            conns = len(self._conns)
            accepting = self._accepting and not self._stop.is_set()
            dl = self._draining_deadline
        draining = not accepting
        return json.dumps({
            "ok": not draining and (eng is None or eng["ok"]) and (dec is None or dec["ok"]),
            "phase": self.phase,
            "decode": dec,
            "draining": draining,
            "accepting": accepting,
            "draining_deadline_s": (None if (accepting or dl is None)
                                    else round(max(0.0, dl - time.monotonic()), 3)),
            "connections": conns,
            "reloads": self._reload_count,
            "engine": eng,
        })

    def accepting(self):
        """Whether new requests are admitted (no drain announced)."""
        with self._conns_lock:
            return self._accepting and not self._stop.is_set()

    def begin_drain(self, deadline_s=None):
        """Announce a drain (cmd 8): health flips to accepting false and new
        requests answer status 2 while the admitted ones finish.
        ``deadline_s`` is advisory (``draining_deadline_s``); a negative
        value cancels the drain."""
        with self._conns_lock:
            if deadline_s is not None and deadline_s < 0:
                self._accepting = True
                self._draining_deadline = None
            else:
                self._accepting = False
                self._draining_deadline = (None if deadline_s is None
                                           else time.monotonic() + float(deadline_s))

    def reload(self, prefix=None):
        """Atomic hot swap (cmd 4; module docstring). Returns the reply's
        dict."""
        if self._loader is None:
            raise RuntimeError("this server has no model loader; hot reload needs a server "
                               "constructed by serve_model(...) (a bare PredictorServer "
                               "wraps an opaque callable)")
        with self._reload_lock:
            if self._stop.is_set():
                raise RuntimeError("server is stopping; reload refused")
            new_prefix = prefix or self._prefix
            old_engine = self._backend()[1]
            t0 = time.perf_counter()
            new_run, new_engine = self._loader(new_prefix)
            t1 = time.perf_counter()
            warmed = []
            try:
                if new_engine is not None:
                    declared = old_engine.declared_buckets() if old_engine is not None else None
                    warmed = new_engine.warmup(declared or None)
                # host seconds of the last reload's load and warmup
                self.last_reload_s = {"load": t1 - t0, "warm": time.perf_counter() - t1}
                with self._backend_lock:
                    if self._stop.is_set():
                        raise RuntimeError("server stopped during reload; new model discarded")
                    old_engine, old_owned = self._engine, self._own_engine
                    self._run, self._engine = new_run, new_engine
                    self._own_engine = new_engine is not None
                    self._prefix = new_prefix
                    self._reload_count += 1
                    self._m_reloads.inc()
            except BaseException:
                # a failed load or warmup must not leak the new engine's threads
                if new_engine is not None:
                    new_engine.close()
                raise
            if old_engine is not None and old_owned:
                old_engine.close()  # drains: its pending groups still fire
            return {"reloaded": True, "prefix": new_prefix, "warm_buckets": list(warmed),
                    "reloads": self._reload_count}

    def _infer(self, inputs, budget, trace_id):
        """One non-streaming cmd-1 request (already parsed); returns the
        encoded output arrays."""
        if budget is not None and budget <= 0.0:
            raise DeadlineExceeded("the client's budget was spent before the "
                                   "request arrived")
        if not self.accepting():
            raise Draining("the server is draining; send the request to another replica")
        deadline = None if budget is None else time.monotonic() + budget
        for attempt in (0, 1):
            run, engine = self._backend()
            try:
                if engine is not None:
                    outputs = engine.infer(inputs, deadline=deadline, trace_id=trace_id)
                else:
                    outputs = run(*inputs)
                break
            except EngineClosed:
                # hot-swapped between the snapshot and the submit: once more
                # on the new backend, so a reload drops no request
                if attempt:
                    raise
        if not isinstance(outputs, (list, tuple)):
            outputs = [outputs]
        outputs = [o.detach().cpu().numpy() if hasattr(o, "detach") else o for o in outputs]
        return wire_spec.encode_arrays(outputs)

    def _handle(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                # idle between frames: block without a timeout (stop()
                # unblocks this recv by closing the socket); once a frame
                # has started, a stalled peer times out
                conn.settimeout(None)
                first = conn.recv(1)
                if not first:
                    raise ConnectionError("peer closed")
                conn.settimeout(self._recv_timeout)
                (blen,) = struct.unpack("<I", first + _read_all(conn, 3))
                if blen == 0:
                    conn.sendall(build_reply(STATUS_ERROR))
                    continue
                self._set_busy(True)
                try:
                    body = _read_all(conn, blen, limit=self._max_body)
                except BodyTooLarge:
                    # the rest of the frame is unread: answer, then close
                    conn.sendall(build_reply(STATUS_ERROR))
                    return
                cmd = body[0]
                self._m_frames.inc(cmd=str(cmd))
                if cmd == CMD_STOP:
                    conn.sendall(build_reply(STATUS_OK))
                    threading.Thread(target=self.stop, daemon=True).start()
                    return
                if cmd == CMD_HEALTH:
                    conn.sendall(build_reply(STATUS_OK, self._health_json().encode()))
                elif cmd == CMD_STATS:
                    conn.sendall(build_reply(STATUS_OK, self._stats_json().encode()))
                elif cmd == CMD_METRICS:
                    conn.sendall(build_reply(STATUS_OK, obs_prometheus.render().encode("utf-8")))
                elif cmd == CMD_RELOAD:
                    prefix = body[1:].decode("utf-8", errors="replace")
                    try:
                        info = self.reload(prefix or None)
                        conn.sendall(build_reply(STATUS_OK, json.dumps(info).encode()))
                    except Exception as e:  # noqa: BLE001 - the reload's error
                        conn.sendall(build_reply(STATUS_ERROR,
                                                 str(e).encode("utf-8", errors="replace")))
                elif cmd == CMD_DRAIN:
                    deadline_s = struct.unpack("<d", body[1:9])[0] if len(body) >= 9 else None
                    self.begin_drain(deadline_s)
                    conn.sendall(build_reply(STATUS_OK, self._health_json().encode()))
                elif cmd == CMD_KV_PUT:
                    self._serve_kv_put(conn, body[1:])
                elif cmd == CMD_KV_RESUME:
                    self._serve_kv_resume(conn, body[1:])
                elif cmd != CMD_INFER:
                    conn.sendall(build_reply(STATUS_ERROR))
                else:
                    self._serve_infer(conn, body[1:])
                self._set_busy(False)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()
            with self._conns_lock:
                self._conns.pop(threading.current_thread(), None)

    def _serve_infer(self, conn, payload):
        """One cmd-1 request: a decode stream (0x5C field) sends its own
        frames; a one-shot request gets one reply."""
        try:
            inputs, budget, trace_id, decode_opts = wire_spec.decode_request(payload)
        except Exception:  # noqa: BLE001 - malformed body
            self._answer(conn, STATUS_ERROR, b"malformed infer body")
            return
        if decode_opts is not None:
            self._serve_decode(conn, inputs, budget, trace_id, decode_opts)
            return
        t0 = time.perf_counter()
        try:
            status, body = STATUS_OK, self._infer(inputs, budget, trace_id)
        except (RetryableError, EngineClosed):
            # shed, expired deadline, or a request racing stop(): retryable
            status, body = STATUS_RETRYABLE, b""
        except Exception as e:  # noqa: BLE001 - the request's own error
            status, body = STATUS_ERROR, f"{type(e).__name__}: {e}".encode()
        self._answer(conn, status, body)
        if status == STATUS_OK:
            self._span_reply(trace_id, t0)

    # ------------------------------------------------- streaming decode
    def _serve_decode(self, conn, inputs, budget, trace_id, opts):
        """One cmd-1 decode request: submit it to the decode engine and
        reply as a chunk stream, or as one reply in one-shot mode."""
        dec = self._decode_engine
        if dec is None or not inputs:
            self._answer(conn, STATUS_ERROR, b"no decode engine attached to this server")
            return
        t0 = time.perf_counter()
        handoff = opts["handoff"]
        try:
            req = dec.submit(inputs[0], features=list(inputs[1:]),
                             max_new_tokens=1 if handoff else opts["max_new_tokens"],
                             token_budget_s=budget, trace_id=trace_id,
                             snapshot_every=1 if handoff else opts["snapshot_every"],
                             speculative=opts["speculative"])
        except (RetryableError, EngineClosed):
            self._answer(conn, STATUS_RETRYABLE)
            return
        except Exception:  # noqa: BLE001 - a bad request (shape, dtype, length)
            self._answer(conn, STATUS_ERROR)
            return
        if handoff:
            self._serve_prefill_handoff(conn, dec, req, trace_id, t0)
        elif opts["oneshot"]:
            self._reply_whole(conn, dec, req, trace_id, t0)
        else:
            self._stream_tokens(conn, dec, req, trace_id, t0,
                                emit_snapshots=bool(opts["snapshot_every"]))

    def _reply_whole(self, conn, dec, req, trace_id, t0):
        """One status-0 reply of the whole sequence (one-shot)."""
        tokens = self._result(conn, dec, req)
        if tokens is not None:
            self._answer(conn, STATUS_OK, wire_spec.encode_arrays([tokens]))
            self._span_reply(trace_id, t0, tokens=int(tokens.size))

    def _result(self, conn, dec, req):
        """The request's whole token array, or None after answering its
        failure (status 2 retryable, 1 otherwise)."""
        try:
            return req.result(timeout=DECODE_STREAM_TIMEOUT)
        except (RetryableError, EngineClosed, TimeoutError):
            dec.cancel(req)
            self._answer(conn, STATUS_RETRYABLE)
        except Exception:  # noqa: BLE001 - the request's own error
            dec.cancel(req)
            self._answer(conn, STATUS_ERROR)
        return None

    def _serve_prefill_handoff(self, conn, dec, req, trace_id, t0):
        """The 0x5C bit-62 path, a disaggregated fleet's prefill leg: the
        request ran with max_new_tokens 1 and cadence 1, so the engine
        built the n_generated=1 block at the first token. Exactly two
        frames: one status-3 kv-snapshot frame, then the terminal status-0
        frame with the token; status 2 if the block is missing."""
        tokens = self._result(conn, dec, req)
        if tokens is None:
            return
        blob = req.latest_snapshot()
        if blob is None:
            self._answer(conn, STATUS_RETRYABLE)
            return
        self._frame(conn, STATUS_STREAM, blob)
        self._m_responses.inc(status=str(STATUS_OK))
        self._frame(conn, STATUS_OK, wire_spec.encode_arrays([tokens]))
        self._span_reply(trace_id, t0, tokens=int(tokens.size))

    def _stream_tokens(self, conn, dec, req, trace_id, t0, emit_snapshots=False, sent=0):
        """Drain one decode request onto the wire: a status-3 frame per
        batch of new tokens, then one terminal frame. With
        ``emit_snapshots`` each new kv-snapshot block goes out as one more
        status-3 frame once ``sent`` covers its n_generated (``sent``
        starts at a resumed stream's snapshot position). A reader that is
        gone (a failed send) cancels the request, so its slot frees now."""
        pending = None
        try:
            while True:
                try:
                    toks, done = req.next_tokens(timeout=DECODE_STREAM_TIMEOUT)
                except (RetryableError, EngineClosed, TimeoutError):
                    dec.cancel(req)
                    self._m_responses.inc(status=str(STATUS_RETRYABLE))
                    self._frame(conn, STATUS_RETRYABLE)
                    return
                except Exception:  # noqa: BLE001 - the request's own error
                    dec.cancel(req)
                    self._m_responses.inc(status=str(STATUS_ERROR))
                    self._frame(conn, STATUS_ERROR)
                    return
                sent += len(toks)
                chunk = wire_spec.encode_arrays([np.asarray(toks, dtype=req.token_dtype)])
                if done:
                    self._m_responses.inc(status=str(STATUS_OK))
                    self._frame(conn, STATUS_OK, chunk)
                    self._span_reply(trace_id, t0, tokens=sent)
                    return
                self._frame(conn, STATUS_STREAM, chunk)
                if emit_snapshots:
                    got = req.take_snapshot()
                    if got is not None:
                        pending = got
                    if pending is not None and pending[1] <= sent:
                        self._frame(conn, STATUS_STREAM, pending[0])
                        pending = None
        except (OSError, ConnectionError):
            dec.cancel(req)
            raise

    # ------------------------------------------------------ kv commands
    def _serve_kv_put(self, conn, payload):
        """Cmd 9: the snapshot preflight (``DecodeEngine.seed_check``):
        status 0 echoes the header as JSON, a refusal is status 2, a
        malformed block status 1."""
        dec = self._decode_engine
        if dec is None:
            self._answer(conn, STATUS_ERROR, b"no decode engine attached to this server")
            return
        try:
            header, _ = dec.seed_check(payload)
        except (RetryableError, EngineClosed) as e:
            self._answer(conn, STATUS_RETRYABLE, str(e).encode("utf-8", "replace"))
            return
        except Exception as e:  # noqa: BLE001 - malformed block
            self._answer(conn, STATUS_ERROR, str(e).encode("utf-8", "replace"))
            return
        self._answer(conn, STATUS_OK, json.dumps(header, sort_keys=True).encode())

    def _serve_kv_resume(self, conn, payload):
        """Cmd 10: resume a snapshot on the decode engine and reply as a
        streaming decode (the tokens after the snapshot), or one-shot (the
        whole sequence); a refusal is a status-2 terminal before any
        token."""
        dec = self._decode_engine
        if dec is None:
            self._answer(conn, STATUS_ERROR, b"no decode engine attached to this server")
            return
        t0 = time.perf_counter()
        try:
            header, _, budget, trace_id, opts, end = wire_spec.decode_kv_resume(payload)
        except Exception:  # noqa: BLE001 - malformed body
            self._answer(conn, STATUS_ERROR)
            return
        opts = opts or {}
        try:
            req = dec.resume(payload[:end], token_budget_s=budget, trace_id=trace_id,
                             snapshot_every=opts.get("snapshot_every"),
                             max_new_tokens=opts.get("max_new_tokens"),
                             speculative=bool(opts.get("speculative")))
        except (RetryableError, EngineClosed):
            self._answer(conn, STATUS_RETRYABLE)
            return
        except Exception:  # noqa: BLE001 - an inconsistent block
            self._answer(conn, STATUS_ERROR)
            return
        if opts.get("oneshot"):
            self._reply_whole(conn, dec, req, trace_id, t0)
        else:
            self._stream_tokens(conn, dec, req, trace_id, t0,
                                emit_snapshots=bool(opts.get("snapshot_every")),
                                sent=int(header["n_generated"]))

    def stop(self, drain=True, timeout=DRAIN_TIMEOUT):
        """Stop accepting, let requests mid-processing finish (up to
        ``timeout``), close idle connections, then close an owned engine.
        The server's metrics leave the registry."""
        self.begin_drain(timeout if drain else 0.0)
        self._stop.set()
        obs_metrics.REGISTRY.unregister_collector(self._obs_collector)
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        try:
            # shutdown before close: close() alone does not wake a thread
            # blocked in accept() on Linux
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        me = threading.current_thread()
        if drain:
            deadline = time.monotonic() + timeout
            with self._conns_lock:
                busy = [t for t, e in self._conns.items() if t is not me and e["busy"]]
            for t in busy:
                t.join(max(0.0, deadline - time.monotonic()))
        with self._conns_lock:
            leftover = [e["conn"] for t, e in self._conns.items() if t is not me]
        for c in leftover:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        self._thread.join(timeout)
        with self._backend_lock:
            engine = self._engine if self._own_engine else None
        if engine is not None:
            engine.close()
        if self._own_decode_engine:
            self._decode_engine.close()


def serve_model(path_prefix, port=0, dynamic_batching=False, max_batch_size=32,
                max_wait_ms=2.0, max_queue=256, warmup=True, metrics_port=None, quant=None,
                mesh=None, phase=None, slab_rows=None, device=None, mesh_devices=None,
                **engine_kwargs):
    """Load a ``jit.save``-ed model and serve it (the reference's
    ``serve_model``). With ``dynamic_batching=True`` (a batch-polymorphic
    save) all connections share one ``BatchingEngine.for_layer`` whose
    buckets are warmed up front; ``engine_kwargs`` pass to it.
    ``metrics_port`` also serves the Prometheus text on
    ``http://host:metrics_port/metrics``.

    ``quant`` (default: the environment's ``PADDLE_TPU_SERVING_QUANT``, read
    here once) declares the mode this replica must serve: the loaded save's
    recorded mode is checked at load and at every reload (cmd 4), so an f32
    save is refused where w8 is declared. ``mesh`` (default: the
    environment's ``PADDLE_TPU_SERVING_MESH``, read here once) declares the
    serving mesh (inference/sharding.py): a bad descriptor raises at entry;
    a save whose recorded mesh (``jit.save(mesh=)``) differs from the
    declared one raises, at load and at every reload, and the mesh resolved
    at the first load is pinned for every reload; a sharded mesh needs
    ``dynamic_batching`` and splits the weights over ``mesh_devices``
    (default ``cuda:0 .. cuda:n-1``; ``["cpu"] * n`` or ``["cuda:0"] * n``
    put every shard on one device) or the ranks of a launcher job of the
    mesh's size; its blocks are cut from a load on the host. ``phase`` ("prefill" |
    "decode" | "both", the default) declares the replica's pool in a
    disaggregated fleet, reported in health and stats; placement only.
    ``slab_rows``: the row count the
    program runs at (jit/save_load.py); ``device``: where it runs (default:
    the current place). The returned server answers cmd 4 (reload) and
    cmd 8 (drain)."""
    import os

    from ..core import place as place_mod
    from ..jit import load as jit_load
    from ..quantization.serving import check_mode
    from . import sharding

    if quant is None:
        quant = os.environ.get("PADDLE_TPU_SERVING_QUANT") or None
    if quant not in (None, "f32"):
        check_mode(quant)
    # parsed at entry: a typo'd mesh fails here, not as a save mismatch later
    declared_mesh = sharding.declared(mesh)
    # the mesh resolved at the first load, pinned for every reload
    pinned_mesh = {}
    if phase not in (None,) + wire_spec.REPLICA_PHASES:
        raise ValueError(f"unknown replica phase {phase!r} (expected one of "
                         f"{wire_spec.REPLICA_PHASES})")

    def loader(prefix):
        # one load on the host: a sharded mesh's blocks go from there to their
        # devices (the whole weights never sit on a card beside them), a
        # single mesh's weights go to ``device`` whole
        layer = jit_load(prefix, device="cpu", slab_rows=slab_rows)
        if quant is not None:
            have = getattr(layer, "_quant_mode", None) or "f32"
            if have != quant:
                raise ValueError(
                    f"{prefix}: saved quant mode {have!r} does not match the declared serving "
                    f"mode {quant!r} (PADDLE_TPU_SERVING_QUANT / serve_model(quant=)); re-save "
                    "with jit.save(..., quant=...) or fix the deployment knob")
        eff_mesh = sharding.serving_mesh(layer._serving_mesh,
                                         declared_mesh or pinned_mesh.get("desc"),
                                         where=f"{prefix}: ")
        pinned_mesh.setdefault("desc", eff_mesh)
        if eff_mesh != sharding.SINGLE and not dynamic_batching:
            raise ValueError(f"serving mesh {eff_mesh!r} needs the batching engine: pass "
                             "dynamic_batching=True to serve_model")
        if eff_mesh == sharding.SINGLE:
            layer.to_device(place_mod.resolve_device(device))

        engine = None
        if dynamic_batching:
            from .batching import BatchingEngine

            engine = BatchingEngine.for_layer(layer, max_batch_size=max_batch_size,
                                              max_wait_ms=max_wait_ms, max_queue=max_queue,
                                              mesh=eff_mesh, mesh_devices=mesh_devices,
                                              **engine_kwargs)
            # a sharded engine holds the weights as its mesh places them:
            # the direct path runs the engine's layer, not the whole one
            layer = engine._runner._layer

        def run(*arrays):
            out = layer(*arrays)
            return out if isinstance(out, (list, tuple)) else [out]

        return run, engine

    run, engine = loader(path_prefix)
    try:
        if engine is not None and warmup:
            engine.warmup()
        server = PredictorServer(run, port=port, engine=engine, own_engine=engine is not None,
                                 loader=loader, prefix=path_prefix, phase=phase)
    except BaseException:
        if engine is not None:
            engine.close()
        raise
    if metrics_port is not None:
        from ..obs.httpd import MetricsServer

        try:
            server.metrics_server = MetricsServer(metrics_port)
        except BaseException:
            server.stop(drain=False)
            raise
    return server
