"""Inference server (counterpart of paddle_tpu/inference/server.py):
serves a callable over the length-prefixed TCP wire protocol of
inference/wire_spec.py.

Commands served: 1 ``infer`` (one-shot; the 0xDD deadline field is
honoured, the trace and tenant fields are parsed and ignored), 3
``health``, 5 ``stats`` and 7 ``stop``. Statuses: 0 ok, 1 request error,
2 retryable (shed by the engine's bounded queue or an expired deadline),
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
slot frees at once. Bit 61 (speculative) is accepted and ignored, as the
reference ignores it without a draft model. Bit 62 (prefill handoff) and
a non-zero snapshot cadence (bits 32-47) answer status 1: kv snapshots
are not ported. Cmds 3 and 5 carry the engine's health and stats under
``"decode"``. Reload, drain, metrics and the kv commands answer status 1.
"""
import json
import socket
import struct
import threading
import time

import numpy as np

from . import wire_spec
from .batching import DeadlineExceeded, EngineClosed, RetryableError
from .wire_spec import (CMD_HEALTH, CMD_INFER, CMD_STATS, CMD_STOP, STATUS_ERROR,
                        STATUS_OK, STATUS_RETRYABLE, STATUS_STREAM, build_reply)

# a 4-byte length prefix from a broken client must not trigger an
# unbounded allocation, and a client that stalls mid-frame must not pin
# a handler thread forever
MAX_BODY_BYTES = 64 * 1024 * 1024
RECV_TIMEOUT = 30.0
DRAIN_TIMEOUT = 10.0
# the longest a decode stream waits for its next token
DECODE_STREAM_TIMEOUT = 300.0


class BodyTooLarge(ValueError):
    pass


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
    ``own_decode_engine=True`` closes it on stop."""

    def __init__(self, run_fn, port=0, host="127.0.0.1", max_body=MAX_BODY_BYTES,
                 recv_timeout=RECV_TIMEOUT, engine=None, own_engine=False,
                 decode_engine=None, own_decode_engine=False):
        self._run = run_fn
        self._engine = engine
        self._own_engine = own_engine and engine is not None
        self._decode_engine = decode_engine
        self._own_decode_engine = own_decode_engine and decode_engine is not None
        self._max_body = max_body
        self._recv_timeout = recv_timeout
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._conns = {}  # thread -> {"conn": socket, "busy": bool}
        self._conns_lock = threading.Lock()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(conn,), daemon=True)
            with self._conns_lock:
                self._conns[t] = {"conn": conn, "busy": False}
            t.start()

    def _set_busy(self, busy):
        with self._conns_lock:
            ent = self._conns.get(threading.current_thread())
            if ent is not None:
                ent["busy"] = busy

    def _stats_json(self):
        stats = {"engine": None} if self._engine is None else dict(self._engine.stats())
        if self._decode_engine is not None:
            stats["decode"] = self._decode_engine.stats()
        return json.dumps(stats)

    def _health_json(self):
        eng = self._engine.health() if self._engine is not None else None
        dec = self._decode_engine.health() if self._decode_engine is not None else None
        with self._conns_lock:
            conns = len(self._conns)
        stopping = self._stop.is_set()
        return json.dumps({
            "ok": (not stopping and (eng is None or eng["ok"])
                   and (dec is None or dec["ok"])),
            "accepting": not stopping,
            "connections": conns,
            "engine": eng,
            "decode": dec,
        })

    def _infer(self, inputs, budget):
        """One non-streaming cmd-1 request (already parsed); returns the
        encoded output arrays."""
        if budget is not None and budget <= 0.0:
            raise DeadlineExceeded("the client's budget was spent before the "
                                   "request arrived")
        deadline = None if budget is None else time.monotonic() + budget
        if self._engine is not None:
            outputs = self._engine.infer(inputs, deadline=deadline)
        else:
            outputs = self._run(*inputs)
            if not isinstance(outputs, (list, tuple)):
                outputs = [outputs]
            outputs = [o.detach().cpu().numpy() if hasattr(o, "detach") else o
                       for o in outputs]
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
                if cmd == CMD_STOP:
                    conn.sendall(build_reply(STATUS_OK))
                    threading.Thread(target=self.stop, daemon=True).start()
                    return
                if cmd == CMD_HEALTH:
                    conn.sendall(build_reply(STATUS_OK, self._health_json().encode()))
                elif cmd == CMD_STATS:
                    conn.sendall(build_reply(STATUS_OK, self._stats_json().encode()))
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
            conn.sendall(build_reply(STATUS_ERROR, b"malformed infer body"))
            return
        if decode_opts is not None:
            self._serve_decode(conn, inputs, budget, trace_id, decode_opts)
            return
        try:
            reply = build_reply(STATUS_OK, self._infer(inputs, budget))
        except (RetryableError, EngineClosed):
            # shed, expired deadline, or a request racing stop(): retryable
            reply = build_reply(STATUS_RETRYABLE)
        except Exception as e:  # noqa: BLE001 - the request's own error
            reply = build_reply(STATUS_ERROR, f"{type(e).__name__}: {e}".encode())
        conn.sendall(reply)

    # ------------------------------------------------- streaming decode
    def _serve_decode(self, conn, inputs, budget, trace_id, opts):
        """One cmd-1 decode request: submit it to the decode engine and
        reply as a chunk stream, or as one reply in one-shot mode."""
        dec = self._decode_engine
        if dec is None or not inputs:
            conn.sendall(build_reply(STATUS_ERROR, b"no decode engine attached to this server"))
            return
        if opts["handoff"] or opts["snapshot_every"]:
            conn.sendall(build_reply(STATUS_ERROR, b"kv snapshots and the prefill handoff "
                                     b"(0x5C bits 32-47, 62) are not ported"))
            return
        try:
            req = dec.submit(inputs[0], features=list(inputs[1:]),
                             max_new_tokens=opts["max_new_tokens"], token_budget_s=budget,
                             trace_id=trace_id, speculative=opts["speculative"])
        except (RetryableError, EngineClosed):
            conn.sendall(build_reply(STATUS_RETRYABLE))
            return
        except Exception:  # noqa: BLE001 - a bad request (shape, dtype, length)
            conn.sendall(build_reply(STATUS_ERROR))
            return
        if opts["oneshot"]:
            try:
                tokens = req.result(timeout=DECODE_STREAM_TIMEOUT)
            except (RetryableError, EngineClosed, TimeoutError):
                dec.cancel(req)
                conn.sendall(build_reply(STATUS_RETRYABLE))
                return
            except Exception:  # noqa: BLE001 - the request's own error
                dec.cancel(req)
                conn.sendall(build_reply(STATUS_ERROR))
                return
            conn.sendall(build_reply(STATUS_OK, wire_spec.encode_arrays([tokens])))
            return
        self._stream_tokens(conn, dec, req)

    def _stream_tokens(self, conn, dec, req):
        """Drain one decode request onto the wire: a status-3 frame per
        batch of new tokens, then one terminal frame. A reader that is gone
        (a failed send) cancels the request, so its slot frees now."""
        try:
            while True:
                try:
                    toks, done = req.next_tokens(timeout=DECODE_STREAM_TIMEOUT)
                except (RetryableError, EngineClosed, TimeoutError):
                    dec.cancel(req)
                    conn.sendall(build_reply(STATUS_RETRYABLE))
                    return
                except Exception:  # noqa: BLE001 - the request's own error
                    dec.cancel(req)
                    conn.sendall(build_reply(STATUS_ERROR))
                    return
                chunk = wire_spec.encode_arrays([np.asarray(toks, dtype=req.token_dtype)])
                if done:
                    conn.sendall(build_reply(STATUS_OK, chunk))
                    return
                conn.sendall(build_reply(STATUS_STREAM, chunk))
        except (OSError, ConnectionError):
            dec.cancel(req)
            raise

    def stop(self, drain=True, timeout=DRAIN_TIMEOUT):
        """Stop accepting, let requests mid-processing finish (up to
        ``timeout``), close idle connections, then close an owned engine."""
        self._stop.set()
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
        if self._own_engine:
            self._engine.close()
        if self._own_decode_engine:
            self._decode_engine.close()
