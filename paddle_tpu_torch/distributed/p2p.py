"""Cross-process eager point-to-point transport (counterpart of
paddle_tpu/distributed/p2p.py).

Reference: the eager ``send_v2``/``recv_v2`` collective ops
(paddle/fluid/operators/collective/send_v2_op.cc, recv_v2_op.cu.cc) move
tensors between ranks over NCCL P2P; the communicator id they need is
exchanged over a TCP side channel
(paddle/fluid/platform/gen_comm_id_helper.cc:286).

The JAX package ships tensors host-to-host over its own TCP transport,
the role the reference's TCP side channel + NCCL socket transport plays
for eager mode; the port keeps that transport as it is (``collective.
send``/``recv`` run over ``torch.distributed`` instead):

- each process lazily binds an ephemeral listener and publishes
  ``paddle_p2p/<rank> -> ip:port`` through the c10d store that
  ``init_parallel_env`` made (``parallel.store()``; the JAX package uses
  jax.distributed's key-value service); with no store (single process)
  the loopback address is used directly,
- ``send`` frames the array as ``[u32 meta_len | meta_json | raw bytes]``
  over a cached connection to the destination's listener; the payload is
  streamed in bounded chunks (PADDLE_P2P_CHUNK_BYTES, default 16 MiB)
  straight from the array buffer, so a multi-GB activation never incurs
  a second host copy, and oversized sends are refused up front
  (PADDLE_P2P_MAX_BYTES, default 4 GiB),
- the listener demuxes inbound messages into per-(axis, src, tag) FIFO
  queues; ``recv`` blocks on the matching queue,
- a send over a poisoned cached socket (peer restarted and republished a
  new ephemeral port, or a prior frame died mid-write) closes + evicts
  the cache entry, re-resolves the peer address through the KV store,
  and retries ONCE,
- delivery is exactly-once-or-loud: every frame carries the sender's
  transport rank and a per-(sender incarnation, dst) sequence number.
  The receiver delivers seq == last+1, silently drops duplicates
  (seq <= last: a retry whose original did arrive), and treats a FORWARD
  jump as proof that an earlier frame was lost with a dead connection —
  it then poisons that sender and raises from every affected ``recv``
  instead of silently pairing later tensors with earlier recv slots
  (the reference's NCCL comm-abort semantics). Each accepted connection
  starts with the receiver's 8-byte random epoch; a changed epoch on
  reconnect means the peer restarted, so the sender resets its sequence
  for that destination (the new incarnation's counter starts at 0).

Messages are matched by (axis, src, tag) like the reference's
(ring_id, peer) pairing, so interleaved streams on different group axes
— or two concurrent sends on the SAME edge carrying different tags — do
not cross. Same-edge same-tag sends rely on TCP FIFO ordering, exactly
the reference's same-ring ordering contract.
"""
import datetime
import json
import os
import socket
import struct
import threading

import numpy as np


__all__ = ["get_transport", "shutdown"]

_HEADER = struct.Struct("<I")
_RECV_TIMEOUT = float(os.environ.get("PADDLE_P2P_TIMEOUT", "120"))
_CHUNK_BYTES = int(os.environ.get("PADDLE_P2P_CHUNK_BYTES",
                                  str(16 * 1024 * 1024)))
_MAX_BYTES = int(os.environ.get("PADDLE_P2P_MAX_BYTES",
                                str(4 * 1024 * 1024 * 1024)))

_lock = threading.Lock()
_transport = None

# Lock order: the module singleton lock is outermost (get_transport/
# shutdown; shutdown closes the cache under it); inside the transport the
# outbound-cache lock orders before each queue's condition, and the
# routing lock before a queue's condition (gap delivery enqueues under it).


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("P2P peer closed the connection mid-message")
        buf.extend(chunk)
    return bytes(buf)


class _Queue:
    """FIFO with a condition variable (queue.Queue without the
    task-tracking we don't need)."""

    def __init__(self):
        self._items = []
        self._cv = threading.Condition()

    def put(self, item):
        with self._cv:
            self._items.append(item)
            self._cv.notify()

    def get(self, timeout):
        with self._cv:
            if not self._cv.wait_for(lambda: self._items, timeout):
                raise TimeoutError(
                    f"recv() timed out after {timeout:.0f}s waiting for a "
                    "matching send (set PADDLE_P2P_TIMEOUT to adjust)")
            return self._items.pop(0)


class _Gap:
    """Queue marker: a frame from ``srank`` was lost (sequence jump)."""

    def __init__(self, srank):
        self.srank = srank


class Transport:
    """One per process: a listener socket + per-(axis, src, tag) inbox
    queues + cached outbound connections."""

    def __init__(self, rank):
        self.rank = int(rank)
        self.epoch = os.urandom(8)  # this incarnation's id
        self._queues = {}
        self._queues_lock = threading.Lock()
        self._out = {}
        self._out_lock = threading.Lock()
        self._closed = False
        # sender-side sequence state (guarded by the per-entry lock +
        # _out_lock for the epoch-change reset in _conn_to)
        self._send_seq = {}    # dst -> next seq
        self._peer_epoch = {}  # dst -> epoch of current peer incarnation
        # receiver-side gap/duplicate tracking (guarded by _queues_lock)
        # keyed by sid = (srank, sender epoch): a RESTARTED sender is a
        # fresh stream whose counter starts over, not a duplicate
        self._last_seq = {}      # sid -> last contiguous seq delivered
        self._srank_queues = {}  # sid -> queue keys it has touched
        self._poisoned = set()   # sids with a detected lost frame

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("0.0.0.0", 0))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self.addr = f"{self._my_host()}:{self.port}"

        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"paddle-p2p-accept-r{self.rank}")
        self._accept_thread.start()
        self._publish()

    # ---------------------------------------------------- address book

    @staticmethod
    def _my_host():
        ep = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        host = ep.rsplit(":", 1)[0] if ":" in ep else ""
        if host:
            return host
        # no launcher env: publishing loopback to a multi-host cluster
        # would send peers to their OWN machine, so derive a routable
        # address (the UDP connect never transmits; it just picks the
        # outbound interface). Single-host keeps loopback.
        coord = os.environ.get("PADDLE_COORDINATOR", "")
        if coord and not coord.startswith(("127.", "localhost")):
            try:
                probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                probe.connect((coord.rsplit(":", 1)[0], 80))
                host = probe.getsockname()[0]
                probe.close()
                return host
            except OSError:
                pass
        return "127.0.0.1"

    @staticmethod
    def _kv_client():
        from . import parallel

        return parallel.store()

    def _publish(self):
        client = self._kv_client()
        if client is not None:
            client.set(f"paddle_p2p/{self.rank}", self.addr)

    def _peer_addr(self, dst):
        if dst == self.rank:
            return f"127.0.0.1:{self.port}"
        client = self._kv_client()
        if client is None:
            raise RuntimeError(
                f"eager send/recv with peer rank {dst} needs the "
                "job's c10d store for address exchange — call "
                "init_parallel_env() first (single-process runs can only "
                "self-send)")
        key = f"paddle_p2p/{dst}"
        client.wait([key], datetime.timedelta(seconds=_RECV_TIMEOUT))
        return client.get(key).decode()

    # ---------------------------------------------------- inbound

    def _queue_for(self, axis, src, tag):
        with self._queues_lock:
            return self._queues.setdefault((axis, int(src), int(tag)),
                                           _Queue())

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True).start()

    def _conn_loop(self, conn):
        try:
            with conn:
                conn.sendall(self.epoch)  # incarnation handshake
                while True:
                    meta_len = _HEADER.unpack(_recv_exact(conn, 4))[0]
                    if meta_len > 1 << 20:
                        # meta is a short JSON blob; a huge header length
                        # is corruption — never allocate from it
                        raise ConnectionError(
                            f"P2P meta length {meta_len} exceeds 1MB")
                    meta = json.loads(_recv_exact(conn, meta_len))
                    # inbound guard: the listener is unauthenticated, so
                    # never allocate from unvalidated wire meta. Python
                    # ints (no overflow) + non-negative dims + cap; any
                    # junk surfaces as the loud ConnectionError, not an
                    # unhandled thread death.
                    try:
                        nbytes = int(meta["nbytes"])
                        shape = [int(d) for d in meta["shape"]]
                        dtype = np.dtype(meta["dtype"])
                        # routing fields too: junk must surface as the
                        # loud ConnectionError, not kill the thread in
                        # _deliver with a KeyError/TypeError
                        if not isinstance(meta["axis"], str):
                            raise ValueError(
                                f"axis must be str, got {meta['axis']!r}")
                        meta["src"] = int(meta["src"])
                        meta["tag"] = int(meta.get("tag", 0))
                        if meta.get("seq") is not None:
                            meta["seq"] = int(meta["seq"])
                        if meta.get("srank") is not None:
                            meta["srank"] = int(meta["srank"])
                    except Exception as e:  # noqa: BLE001
                        raise ConnectionError(
                            f"P2P frame meta unparseable: {e}")
                    want = dtype.itemsize
                    for d in shape:
                        if d < 0:
                            raise ConnectionError(
                                f"P2P frame meta invalid: dim {d} < 0")
                        want *= d
                    if nbytes != want or not 0 <= nbytes <= _MAX_BYTES:
                        raise ConnectionError(
                            f"P2P frame meta invalid (nbytes={nbytes}, "
                            f"shape/dtype want {want}, cap {_MAX_BYTES})")
                    # single-copy receive: allocate the array up front
                    # and recv_into its buffer (a bytes staging copy
                    # would triple peak RSS on multi-GB activations) —
                    # from the VALIDATED locals, not the raw meta
                    arr = np.empty(shape, dtype)
                    view = memoryview(arr).cast("B")
                    got, total = 0, nbytes
                    while got < total:
                        n = conn.recv_into(view[got:], total - got)
                        if not n:
                            raise ConnectionError(
                                "P2P peer closed the connection "
                                "mid-message")
                        got += n
                    self._deliver(meta, arr)
        except (ConnectionError, OSError):
            return

    def _deliver(self, meta, arr):
        """Sequence-checked delivery (see module docstring): in-order
        frames deliver, duplicates drop, a forward jump poisons the
        sender and surfaces as an error on every affected recv."""
        key = (meta["axis"], int(meta["src"]), int(meta.get("tag", 0)))
        srank, seq = meta.get("srank"), meta.get("seq")
        if srank is None or seq is None:
            self._queue_for(*key).put(arr)
            return
        sid = (srank, meta.get("sepoch"))
        with self._queues_lock:
            q = self._queues.setdefault(key, _Queue())
            if sid in self._poisoned:
                q.put(_Gap(srank))
                return
            last = self._last_seq.get(sid, -1)
            if seq <= last:
                return  # duplicate of a delivered retry
            touched = self._srank_queues.setdefault(sid, set())
            touched.add(key)
            if seq == last + 1:
                self._last_seq[sid] = seq
                q.put(arr)
                return
            # forward jump: an earlier frame died with its connection
            self._poisoned.add(sid)
            for k in touched:
                self._queues.setdefault(k, _Queue()).put(_Gap(srank))

    # ---------------------------------------------------- outbound

    def _conn_to(self, dst):
        """Cached (socket, per-destination lock). The KV lookup and TCP
        connect (each up to PADDLE_P2P_TIMEOUT) happen OUTSIDE the
        global dict lock — a dead peer must not stall sends to healthy
        peers; frame atomicity needs only the one socket locked."""
        with self._out_lock:
            entry = self._out.get(dst)
        if entry is not None:
            return entry
        host, port = self._peer_addr(dst).rsplit(":", 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=_RECV_TIMEOUT)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        peer_epoch = _recv_exact(sock, 8)  # incarnation handshake
        entry = (sock, threading.Lock())
        with self._out_lock:
            raced = self._out.get(dst)
            if raced is not None:
                sock.close()
                return raced
            if self._peer_epoch.get(dst) != peer_epoch:
                # new peer incarnation: its receive-side sequence state
                # is fresh, so this destination's counter restarts
                self._peer_epoch[dst] = peer_epoch
                self._send_seq[dst] = 0
            self._out[dst] = entry
        return entry

    def _evict(self, dst, entry):
        with self._out_lock:
            if self._out.get(dst) is entry:
                del self._out[dst]
        try:
            entry[0].close()
        except OSError:
            pass

    def send(self, axis, dst, array, src_tag=None, tag=0):
        """Ship one array to trainer ``dst``; ``src_tag`` is the value
        the receiver matches on (group-relative rank; defaults to this
        process's trainer rank). ``tag`` disambiguates concurrent sends
        on the same (axis, src, dst) edge."""
        array = np.ascontiguousarray(array)
        if array.nbytes > _MAX_BYTES:
            raise ValueError(
                f"P2P send of {array.nbytes} bytes exceeds the "
                f"{_MAX_BYTES}-byte limit (PADDLE_P2P_MAX_BYTES); shard "
                "the tensor or raise the limit")
        base_meta = {
            "axis": axis,
            "src": self.rank if src_tag is None else int(src_tag),
            "tag": int(tag), "srank": self.rank,
            "sepoch": self.epoch.hex(),
            "dtype": array.dtype.name, "shape": list(array.shape),
            "nbytes": array.nbytes,
        }
        view = memoryview(array).cast("B")
        dst = int(dst)
        for attempt in (0, 1):
            entry = self._conn_to(dst)
            sock, lock = entry
            try:
                with lock:
                    # seq allocated under the socket lock so the frame
                    # order on the wire matches the counter; a reconnect
                    # to a restarted peer resets it (_conn_to)
                    seq = self._send_seq.get(dst, 0)
                    meta = json.dumps(dict(base_meta, seq=seq)).encode()
                    sock.sendall(_HEADER.pack(len(meta)) + meta)
                    for off in range(0, len(view), _CHUNK_BYTES):
                        sock.sendall(view[off:off + _CHUNK_BYTES])
                    self._send_seq[dst] = seq + 1
                return
            except OSError:
                # poisoned cached socket (peer restarted / frame died
                # mid-write): evict, re-resolve the address, retry once.
                # The receiver's sequence check keeps this safe: a
                # duplicate is dropped, a frame lost with the old
                # connection surfaces as a loud gap error on recv.
                self._evict(dst, entry)
                if attempt:
                    raise

    def recv(self, axis, src, timeout=None, tag=0):
        q = self._queue_for(axis, src, tag)
        item = q.get(timeout or _RECV_TIMEOUT)
        if isinstance(item, _Gap):
            q.put(item)  # keep the stream poisoned for later recvs
            raise ConnectionError(
                f"a P2P frame from trainer {item.srank} was lost with a "
                "dead connection (sequence gap); the stream cannot be "
                "trusted — re-establish it at the application level")
        return item

    def close(self):
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._out_lock:
            for sock, _ in self._out.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._out.clear()


def get_transport():
    """The process-wide transport, created on first use."""
    global _transport
    with _lock:
        if _transport is None:
            rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
            _transport = Transport(rank)
        return _transport


def shutdown():
    global _transport
    with _lock:
        if _transport is not None:
            _transport.close()
            _transport = None
