"""Crash-safe, content-addressed artifact store (counterpart of
paddle_tpu/serialize/artifact_store.py, ported whole).

A replica publishes a payload under a key that names everything the
payload depends on, and any later process (a restarted replica, a
scaled-out fleet) loads it back instead of recomputing it. In the
reference the payloads are each bucket's compiled XLA program; in the
port the store's user is the decode engine's persistent prefix tier
(inference/prefix_cache.py), whose payloads are kv-snapshot blocks of a
prefix's KV rows. The port's programs are CUDA graphs, which have no
serialized form across processes, and a loaded model is already one
``torch.export`` program, so the engines' ``store=`` is not ported
(ROADMAP Queue 3 (b)). The store itself is framework-neutral but for
``serialize.export.runtime_version``, and its files are the
reference's: either package reads what the other publishes.

A shared on-disk cache is only a win if a bad artifact can **never**
take a replica down, so every failure path degrades to recomputing
(exactly what a replica with no store would do):

    failure mode                    behaviour
    ------------------------------  ---------------------------------
    artifact absent                 miss -> recompute + publish
    bit-flipped / truncated payload sha256 verify fails -> quarantine
                                    (counter, never retried in-process,
                                    dir GC'd) -> recompute
    torn publish (writer SIGKILL'd) never visible: publish is tmp-dir
                                    + os.replace; stale tmp GC'd
    version-skewed runtime          different key -> clean miss
    wrong-keyed / copied dir        manifest key check fails ->
                                    quarantine -> recompute
    undeserializable payload        caller quarantines via
                                    ``quarantine()`` -> recompute
    store dir unwritable            put() returns False (counter),
                                    serving continues store-less
    peer computing same key         single-flight: wait for its
                                    publish (warmup) or compute inline
                                    without publishing (hot path)
    peer died holding the lock      staleness takeover (dead pid or
                                    age > stale_s; counter)

Key schema (``ArtifactKey`` -> sha256 digest -> ``art-<digest>/``)::

    model      the model's identity (the reference: sha256 of the saved
               module's bytes; the prefix tier: the decode model's
               fingerprint)
    bucket     batch rows the program was compiled for (the prefix
               tier: the prefix's pages)
    signature  ((dtype, trailing shape), ...) of the inputs
    mesh       device-mesh identity ("single" for one-card serving)
    version    the runtime triple (serialize.export.runtime_version) —
               artifacts never cross runtimes
    quant      serving quantization mode ("f32" default, omitted from
               the canonical form so historical digests are stable;
               "w8" / "w8a8" / "bf16w")

On-disk layout (the reference's, names included, so the two packages
share a store)::

    <root>/
      art-<digest>/
        MANIFEST.json        {"format":1,"key":{...},"sha256":...,
                              "size":N,"ts":...}
        program.jaxexport    the payload bytes
      .tmp-<digest>-<pid>-<n>/   in-flight publish; never read
      .lock-<digest>             O_EXCL single-flight compile lock

Concurrency: multi-process safe by construction (atomic renames, O_EXCL
locks); in-process the only shared mutable state is the quarantine set,
guarded by one leaf lock that nothing blocking runs under. The
single-flight wait loop sleeps OUTSIDE any lock.

The port reads no environment: the reference's knobs are arguments with
the reference's defaults (``PADDLE_TPU_ARTIFACT_MAX_BYTES`` ->
``max_bytes`` 2 GiB, ``_MAX_COUNT`` -> ``max_count`` 512, ``_STALE_S``
-> ``stale_s`` 600 s, the ``_DISABLE`` kill switch -> ``disabled``, and
``_DIR`` -> ``default_store(root)``).

Chaos sites: ``artifact.get``, ``artifact.verify``, ``artifact.put``,
``artifact.put.publish`` (between payload write and the os.replace —
SIGKILL here models a torn publish).
"""
import hashlib
import json
import os
import shutil
import socket
import time
import threading
import warnings

from ..obs import metrics as _obs
from ..resilience import chaos
from ..resilience.checkpoint import _fsync_dir
from .export import runtime_version

FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
PAYLOAD_NAME = "program.jaxexport"

_HITS = _obs.counter(
    "paddle_artifact_hits_total",
    "Artifact-store loads that verified and were served")
_MISSES = _obs.counter(
    "paddle_artifact_misses_total",
    "Artifact-store lookups that found nothing usable")
_CORRUPT = _obs.counter(
    "paddle_artifact_corrupt_total",
    "Artifacts that failed verification and were quarantined")
_TAKEOVERS = _obs.counter(
    "paddle_artifact_takeovers_total",
    "Stale single-flight locks taken over from a dead/wedged peer")
_PUBLISHES = _obs.counter(
    "paddle_artifact_publishes_total", "Artifacts published")
_PUT_ERRORS = _obs.counter(
    "paddle_artifact_put_errors_total",
    "Failed publishes (swallowed: a bad store never fails serving)")
_GET_SECONDS = _obs.histogram(
    "paddle_artifact_get_seconds",
    "Store lookup latency by outcome (hit | miss)",
    labelnames=("outcome",),
    buckets=_obs.log_buckets(0.0001, 4.0, 10))
_PUT_SECONDS = _obs.histogram(
    "paddle_artifact_put_seconds", "Store publish latency",
    buckets=_obs.log_buckets(0.0001, 4.0, 10))


def default_store(root=None, disabled=False):
    """The store at ``root``, or None (no root, or ``disabled``: the
    reference's kill switch). A root that cannot be made a store warns
    and gives None: a bad store must not break startup."""
    if disabled or not root:
        return None
    try:
        return ArtifactStore(root)
    except Exception as e:  # noqa: BLE001 - a bad store must not break startup
        warnings.warn(f"artifact store at {root!r} unusable ({e}); "
                      "serving continues without it")
        return None


class ArtifactKey:
    """Everything a compiled program's identity depends on. Weights are
    runtime arguments, so they are deliberately NOT part of the key —
    a re-save of the same architecture with new weights reuses the
    same artifacts.

    ``quant`` names the serving quantization mode the program was
    exported under (``"f32"`` default; ``"w8"`` / ``"w8a8"`` /
    ``"bf16w"``). The model fingerprint already folds the mode in
    (serialize.export.model_fingerprint), but the key carries it
    EXPLICITLY as well: a quant-mode skew is a clean miss by key
    construction — a w8 artifact can never be served to an f32 request
    even if the fingerprints were ever to collide — and the manifest's
    recorded key makes the mode auditable on disk. ``"f32"`` is
    omitted from the canonical form so every pre-quantization digest
    (and on-disk manifest) stays byte-identical."""

    __slots__ = ("model", "bucket", "signature", "mesh", "version",
                 "quant")

    def __init__(self, model, bucket, signature, mesh="single",
                 version=None, quant=None):
        self.model = str(model)
        self.bucket = int(bucket)
        # normalize to ((dtype_str, (trailing...)), ...) so logically
        # equal signatures always digest identically
        self.signature = tuple((str(dt), tuple(int(d) for d in tr))
                               for dt, tr in signature)
        self.mesh = str(mesh)
        self.version = runtime_version() if version is None else str(version)
        self.quant = "f32" if quant in (None, "f32") else str(quant)

    def canonical(self):
        """JSON-able identity — what the digest hashes and what the
        manifest records for self-verification."""
        c = {"model": self.model, "bucket": self.bucket,
             "signature": [[dt, list(tr)] for dt, tr in self.signature],
             "mesh": self.mesh, "version": self.version}
        if self.quant != "f32":
            c["quant"] = self.quant
        return c

    def digest(self):
        blob = json.dumps(self.canonical(), sort_keys=True)
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:32]

    def __repr__(self):
        return (f"ArtifactKey(model={self.model[:12]}..., "
                f"bucket={self.bucket}, mesh={self.mesh})")


class _FlightLock:
    """A held single-flight lock: the lockfile path plus the token that
    proves ownership (release only unlinks a lock that still carries
    our token, so a stale-lock takeover victim that resurrects cannot
    delete the taker's lock)."""

    __slots__ = ("digest", "path", "token")

    def __init__(self, digest, path, token):
        self.digest = digest
        self.path = path
        self.token = token


class ArtifactStore:
    """Atomic publish / verified load / single-flight / retention GC
    over one directory (multi-process shared; typically a persistent
    volume all replicas mount)."""

    def __init__(self, root, max_bytes=None, max_count=None,
                 stale_s=None, poll_interval=0.05, gc_grace_s=None,
                 disabled=False):
        self.root = os.path.abspath(root)
        self.max_bytes = int(2 * 1024 ** 3 if max_bytes is None
                             else max_bytes)
        self.max_count = int(512 if max_count is None else max_count)
        self.stale_s = float(600.0 if stale_s is None else stale_s)
        # the kill switch: put() publishes nothing and its users treat
        # the store as absent (the reference's PADDLE_TPU_ARTIFACT_DISABLE)
        self.disabled = bool(disabled)
        self.poll_interval = float(poll_interval)
        # retention never evicts an artifact younger than this: a
        # just-published program is exactly what warming peers are
        # about to read, and a budget filled with locked (mid-publish)
        # entries must not force the NEWEST artifact out — running
        # temporarily over budget is the lesser harm
        self.gc_grace_s = float(min(60.0, self.stale_s)
                                if gc_grace_s is None else gc_grace_s)
        self._host = socket.gethostname()
        self._lock = threading.Lock()  # leaf: guards the mutable dicts only
        self._quarantined = {}  # digest -> reason (never retried in-process)
        self._seq = 0
        # per-INSTANCE counters for stats()/health: the module-level obs
        # instruments are process-global (right for the exposition), but
        # a health block claiming to describe THIS store must not sum in
        # another store's traffic (two served models, or the old+new
        # engine pair during a hot-reload window)
        self._local = {"hits": 0, "misses": 0, "corrupt": 0,
                       "takeovers": 0, "publishes": 0, "put_errors": 0}
        # stats() caches its directory walk: health probes poll, and a
        # full per-artifact listdir+getsize against a shared volume on
        # every poll is pure metadata load. Local mutations invalidate;
        # cross-process changes surface within stats_ttl_s.
        self.stats_ttl_s = 5.0
        self._entries_cache = (0.0, None)
        os.makedirs(self.root, exist_ok=True)

    def _bump(self, name):
        with self._lock:
            self._local[name] += 1

    def _invalidate_entries_cache(self):
        with self._lock:
            self._entries_cache = (0.0, None)

    # --------------------------------------------------------------- paths
    def _final(self, digest):
        return os.path.join(self.root, f"art-{digest}")

    def _lockfile(self, digest):
        return os.path.join(self.root, f".lock-{digest}")

    def _next_tmp(self, digest):
        with self._lock:
            self._seq += 1
            seq = self._seq
        return os.path.join(self.root,
                            f".tmp-{digest}-{os.getpid()}-{seq}")

    # ----------------------------------------------------------------- get
    def get(self, key):
        """Verified payload bytes for `key`, or None (absent, corrupt,
        or quarantined — the caller compiles inline either way). A
        corrupt artifact is quarantined: counted, deleted, and never
        retried by this process. NEVER raises: an I/O blow-up reading
        the store (chaos-tested via the ``artifact.get`` site) is a
        miss, not a serving failure."""
        t0 = time.perf_counter()
        try:
            payload = self._read_verified(key)
        except Exception as e:  # noqa: BLE001 - a broken store = a miss
            warnings.warn(f"artifact store read failed ({e}); "
                          "treating as a miss")
            payload = None
        outcome = "miss" if payload is None else "hit"
        (_MISSES if payload is None else _HITS).inc()
        self._bump("misses" if payload is None else "hits")
        _GET_SECONDS.observe(time.perf_counter() - t0, outcome=outcome)
        return payload

    def _read_verified(self, key):
        """get() without the counters (the single-flight wait loop
        polls this; its final outcome is counted once by the caller).
        Corruption is ALWAYS counted + quarantined — that is real
        signal, not polling noise. The chaos site lives here so
        injected read failures cover BOTH the direct get() path and
        the single-flight wait loop (each degrades independently)."""
        chaos.hit("artifact.get")
        digest = key.digest()
        with self._lock:
            if digest in self._quarantined:
                return None
        final = self._final(digest)
        manifest_path = os.path.join(final, MANIFEST_NAME)
        if not os.path.isfile(manifest_path):
            return None
        try:
            payload = self._verify(key, final)
        except OSError as e:
            # A read error is NOT corruption: a shared-volume hiccup
            # (ESTALE/EIO) or a peer's concurrent evict must never
            # make one replica destroy a possibly-good artifact for
            # the whole fleet — that's a miss. The one structural
            # exception: the manifest is still there but the payload
            # is not, a state no store operation can produce (publish
            # and evict are whole-dir-atomic), so it IS corruption.
            if (isinstance(e, FileNotFoundError)
                    and os.path.isfile(manifest_path)
                    and not os.path.isfile(
                        os.path.join(final, PAYLOAD_NAME))):
                self.quarantine(key, f"payload file missing: {e}")
            return None
        except Exception as e:  # noqa: BLE001 - any bad artifact degrades
            self.quarantine(key, str(e))
            return None
        try:
            # LRU signal for retention GC (never load-bearing)
            os.utime(final)
        except OSError:
            pass
        return payload

    def _verify(self, key, final):
        """Manifest + payload verification; returns the payload bytes
        or raises. Everything get() trusts is checked here: manifest
        format, the full key (a renamed/copied dir fails even though
        its digest directory matched), payload size and sha256."""
        chaos.hit("artifact.verify")
        with open(os.path.join(final, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT_VERSION:
            raise ValueError(
                f"unknown manifest format {manifest.get('format')!r}")
        if manifest.get("key") != key.canonical():
            raise ValueError("manifest key mismatch (wrong-keyed or "
                             "copied artifact dir)")
        with open(os.path.join(final, PAYLOAD_NAME), "rb") as f:
            payload = f.read()
        if len(payload) != int(manifest.get("size", -1)):
            raise ValueError(
                f"payload size {len(payload)} != manifest "
                f"{manifest.get('size')}")
        sha = hashlib.sha256(payload).hexdigest()
        if sha != manifest.get("sha256"):
            raise ValueError("payload sha256 mismatch (bit rot or torn "
                             "write)")
        return payload

    # ---------------------------------------------------------- quarantine
    def quarantine(self, key, reason):
        """Mark `key` bad: counted, never retried in-process, and its
        directory removed (atomically renamed aside first, so a
        concurrent reader sees the artifact or nothing — never half a
        deletion). Callers use this for failures the store itself
        cannot see, e.g. a payload that verified byte-wise but does
        not deserialize under this runtime."""
        digest = key.digest()
        with self._lock:
            already = digest in self._quarantined
            self._quarantined[digest] = str(reason)
        if already:
            return
        _CORRUPT.inc()
        self._bump("corrupt")
        warnings.warn(
            f"artifact {digest} quarantined ({reason}); degrading to "
            "inline compile")
        final = self._final(digest)
        aside = os.path.join(self.root,
                             f".bad-{digest}-{os.getpid()}")
        try:
            os.replace(final, aside)
        except OSError:
            return  # already gone (another process quarantined it)
        shutil.rmtree(aside, ignore_errors=True)

    def is_quarantined(self, key):
        with self._lock:
            return key.digest() in self._quarantined

    # ----------------------------------------------------------------- put
    def put(self, key, payload):
        """Publish atomically. Returns True when the artifact is live
        (published by us or already present), False on any failure —
        put NEVER raises: a broken store degrades serving to
        compile-only, it does not take the replica down."""
        t0 = time.perf_counter()
        try:
            chaos.hit("artifact.put")
            if self.disabled:
                return False
            outcome = self._put_raising(key, bytes(payload))
        except Exception as e:  # noqa: BLE001 - publish is best-effort
            _PUT_ERRORS.inc()
            self._bump("put_errors")
            warnings.warn(f"artifact publish failed ({e}); serving "
                          "continues without it")
            return False
        if outcome == "wrote":
            # counted only when WE materialized the artifact — "a peer
            # beat us to it" must not inflate the publish metric, or it
            # could no longer witness the one-publish-per-key contract
            _PUBLISHES.inc()
            self._bump("publishes")
            _PUT_SECONDS.observe(time.perf_counter() - t0)
            self._invalidate_entries_cache()
        return bool(outcome)

    # Staging-dir lifecycle: every tmp dir comes from _tmp_create and
    # ends in exactly one _tmp_done (publish moves it aside first, so
    # the rmtree is then a no-op on the corpse name).
    def _tmp_create(self, digest):
        """Create one private staging dir (the tmp half of the
        write-then-rename publish); the owner must _tmp_done() it on
        every path, or gc() only reclaims it by age."""
        os.makedirs(self.root, exist_ok=True)
        tmp = self._next_tmp(digest)
        os.makedirs(tmp)
        return tmp

    def _tmp_done(self, tmp):
        """Retire a staging dir, published or abandoned."""
        shutil.rmtree(tmp, ignore_errors=True)

    def _put_raising(self, key, payload):
        """-> "wrote" (we published it) | "present" (a peer already
        had) — both truthy "the artifact is live" outcomes."""
        digest = key.digest()
        final = self._final(digest)
        if os.path.isdir(final):
            return "present"  # content-addressed: a peer already published
        tmp = self._tmp_create(digest)
        try:
            with open(os.path.join(tmp, PAYLOAD_NAME), "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            manifest = {"format": FORMAT_VERSION,
                        "key": key.canonical(),
                        "sha256": hashlib.sha256(payload).hexdigest(),
                        "size": len(payload),
                        "ts": time.time()}
            with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                json.dump(manifest, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            # SIGKILL between here and the replace = a torn publish:
            # the final dir never appears, the tmp dir is GC'd by age
            chaos.hit("artifact.put.publish")
            try:
                os.replace(tmp, final)
            except OSError:
                if os.path.isdir(final):
                    return "present"  # lost the publish race: it exists
                raise
        finally:
            self._tmp_done(tmp)
        _fsync_dir(self.root)
        self.gc()
        return "wrote"

    # -------------------------------------------------------- single-flight
    def try_acquire(self, key):
        """Non-blocking single-flight claim for compiling `key`.
        Returns a _FlightLock when this caller owns the compile+publish
        (release() it when done), None when a peer holds it — the hot
        path then compiles inline WITHOUT publishing (never waits on a
        peer while live traffic is parked)."""
        digest = key.digest()
        path = self._lockfile(digest)
        token = f"{self._host}:{os.getpid()}:{time.monotonic_ns()}"
        body = json.dumps({"pid": os.getpid(), "host": self._host,
                           "ts": time.time(), "token": token})
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return None
        except OSError:
            return None  # unwritable store: behave as "peer holds it"
        try:
            os.write(fd, body.encode("utf-8"))
            os.fsync(fd)
        except OSError:
            # a bodyless lock is indistinguishable from a crashed
            # writer's corpse: peers would declare it stale within
            # seconds and take it over mid-compile, silently breaking
            # the one-compile-per-bucket contract exactly when the
            # store disk is degraded. Better to hold no lock at all
            # (compile inline, skip publishing).
            os.close(fd)
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        os.close(fd)
        return _FlightLock(digest, path, token)

    def release(self, lock):
        """Drop a held lock. Only unlinks the file if it still carries
        our token — a takeover may have replaced it."""
        if lock is None:
            return
        try:
            with open(lock.path) as f:
                body = json.load(f)
            if body.get("token") != lock.token:
                return
        except (OSError, json.JSONDecodeError):
            return
        try:
            os.unlink(lock.path)
        except OSError:
            pass

    def _lock_stale(self, path):
        """Is the lock at `path` held by a dead or wedged peer? Same-
        host dead pids are stale immediately (the SIGKILL-mid-publish
        case resolves in one poll); otherwise age decides."""
        try:
            st = os.stat(path)
            with open(path) as f:
                body = json.load(f)
        except (OSError, json.JSONDecodeError):
            # vanished (owner released: not stale) or unreadable
            # garbage (torn lock write: stale once old enough)
            try:
                st = os.stat(path)
            except OSError:
                return False
            return time.time() - st.st_mtime > max(5.0, self.poll_interval)
        if body.get("host") == self._host:
            pid = body.get("pid")
            if isinstance(pid, int):
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    return True  # owner is gone
                except OSError:
                    pass  # EPERM etc: assume alive
        age = time.time() - max(float(body.get("ts", 0.0)), st.st_mtime)
        return age > self.stale_s

    def _takeover(self, path):
        """Atomically remove a stale lock. The rename arbitrates:
        exactly one of N racing takers wins; losers just retry the
        acquire loop."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        dead = f"{path}.dead-{os.getpid()}-{seq}"
        try:
            os.rename(path, dead)
        except OSError:
            return False
        try:
            os.unlink(dead)
        except OSError:
            pass
        _TAKEOVERS.inc()
        self._bump("takeovers")
        return True

    def acquire_or_wait(self, key, timeout=None):
        """Blocking single-flight for warmup: either WE own the compile
        (-> (lock, None)), or a peer published while we waited
        (-> (None, payload)), or the wait timed out (-> (None, None):
        compile inline, skip publishing — never wedge a warmup).

        A peer that dies holding the lock is taken over (counted) via
        pid-liveness on this host or the staleness horizon across
        hosts, so one SIGKILL'd replica never wedges the fleet.
        NEVER raises: any store blow-up resolves to (None, None) — the
        caller compiles inline, exactly as with no store."""
        try:
            return self._acquire_or_wait(key, timeout)
        except Exception as e:  # noqa: BLE001 - degrade to inline
            warnings.warn(f"artifact single-flight failed ({e}); "
                          "compiling inline without publish")
            return None, None

    def _acquire_or_wait(self, key, timeout):
        # timeout=0 means "try once, never park"; only timeout=None
        # waits indefinitely
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        counted_t0 = time.perf_counter()
        while True:
            lock = self.try_acquire(key)
            if lock is not None:
                # between our miss and the acquire a peer may have
                # published and released: serve that instead of
                # recompiling. A read blow-up here must not leak the
                # just-acquired lock (peers would stall until the
                # staleness horizon).
                try:
                    payload = self._read_verified(key)
                except Exception:
                    self.release(lock)
                    raise
                if payload is not None:
                    self.release(lock)
                    _HITS.inc()
                    self._bump("hits")
                    _GET_SECONDS.observe(time.perf_counter() - counted_t0,
                                         outcome="hit")
                    return None, payload
                return lock, None
            payload = self._read_verified(key)
            if payload is not None:
                _HITS.inc()
                self._bump("hits")
                _GET_SECONDS.observe(time.perf_counter() - counted_t0,
                                     outcome="hit")
                return None, payload
            lp = self._lockfile(key.digest())
            if os.path.exists(lp) and self._lock_stale(lp):
                self._takeover(lp)
                continue  # retry the acquire immediately
            if deadline is not None and time.monotonic() >= deadline:
                _MISSES.inc()
                self._bump("misses")
                _GET_SECONDS.observe(time.perf_counter() - counted_t0,
                                     outcome="miss")
                return None, None
            time.sleep(self.poll_interval)

    # ------------------------------------------------------------------ gc
    def _entries(self):
        """[(mtime, bytes, digest, path)] for every published artifact."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for n in names:
            if not n.startswith("art-"):
                continue
            full = os.path.join(self.root, n)
            try:
                size = sum(
                    os.path.getsize(os.path.join(full, fn))
                    for fn in os.listdir(full))
                out.append((os.path.getmtime(full), size, n[4:], full))
            except OSError:
                continue  # vanished mid-scan (concurrent GC/quarantine)
        return out

    def gc(self):
        """Retention: evict oldest artifacts past the count/byte
        budgets, plus crashed publishers' stale leftovers. Never
        raises; never touches an artifact whose single-flight lock is
        live (a peer is mid-publish on it), never touches a FRESH tmp
        dir (an in-flight write)."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        now = time.time()
        for n in names:
            full = os.path.join(self.root, n)
            if n.startswith(".bad-") or n.startswith(".evict-"):
                shutil.rmtree(full, ignore_errors=True)
            elif n.startswith(".tmp-"):
                try:
                    if now - os.path.getmtime(full) > self.stale_s:
                        shutil.rmtree(full, ignore_errors=True)
                except OSError:
                    pass
            elif n.startswith(".lock-") and ".dead-" in n:
                # a takeover that crashed between its rename and unlink
                # left this corpse; by construction nothing reads it
                try:
                    os.unlink(full)
                except OSError:
                    pass
            elif n.startswith(".lock-"):
                if self._lock_stale(full):
                    self._takeover(full)
        entries = sorted(self._entries())  # oldest first
        total = sum(e[1] for e in entries)
        count = len(entries)
        for mtime, size, digest, path in entries:
            over = ((self.max_count > 0 and count > self.max_count)
                    or (self.max_bytes > 0 and total > self.max_bytes))
            if not over:
                break
            if now - mtime < self.gc_grace_s:
                continue  # fresh publish: warming peers read it next
            lp = self._lockfile(digest)
            if os.path.exists(lp) and not self._lock_stale(lp):
                continue  # a peer is mid-publish/compile on this key
            # dot-prefixed aside: a crash between the replace and the
            # rmtree must leave something _entries() ignores and the
            # sweep above reclaims, not a phantom "live" artifact
            aside = os.path.join(
                self.root, f".evict-{digest}-{os.getpid()}")
            try:
                os.replace(path, aside)
            except OSError:
                continue  # already gone
            shutil.rmtree(aside, ignore_errors=True)
            total -= size
            count -= 1
            self._invalidate_entries_cache()

    # --------------------------------------------------------------- stats
    def _entries_cached(self):
        now = time.monotonic()
        with self._lock:
            ts, cached = self._entries_cache
            if cached is not None and now - ts < self.stats_ttl_s:
                return cached
        entries = self._entries()
        with self._lock:
            self._entries_cache = (now, entries)
        return entries

    def stats(self):
        """Per-store view for health probes: in-memory counters for
        THIS instance (the obs instruments stay process-global for the
        exposition) plus a TTL-cached directory census — a monitor
        polling health must not hammer the shared volume with a full
        per-artifact walk every few seconds."""
        entries = self._entries_cached()
        with self._lock:
            local = dict(self._local)
            quarantined = len(self._quarantined)
        local.update({
            "root": self.root,
            "artifacts": len(entries),
            "bytes": sum(e[1] for e in entries),
            "max_bytes": self.max_bytes,
            "max_count": self.max_count,
            "quarantined": quarantined,
        })
        return local
