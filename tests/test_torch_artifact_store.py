"""The port's artifact store (paddle_tpu_torch/serialize/artifact_store.py)
against the reference's (paddle_tpu/serialize/artifact_store.py).

The store moves opaque bytes, so everything here is bitwise: the key's
canonical form and digest for the same fields (the version passed
explicitly), and every failure mode of the module docstring's table
driven through both stores side by side, each giving the same outcome
and the same counter movements (the module's process-global counters
and the store's own). The two packages share a store directory: a file
one publishes, the other reads. No model runs here.
"""
import json
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from paddle_tpu.resilience import chaos as ref_chaos
from paddle_tpu.serialize import artifact_store as RA
from paddle_tpu_torch.resilience import chaos as port_chaos
from paddle_tpu_torch.serialize import artifact_store as PA
from paddle_tpu_torch.serialize import export as port_export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": (PA, port_chaos), "ref": (RA, ref_chaos)}
VERSION = "torch-test/cuda-test/sm_90"
PAYLOAD = b"good-payload-0123456789"


@pytest.fixture(autouse=True)
def _no_chaos():
    for _, chaos in PKGS.values():
        chaos.reset()
    yield
    for _, chaos in PKGS.values():
        chaos.reset()


def _key(A, model="m" * 64, bucket=8, sig=(("float32", (4,)),), mesh="single",
         version=VERSION, quant=None):
    return A.ArtifactKey(model, bucket, sig, mesh=mesh, version=version, quant=quant)


def _store(A, root, **kw):
    kw.setdefault("max_bytes", 10 ** 9)
    kw.setdefault("max_count", 100)
    kw.setdefault("stale_s", 600.0)
    return A.ArtifactStore(str(root), **kw)


def _counters(A):
    return {"hits": A._HITS.value(), "misses": A._MISSES.value(),
            "corrupt": A._CORRUPT.value(), "takeovers": A._TAKEOVERS.value(),
            "publishes": A._PUBLISHES.value(), "put_errors": A._PUT_ERRORS.value()}


def _local(st):
    return {k: v for k, v in st.stats().items() if k not in ("root",)}


# ------------------------------------------------------------------- keys
KEY_FIELDS = [
    dict(),
    dict(bucket=16),
    dict(model="n" * 64),
    dict(sig=(("int32", (4,)),)),
    dict(sig=[("float32", [2, 3]), ("int64", ())]),
    dict(mesh="tp2"),
    dict(mesh="fsdp2xtp2", quant="w8"),
    dict(quant="f32"),
    dict(quant="bf16w"),
    dict(version="torch-2.5.1/cuda-12.4/sm_90"),
    dict(sig=(("decode:prefix", (8, 16)), ("ab" * 32, ()), ("w0123456789abcdef", ()))),
]


@pytest.mark.parametrize("fields", KEY_FIELDS)
def test_key_digest_and_canonical_equal_the_reference(fields):
    ours, ref = _key(PA, **fields), _key(RA, **fields)
    assert ours.canonical() == ref.canonical()
    assert ours.digest() == ref.digest()
    assert json.loads(json.dumps(ours.canonical())) == ours.canonical()


def test_runtime_version_names_torch_cuda_and_the_device():
    v = port_export.runtime_version()
    torch_part, cuda_part, where = v.split("/")
    assert torch_part.startswith("torch-") and cuda_part.startswith("cuda-")
    assert where == "cpu" or where.startswith("sm_")
    assert port_export.runtime_version("cpu").endswith("/cpu")
    assert PA.ArtifactKey("m", 1, ()).version == v  # the key's default


# -------------------------------------------------------- failure modes
def _corrupt(st, k, how):
    final = st._final(k.digest())
    if how == "bit_flip":
        p = os.path.join(final, PA.PAYLOAD_NAME)
        data = bytearray(open(p, "rb").read())
        data[5] ^= 0xFF
        open(p, "wb").write(bytes(data))
    elif how == "truncated":
        with open(os.path.join(final, PA.PAYLOAD_NAME), "r+b") as f:
            f.truncate(4)
    elif how == "garbage_manifest":
        open(os.path.join(final, PA.MANIFEST_NAME), "w").write("{not json")
    elif how == "missing_payload":
        os.unlink(os.path.join(final, PA.PAYLOAD_NAME))
    elif how == "unknown_format":
        mp = os.path.join(final, PA.MANIFEST_NAME)
        man = json.load(open(mp))
        man["format"] = 999
        json.dump(man, open(mp, "w"))


def failure_mode(A, chaos, root, mode):
    """Drive one failure mode of the docstring's table through store
    module ``A`` -> (what the caller saw, counter deltas, store stats)."""
    st = _store(A, root)
    k = _key(A)
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if mode == "absent":
            before = _counters(A)
            seen.append(st.get(k))
        elif mode in ("bit_flip", "truncated", "garbage_manifest", "missing_payload",
                      "unknown_format"):
            seen.append(st.put(k, PAYLOAD))
            _corrupt(st, k, mode)
            before = _counters(A)
            seen.append(st.get(k))
            seen.append(st.is_quarantined(k))
            seen.append(os.path.isdir(st._final(k.digest())))
            # never retried in-process, even when a peer publishes again
            seen.append(bool(st._put_raising(k, PAYLOAD)))
            seen.append(st.get(k))
        elif mode == "torn_publish":
            before = _counters(A)
            with chaos.fault("artifact.put.publish", exc=OSError("killed mid-publish")):
                seen.append(st.put(k, PAYLOAD))
            seen.append(st.get(k))
            seen.append(sorted(n for n in os.listdir(st.root) if n.startswith("art-")))
        elif mode == "version_skew":
            seen.append(st.put(k, PAYLOAD))
            before = _counters(A)
            seen.append(st.get(_key(A, version="torch-9.9/cuda-9.9/sm_100")))
            seen.append(st.get(k))
        elif mode == "quant_skew":
            seen.append(st.put(_key(A, quant="w8"), PAYLOAD))
            before = _counters(A)
            seen.append([st.get(_key(A, quant=q)) for q in (None, "bf16w", "w8a8", "w8")])
        elif mode == "wrong_key":
            seen.append(st.put(k, PAYLOAD))
            other = _key(A, bucket=32)
            os.rename(st._final(k.digest()), st._final(other.digest()))
            before = _counters(A)
            seen.append(st.get(other))
            seen.append(st.is_quarantined(other))
        elif mode == "unwritable":
            os.rmdir(st.root)
            open(st.root, "w").write("a file where the store's directory was")
            before = _counters(A)
            seen.append(st.put(k, PAYLOAD))
            seen.append(st.get(k))
            seen.append(st.try_acquire(k))
        elif mode == "transient_read_error":
            seen.append(st.put(k, PAYLOAD))
            before = _counters(A)
            with chaos.fault("artifact.verify", exc=OSError("ESTALE")):
                seen.append(st.get(k))
            seen.append(st.is_quarantined(k))
            seen.append(st.get(k))
        elif mode == "dead_pid_lock":
            proc = subprocess.Popen([sys.executable, "-c", "pass"])
            proc.wait()
            with open(st._lockfile(k.digest()), "w") as f:
                json.dump({"pid": proc.pid, "host": st._host, "ts": time.time(),
                           "token": "dead-owner"}, f)
            before = _counters(A)
            lock, payload = st.acquire_or_wait(k, timeout=5.0)
            seen += [lock is not None, payload]
            st.release(lock)
            seen.append(os.path.exists(st._lockfile(k.digest())))
        elif mode == "aged_lock":
            st.stale_s = 0.1
            lp = st._lockfile(k.digest())
            with open(lp, "w") as f:
                json.dump({"pid": 999999999, "host": "other-host",
                           "ts": time.time() - 60.0, "token": "x"}, f)
            os.utime(lp, (time.time() - 60.0, time.time() - 60.0))
            before = _counters(A)
            lock, payload = st.acquire_or_wait(k, timeout=5.0)
            seen += [lock is not None, payload]
            st.release(lock)
        elif mode == "live_lock_times_out":
            lk = st.try_acquire(k)
            before = _counters(A)
            seen.append(st.try_acquire(k))
            seen.append(st.acquire_or_wait(k, timeout=0))
            seen.append(st._lock_stale(lk.path))
            st.release(lk)
            seen.append(os.path.exists(lk.path))
        else:
            raise AssertionError(mode)
    after = _counters(A)
    delta = {n: after[n] - before[n] for n in after}
    stats = _local(st) if mode != "unwritable" else None
    if stats is not None:
        stats.pop("bytes")  # the manifest's timestamp has a machine-dependent width
    return seen, delta, stats


MODES = ["absent", "bit_flip", "truncated", "garbage_manifest", "missing_payload",
         "unknown_format", "torn_publish", "version_skew", "quant_skew", "wrong_key",
         "unwritable", "transient_read_error", "dead_pid_lock", "aged_lock",
         "live_lock_times_out"]


@pytest.mark.parametrize("mode", MODES)
def test_failure_mode_equals_the_reference(tmp_path, mode):
    ours = failure_mode(PA, port_chaos, tmp_path / "port", mode)
    ref = failure_mode(RA, ref_chaos, tmp_path / "ref", mode)
    assert ours == ref
    seen, delta, _ = ours
    if mode in ("bit_flip", "truncated", "garbage_manifest", "missing_payload",
                "unknown_format"):
        # quarantined: gone from disk, never retried in-process
        assert seen[1:] == [None, True, False, True, None] and delta["corrupt"] == 1
    if mode == "unwritable":
        assert seen[0] is False and delta["put_errors"] == 1
    if mode in ("dead_pid_lock", "aged_lock"):
        assert seen[0] is True and delta["takeovers"] == 1


def test_gc_retention_equals_the_reference(tmp_path):
    """Count and byte budgets evict the oldest artifacts alike, and skip
    one a live lock protects."""
    out = []
    for name, (A, _) in PKGS.items():
        st = _store(A, tmp_path / name, max_count=3, gc_grace_s=0.0)
        keys = [_key(A, bucket=b) for b in range(1, 6)]
        lk = st.try_acquire(keys[0])
        for i, k in enumerate(keys):
            assert st.put(k, bytes([i]) * (100 + i))
            os.utime(st._final(k.digest()), (1000.0 + i, 1000.0 + i))
        st.gc()
        kept = sorted(n[4:] for n in os.listdir(st.root) if n.startswith("art-"))
        assert keys[0].digest() in kept  # its live lock protected it
        out.append(kept)
        st.release(lk)
    assert out[0] == out[1] and len(out[0]) == 3


_HOLDER = r"""
import sys
sys.path.insert(0, sys.argv[1])
from paddle_tpu_torch.serialize import artifact_store as A
st = A.ArtifactStore(sys.argv[2])
k = A.ArtifactKey("m" * 64, 8, (("float32", (4,)),), version=sys.argv[3])
lock = st.try_acquire(k)
print("held" if lock is not None else "refused", flush=True)
sys.stdin.readline()
st.put(k, b"published-by-the-holder")
st.release(lock)
print("done", flush=True)
"""


def test_single_flight_across_processes(tmp_path):
    """A port process holds the single-flight lock of a key: both
    packages' stores see it held (try_acquire refuses), wait in
    acquire_or_wait, and get the holder's publish once it releases."""
    root = tmp_path / "shared"
    os.makedirs(root)
    child = subprocess.Popen([sys.executable, "-c", _HOLDER, REPO, str(root), VERSION],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "held"
        results = {}
        stores = {name: _store(A, root) for name, (A, _) in PKGS.items()}
        for name, st in stores.items():
            assert st.try_acquire(_key(PKGS[name][0])) is None

        def wait(name):
            results[name] = stores[name].acquire_or_wait(_key(PKGS[name][0]), timeout=60)

        waiters = [threading.Thread(target=wait, args=(n,)) for n in stores]
        for t in waiters:
            t.start()
        child.stdin.write("go\n")
        child.stdin.flush()
        for t in waiters:
            t.join(60)
        assert child.stdout.readline().strip() == "done"
        assert results == {n: (None, b"published-by-the-holder") for n in stores}
    finally:
        child.kill()
        child.wait()


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_one_package_publishes_the_other_reads(tmp_path, writer, reader):
    payload = np.random.RandomState(3).bytes(4096)
    W, R = PKGS[writer][0], PKGS[reader][0]
    assert _store(W, tmp_path).put(_key(W, quant="w8"), payload)
    st = _store(R, tmp_path)
    assert st.get(_key(R, quant="w8")) == payload
    assert st.get(_key(R)) is None  # another key is a clean miss
    assert not st.is_quarantined(_key(R, quant="w8"))


def test_kill_switch_and_default_store(tmp_path):
    """The reference's environment knobs are arguments: ``disabled`` (its
    PADDLE_TPU_ARTIFACT_DISABLE) publishes nothing, ``default_store``
    needs a root."""
    st = _store(PA, tmp_path, disabled=True)
    assert st.put(_key(PA), PAYLOAD) is False and st.get(_key(PA)) is None
    assert PA.default_store() is None and PA.default_store(str(tmp_path), disabled=True) is None
    assert isinstance(PA.default_store(str(tmp_path)), PA.ArtifactStore)
