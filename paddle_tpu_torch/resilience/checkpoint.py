"""Atomic file primitives (counterpart of paddle_tpu/resilience/checkpoint.py
:62-107): ``atomic_write_bytes``, ``atomic_write_json``, ``file_sha256`` and
``CheckpointCorrupt``. A reader sees a file's old content or its new, never
a truncated mix: the bytes go to a temp file in the same directory, which
is fsynced and ``os.replace``d into place, and the directory is fsynced.

The reference's ``CheckpointManager`` (manifests, retention, verified load
with fallback) is not ported yet (ROADMAP Queue 1)."""
import hashlib
import json
import os


class CheckpointCorrupt(RuntimeError):
    """Manifest missing/unreadable or a payload file fails verification."""


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path, data):
    """Write ``data`` to ``path`` atomically (see the module docstring);
    returns ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)
    return path


def atomic_write_json(path, obj):
    return atomic_write_bytes(path, json.dumps(obj, sort_keys=True).encode("utf-8"))


def file_sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()
