"""Atomic, self-verifying checkpoints (counterpart of
paddle_tpu/resilience/checkpoint.py).

A checkpoint either exists completely or not at all: its files are
written into a hidden temp directory, fsynced, then published with one
``os.replace``; a crash at any point leaves the previous checkpoint as it
was (the temp directory is collected on the next save). Each checkpoint
carries a ``MANIFEST.json`` with the step and every file's SHA-256 and
size (and, with ``leaf_manifest=True``, every leaf's), and a load verifies
the manifest before it trusts the payload, falling back to the previous
good checkpoint on corruption.

On-disk layout, the reference's, so that either package loads the
other's checkpoints:

    <root>/
      LATEST                # text: name of the newest published checkpoint
      ckpt-<step>/
        MANIFEST.json       # {"format": 1, "step": N, "ts": ..., "files": {...},
                            #  "leaves": {...}, "extra": {...}}
        state.pdparams      # default payload (framework.save's pickle)
      .tmp-ckpt-<step>-<pid>/   # a save in flight; never read

The payload is pluggable (``writer``/``reader``). One process writes to a
root; any number may read. The atomic primitives (``atomic_write_bytes``,
``atomic_write_json``, ``file_sha256``) are the reference's :62-107.

Telemetry through the port's obs: ``paddle_checkpoint_saves_total``,
``_save_seconds``, ``_loads_total`` and ``_fallbacks_total``; a save's
time is goodput's ``checkpoint`` category, and each save and load leaves a
``checkpoint.save`` / ``checkpoint.load`` span. Chaos sites:
``checkpoint.write`` (each payload attempt), ``checkpoint.rename`` and
``checkpoint.latest``.
"""
import hashlib
import json
import os
import shutil
import time
import warnings

import numpy as np
import torch

from ..obs import goodput as _goodput
from ..obs import metrics as _obs
from ..obs import tracing as _tracing
from . import chaos
from .retry import call_with_retry

MANIFEST_NAME = "MANIFEST.json"
LATEST_NAME = "LATEST"
FORMAT_VERSION = 1

_SAVES = _obs.counter("paddle_checkpoint_saves_total", "Published checkpoints")
_SAVE_SECONDS = _obs.histogram("paddle_checkpoint_save_seconds", "Checkpoint publish duration",
                               buckets=_obs.log_buckets(0.001, 4.0, 10))
_LOADS = _obs.counter("paddle_checkpoint_loads_total", "Verified checkpoint loads")
_FALLBACKS = _obs.counter("paddle_checkpoint_fallbacks_total",
                          "Corrupt/unusable checkpoints skipped during load")


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


def _leaf_bytes(leaf):
    """(bytes, dtype name, shape) of a leaf as the reference hashes it: a
    tensor's host array (a bfloat16 one as its 16-bit words, named
    "bfloat16" as ml_dtypes names it), an array as it is, anything else
    by its repr."""
    if isinstance(leaf, torch.Tensor):
        from ..framework import _host_array

        arr, tag = _host_array(leaf)
        return np.ascontiguousarray(arr).tobytes(), tag or str(arr.dtype), arr.shape
    try:
        arr = np.asarray(leaf)
    except Exception:  # noqa: BLE001 - an opaque leaf is hashed by its repr
        return repr(leaf).encode("utf-8"), "opaque", ()
    return np.ascontiguousarray(arr).tobytes(), str(arr.dtype), arr.shape


def flatten_tree(state, prefix=""):
    """A nested dict/list/tuple as an ordered {dotted.path: leaf} map, the
    reference's leaf naming."""
    out = {}
    if isinstance(state, dict):
        for k, v in state.items():
            out.update(flatten_tree(v, f"{prefix}{k}."))
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            out.update(flatten_tree(v, f"{prefix}{i}."))
    else:
        out[prefix.rstrip(".") or "<root>"] = state
    return out


def leaf_checksums(state, prefix=""):
    """{dotted.path: {sha256, dtype, shape}} over ``flatten_tree``: a
    corruption report names the tensor, not only the file."""
    out = {}
    for path, leaf in flatten_tree(state, prefix).items():
        data, dtype, shape = _leaf_bytes(leaf)
        out[path] = {"sha256": hashlib.sha256(data).hexdigest(), "dtype": dtype,
                     "shape": list(shape)}
    return out


def _default_writer(state, ckpt_dir, leaf_manifest=False):
    from .. import framework

    framework.save(state, os.path.join(ckpt_dir, "state.pdparams"))
    # the per-file sha256 already guards the payload; per-leaf hashes copy
    # every tensor to the host once more, so they are opt-in
    return leaf_checksums(state) if leaf_manifest else None


def _default_reader(ckpt_dir):
    from .. import framework

    return framework.load(os.path.join(ckpt_dir, "state.pdparams"))


class CheckpointManager:
    """Atomic save, verified load and retention over one directory.

    keep: the newest ``keep`` published checkpoints survive ``gc`` (the
    one LATEST names always does). writer(state, dir) -> leaves or None
    writes the payload into dir; reader(dir) -> state reads it back.
    io_retries: attempts at the payload write, with backoff, on OSError.
    leaf_manifest: record every leaf's checksum too (default writer).
    """

    def __init__(self, root, keep=3, prefix="ckpt", writer=None, reader=None, io_retries=3,
                 leaf_manifest=False):
        self.root = os.path.abspath(root)
        self.keep = keep
        self.prefix = prefix
        if writer is None:
            def writer(state, d):
                return _default_writer(state, d, leaf_manifest)
        self._writer = writer
        self._reader = reader or _default_reader
        self._io_retries = io_retries

    def _name(self, step):
        return f"{self.prefix}-{step}"

    def _step_of(self, name):
        tag = f"{self.prefix}-"
        if not name.startswith(tag):
            return None
        try:
            return int(name[len(tag):])
        except ValueError:
            return None

    def all_steps(self):
        """Published checkpoint steps, ascending."""
        if not os.path.isdir(self.root):
            return []
        return sorted(s for n in os.listdir(self.root)
                      if (s := self._step_of(n)) is not None
                      and os.path.isdir(os.path.join(self.root, n)))

    def path(self, step):
        return os.path.join(self.root, self._name(step))

    def latest_name(self):
        try:
            with open(os.path.join(self.root, LATEST_NAME)) as f:
                name = f.read().strip()
            return name or None
        except OSError:
            return None

    def latest_step(self):
        name = self.latest_name()
        if name is not None:
            step = self._step_of(name)
            if step is not None and os.path.isdir(os.path.join(self.root, name)):
                return step
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, step, extra=None):
        """Publish ``state`` as checkpoint ``step``; returns its path.

        The payload and manifest land in a temp directory, one os.replace
        publishes it, then LATEST flips (atomically too). A transient
        write error is retried with backoff."""
        t_save = time.perf_counter()
        os.makedirs(self.root, exist_ok=True)
        name = self._name(step)
        final = os.path.join(self.root, name)
        tmp = os.path.join(self.root, f".tmp-{name}-{os.getpid()}")

        def write_payload():
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            chaos.hit("checkpoint.write")
            leaves = self._writer(state, tmp)
            manifest = {"format": FORMAT_VERSION, "step": int(step), "ts": time.time(),
                        "files": {}}
            if leaves:
                manifest["leaves"] = leaves
            if extra:
                manifest["extra"] = extra
            for dirpath, _, files in os.walk(tmp):
                for fn in files:
                    full = os.path.join(dirpath, fn)
                    manifest["files"][os.path.relpath(full, tmp)] = {
                        "sha256": file_sha256(full), "size": os.path.getsize(full)}
            with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                json.dump(manifest, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())

        try:
            call_with_retry(write_payload, retry_on=(OSError,), max_attempts=self._io_retries,
                            base_delay=0.05)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        chaos.hit("checkpoint.rename")
        old = None
        if os.path.isdir(final):
            # a second save of one step: move the first aside atomically,
            # never delete before the new one is published
            old = os.path.join(self.root, f".old-{name}-{os.getpid()}")
            if os.path.isdir(old):
                shutil.rmtree(old, ignore_errors=True)
            os.replace(final, old)
        try:
            os.replace(tmp, final)
        except BaseException:
            if old is not None and not os.path.isdir(final):
                os.replace(old, final)
            raise
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        _fsync_dir(self.root)
        chaos.hit("checkpoint.latest")
        atomic_write_bytes(os.path.join(self.root, LATEST_NAME), name.encode("utf-8"))
        self.gc()
        dt = time.perf_counter() - t_save
        _SAVES.inc()
        _SAVE_SECONDS.observe(dt)
        _goodput.account("checkpoint", dt)
        _tracing.record_span("checkpoint.save", dt, step=int(step))
        return final

    def verify(self, ckpt_dir):
        """Every payload file against the manifest; returns the manifest,
        raises CheckpointCorrupt on any mismatch."""
        try:
            with open(os.path.join(ckpt_dir, MANIFEST_NAME)) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorrupt(f"{ckpt_dir}: manifest unreadable: {e}") from e
        if manifest.get("format") != FORMAT_VERSION:
            raise CheckpointCorrupt(
                f"{ckpt_dir}: unknown manifest format {manifest.get('format')!r}")
        for rel, meta in manifest.get("files", {}).items():
            full = os.path.join(ckpt_dir, rel)
            if not os.path.isfile(full):
                raise CheckpointCorrupt(f"{ckpt_dir}: missing file {rel}")
            if os.path.getsize(full) != meta["size"]:
                raise CheckpointCorrupt(f"{ckpt_dir}: size mismatch for {rel}")
            if file_sha256(full) != meta["sha256"]:
                raise CheckpointCorrupt(f"{ckpt_dir}: checksum mismatch for {rel}")
        return manifest

    def _candidates(self):
        names = []
        latest = self.latest_name()
        if latest is not None:
            names.append(latest)
        for step in reversed(self.all_steps()):
            n = self._name(step)
            if n not in names:
                names.append(n)
        return names

    def load(self, verify=True):
        """(state, step) of the newest checkpoint that verifies, falling
        back through older ones; (None, -1) when none is usable."""
        t_load = time.perf_counter()
        for name in self._candidates():
            ckpt_dir = os.path.join(self.root, name)
            if not os.path.isdir(ckpt_dir):
                continue
            try:
                manifest = self.verify(ckpt_dir) if verify else None
                state = self._reader(ckpt_dir)
                if manifest is None:
                    step = self._step_of(name)
                    step = -1 if step is None else step
                else:
                    step = int(manifest["step"])
                _LOADS.inc()
                _tracing.record_span("checkpoint.load", time.perf_counter() - t_load,
                                     step=step)
                return state, step
            except Exception as e:  # noqa: BLE001 - fall back past corruption
                _FALLBACKS.inc()
                warnings.warn(f"checkpoint {ckpt_dir} unusable ({e}); falling back to an "
                              "older checkpoint")
        return None, -1

    def gc(self):
        """Drop all but the newest ``keep`` checkpoints (never the one
        LATEST names) and a crashed writer's temp directories."""
        if not os.path.isdir(self.root):
            return
        steps = self.all_steps()
        latest = self.latest_name()
        if self.keep and self.keep > 0:
            for step in steps[:-self.keep]:
                name = self._name(step)
                if name != latest:
                    shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)
        for n in os.listdir(self.root):
            if (n.startswith(".tmp-") and n != f".tmp-{latest}-{os.getpid()}") or \
                    n.startswith(".old-"):
                full = os.path.join(self.root, n)
                if os.path.isdir(full):
                    shutil.rmtree(full, ignore_errors=True)
