"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

Each source under ``paddle_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into ``paddle_tpu_torch/_build/lib<name>-<hash>.so`` at first
use. The hash covers the source, every header under ``csrc/`` that it
includes (directly or through another header) and the flags, so an
edited source or shared header never loads a stale library. Nothing here runs at import: the CPU tests import
every module on a machine without ``nvcc``.
"""
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}  # name -> ctypes.CDLL
#: name -> {"seconds": float, "log": str} for every library built by
#: this process (empty for one found already built)
build_info = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of paddle_tpu_torch are built at first use")


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(name):
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes, in
    the order first reached. An include that is not under ``csrc/``
    (a system or toolkit header) is left to nvcc."""
    order, todo = [], [name + ".cu"]
    while todo:
        rel = todo.pop(0)
        if rel in order:
            continue
        order.append(rel)
        with open(os.path.join(CSRC_DIR, rel), encoding="utf-8") as f:
            text = f.read()
        todo += [inc for inc in _INCLUDE.findall(text)
                 if os.path.exists(os.path.join(CSRC_DIR, inc))]
    return order


def source_hash(name):
    """Hash of everything the library ``name`` is built from: its sources
    (names and contents) and the nvcc flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in _sources(name):
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read() + b"\0")
    return digest.hexdigest()[:12]


def _target(name):
    src = os.path.join(CSRC_DIR, name + ".cu")
    return src, os.path.join(BUILD_DIR, f"lib{name}-{source_hash(name)}.so")


def build(names):
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together. Raises RuntimeError with the compiler's
    output when any of them fails. Processes that share the checkout
    (a fleet's replicas) build under one file lock: the first builds,
    the others wait for it and then find the libraries built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    if all(os.path.exists(_target(name)[1]) for name in names):
        return
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        _build_locked(names)


def _build_locked(names):
    procs = {}
    for name in names:
        src, out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never loads a torn library
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(_target(name)[1])
        return lib
