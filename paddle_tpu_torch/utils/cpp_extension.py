"""Custom C++ ops (counterpart of paddle_tpu/utils/cpp_extension.py;
reference: python/paddle/utils/cpp_extension/ ``load()`` and
framework/custom_operator.cc).

Custom C++ kernels are host ops, as in the reference: ``load`` compiles
the sources with g++ into a shared library, binds it through ctypes, and
makes each exported op a ``torch.autograd.Function`` whose backward calls
the op's ``<name>_grad`` symbol (or raises NotImplementedError when there
is none, as the reference's VJP does). A CUDA tensor is copied to the
host, through the op, and back.

C ABI (one op per exported symbol), the reference's:
    extern "C" void <name>(const float* x, float* y, int64_t n);
    extern "C" void <name>_grad(const float* x, const float* dy,
                                float* dx, int64_t n);   // optional
Elementwise: y has x's shape.

Libraries go to ``paddle_tpu_torch/_build/cpp_extension/<name>/`` (or
``build_directory``), named by a hash of the sources and the flags, and
are built under a file lock there: processes that load the same op build
it once.
"""
import ctypes
import fcntl
import hashlib
import os
import subprocess

import torch

from ..core.tensor import Tensor, plain, wrap

_DEFAULT_BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build", "cpp_extension")
_F32P = ctypes.POINTER(ctypes.c_float)


def _hash_sources(sources, flags):
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _list_symbols(lib_path):
    out = subprocess.run(["nm", "-D", "--defined-only", lib_path], check=True,
                         capture_output=True, text=True).stdout
    syms = []
    for line in out.splitlines():
        parts = line.split()
        if len(parts) >= 3 and parts[-2] == "T":
            syms.append(parts[-1])
    return syms


def _ptr(t):
    return ctypes.cast(t.data_ptr(), _F32P)


def _host_call(fn, *tensors):
    """``fn`` over float32 host copies of ``tensors`` -> a new tensor of
    the first one's shape, on its device."""
    host = [t.detach().to("cpu", torch.float32).contiguous() for t in tensors]
    out = torch.empty_like(host[0])
    fn(*(_ptr(h) for h in host), _ptr(out), host[0].numel())
    return out.to(tensors[0].device)


class CustomOpModule:
    """The loaded library; each op is an attribute taking and returning
    tensors (Tensors for Tensors), differentiable when a ``_grad`` symbol
    exists."""

    def __init__(self, name, lib_path):
        self._name = name
        self._lib = ctypes.CDLL(lib_path)
        self._lib_path = lib_path
        self.op_names = []
        syms = [s for s in _list_symbols(lib_path) if not s.startswith("_")]
        grads = {s for s in syms if s.endswith("_grad")}
        for sym in syms:
            if sym in grads:
                continue
            self._register(sym, has_grad=(sym + "_grad") in grads)
            self.op_names.append(sym)

    def _register(self, sym, has_grad):
        cfn = getattr(self._lib, sym)
        cfn.restype = None
        cfn.argtypes = [_F32P, _F32P, ctypes.c_int64]
        gfn = None
        if has_grad:
            gfn = getattr(self._lib, sym + "_grad")
            gfn.restype = None
            gfn.argtypes = [_F32P, _F32P, _F32P, ctypes.c_int64]

        class Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return _host_call(cfn, x)

            @staticmethod
            def backward(ctx, dy):
                if gfn is None:
                    raise NotImplementedError(f"custom op {sym!r} has no {sym}_grad symbol")
                x, = ctx.saved_tensors
                return _host_call(gfn, x, dy)

        def tensor_op(x, name=None):
            out = Op.apply(plain(x))
            return wrap(out) if type(x) is Tensor else out

        tensor_op.__name__ = sym
        setattr(self, sym, tensor_op)


def load(name, sources, extra_cxx_cflags=None, extra_cflags=None, build_directory=None,
         verbose=False, **kwargs):
    """Compile ``sources`` with g++ (once per sources-and-flags hash) and
    return a CustomOpModule (reference: cpp_extension.load:710)."""
    flags = ["-O2", "-std=c++17", "-shared", "-fPIC"]
    flags += list(extra_cxx_cflags or extra_cflags or [])
    sources = [os.path.abspath(s) for s in sources]
    tag = _hash_sources(sources, flags)
    build_dir = build_directory or os.path.join(_DEFAULT_BUILD_ROOT, name)
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, f"{name}_{tag}.so")
    if not os.path.exists(lib_path):
        with open(os.path.join(build_dir, f".{name}_{tag}.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not os.path.exists(lib_path):
                _compile(flags, sources, lib_path, verbose)
    return CustomOpModule(name, lib_path)


def _compile(flags, sources, lib_path, verbose):
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++"] + flags + ["-o", tmp] + sources
    if verbose:
        print("compiling custom ops:", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"custom op build failed:\n{(e.stderr or b'').decode()}") from e
    os.replace(tmp, lib_path)  # atomic: a reader never loads a torn library


class CppExtension:
    """setup()-style declaration (reference: cpp_extension.py CppExtension):
    sources and flags that ``setup`` builds with ``load``."""

    def __init__(self, sources, *args, **kwargs):
        self.sources = sources
        self.extra_compile_args = kwargs.get("extra_compile_args", [])


def CUDAExtension(sources, *args, **kwargs):
    """The reference's: its C++ sources as a CppExtension (custom ops are
    host ops; ``.cu``/``.cuh`` sources are left out)."""
    cpp_sources = [s for s in sources if not s.endswith((".cu", ".cuh"))]
    return CppExtension(cpp_sources, *args, **kwargs)


def setup(name="paddle_tpu_custom_ops", ext_modules=None, **kwargs):
    """Build every extension now and return the loaded modules (the
    reference's setuptools build, as one ``load`` each)."""
    exts = ext_modules or []
    if not isinstance(exts, (list, tuple)):
        exts = [exts]
    return [load(f"{name}_{i}", e.sources, extra_cxx_cflags=e.extra_compile_args)
            for i, e in enumerate(exts)]
