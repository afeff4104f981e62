"""Weight-only dequantizing matrix product: a hand-written CUDA kernel for
Hopper, ``csrc/quant_matmul.cu``.

``wq_matmul(x, w, scale)`` computes ``x @ (w -> f32 * scale)`` in f32 for
the two weight forms of quantized serving (quantization/serving.py):

- w8: ``w`` int8 ``[K, N]`` with a per-output-column f32 ``scale [N]``;
- bf16w: ``w`` bf16 ``[K, N]``, no scale.

The reference dequantizes and multiplies in plain jnp
(paddle_tpu/quantization/serving.py ``quantize_decode_model``'s
``unpack``, :213-222; post_training.py ``Int8Linear.forward``, :48-52),
and XLA fuses the dequantize into the product's read of the weights. The
kernel is the port's counterpart of that fusion: it reads the reduced
weights once, in their ``[K, N]`` layout, and never writes an f32 copy of
them. ``wq_matmul_reference`` is its plain version (dequantize, then
``torch.matmul``): CPU tensors take it; CUDA tensors launch the kernel or
raise, never a fallback.

The kernel runs on the bf16 tensor cores and keeps f32 accuracy (no
TF32). Every weight is exact in bf16 (an int8 q has at most 8 significant
bits), and x is split exactly into three bf16 pieces by ``split_bf16``
(hi = bf16(x), then the rest twice more; hi + mid + lo == x), so each
piece-times-weight product is exact and only the accumulation rounds. The
w8 scale is applied once to each output's sum, ``(sum of x q) * s``, where
the reference rounds ``q * s`` per element: about an ulp of each product
apart, far inside the 1e-4 of the output's max the kernel is held to.
What bounds it on an H100: the weights' bytes at the decode step's
M = 16, the three passes' tensor-core operations at a fill's M = 128.

K is cut into ``splits(K, N)`` parts summed in a fixed order, a function
of K and N only: the order of every output's sum (k-steps, the three
passes, the splits) never depends on M, so a row's bits do not depend on
how many rows a call has (the decode engine's solo = batch, the prefix
cache's hit = cold).

``QuantWeight`` holds one reduced weight, and ``wmatmul(x, w)`` is the one
product the port's decoder maths goes through: a ``QuantWeight`` goes to
``wq_matmul``, a plain tensor to ``torch.matmul``. The library is built at
first use (core/cuda_build.py), never at import.
"""
import ctypes
from typing import Optional

import torch

from ..core import cuda_build

#: launches of the kernel in this process; reset it to count a run. A CUDA
#: graph's replay credits the launches its capture recorded
#: (core/cuda_graph.py)
launches = 0

_WDTYPE = {torch.int8: 0, torch.bfloat16: 1}
_lib = None

# the kernel's tiling (csrc/quant_matmul.cu): weight columns and k of one
# block's tile and chunk, and what decides the split count
NT, KC = 128, 64
MAX_SPLITS, TARGET_BLOCKS, MIN_SPLIT_CHUNKS = 8, 264, 4


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("quant_matmul")
        lib.quant_matmul.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                     + [ctypes.c_void_p])
        lib.quant_matmul.restype = ctypes.c_int
        lib.quant_matmul_error_string.argtypes = [ctypes.c_int]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
        lib.quant_matmul_smem_bytes.argtypes = [ctypes.c_int]
        lib.quant_matmul_smem_bytes.restype = ctypes.c_int
        lib.quant_matmul_splits.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.quant_matmul_splits.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(dtype):
    """Dynamic shared memory one block takes for weights of ``dtype``."""
    return _library().quant_matmul_smem_bytes(_WDTYPE[dtype])


def kernel_splits(k, n):
    """The split count the built kernel uses for a ``k x n`` product."""
    return _library().quant_matmul_splits(k, n)


def splits(k, n):
    """How many parts the kernel cuts K into for a ``k x n`` product (the
    twin of ``splits`` in csrc/quant_matmul.cu): enough blocks for two on
    each of an H100's 132 SMs at M <= 32, at most 8 (a portable thread
    block cluster) and at least 4 chunks of ``KC`` a part. A function of
    K and N only, never of M."""
    chunks, tiles = -(-k // KC), -(-n // NT)
    return max(1, min(-(-TARGET_BLOCKS // tiles), MAX_SPLITS, chunks // MIN_SPLIT_CHUNKS))


def split_bf16(x):
    """float32 ``x`` -> its exact bf16 pieces ``(hi, mid, lo)``, the
    kernel's split (csrc/quant_matmul.cu): hi = bf16(x), r = x - hi,
    mid = bf16(r), lo = bf16(r - mid), each rounding to nearest even. x's
    24 significant bits go 8 + 8 + 8 into the pieces, so
    hi + mid + lo == x for finite |x| in [2^-103, bf16's largest]."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def dequantize(w, scale=None):
    """``w`` as f32, times ``scale`` per output column (the last axis)
    where given: the reference's ``q.astype(f32) * s``, one IEEE product
    per element."""
    wf = w.float()
    return wf if scale is None else wf * scale


def wq_matmul_reference(x, w, scale=None):
    """Plain PyTorch version of the kernel: dequantize, then
    ``torch.matmul`` in f32."""
    return torch.matmul(x.float(), dequantize(w, scale))


def _check(x, w, scale):
    if w.dim() != 2 or w.dtype not in _WDTYPE:
        raise TypeError(f"wq_matmul takes a 2-d int8 or bfloat16 weight, got "
                        f"{w.dtype} {tuple(w.shape)}")
    if (scale is None) != (w.dtype == torch.bfloat16):
        raise ValueError("wq_matmul: an int8 weight needs its scale, a bfloat16 one takes none")
    if x.dtype != torch.float32 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"wq_matmul: x {x.dtype} {tuple(x.shape)} does not take a "
                         f"[{w.shape[0]}, {w.shape[1]}] weight (float32 x, last axis K)")
    if scale is not None and (scale.dtype != torch.float32 or tuple(scale.shape) != (w.shape[1],)):
        raise ValueError(f"wq_matmul: scale {scale.dtype} {tuple(scale.shape)} is not "
                         f"float32 [{w.shape[1]}]")
    tensors = (x, w) if scale is None else (x, w, scale)
    if not all(t.is_cuda for t in tensors) or any(t.device != x.device for t in tensors):
        raise ValueError("wq_matmul: x, w and scale must lie on one card")
    k, n = w.shape
    if k % 4 or n % (16 if w.dtype == torch.int8 else 8):
        raise ValueError(f"wq_matmul kernel takes K % 4 == 0 and N % 16 (int8) or N % 8 "
                         f"(bfloat16) == 0, got K {k}, N {n}")


@torch.library.custom_op("paddle_tpu_torch::wq_matmul", mutates_args=())
def _wq_matmul_op(x: torch.Tensor, w: torch.Tensor,
                  scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel as a torch.library custom op (its fake below gives the
    output's shape without launching), so a program captured by
    torch.export (jit.save of a w8 model) calls it, launches and counts."""
    return _wq_matmul(x, w, scale)


@_wq_matmul_op.register_fake
def _(x, w, scale):
    return x.new_empty(tuple(x.shape[:-1]) + (w.shape[1],), dtype=torch.float32)


def wq_matmul(x, w, scale=None):
    """x [..., K] float32 @ (w [K, N] -> float32, times ``scale [N]`` for
    int8) -> [..., N] float32, through the custom op. CUDA tensors launch
    the kernel; CPU tensors run ``wq_matmul_reference``."""
    return _wq_matmul_op(x, w, scale)


def _wq_matmul(x, w, scale):
    global launches
    if not x.is_cuda:
        return wq_matmul_reference(x, w, scale)
    _check(x, w, scale)
    k, n = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    w = w.contiguous()
    if scale is not None:
        scale = scale.contiguous()
    out = torch.empty((x2.shape[0], n), dtype=torch.float32, device=x.device)
    if x2.shape[0] == 0:
        return out.reshape(*lead, n)
    lib = _library()
    err = lib.quant_matmul(x2.data_ptr(), w.data_ptr(),
                           None if scale is None else scale.data_ptr(), out.data_ptr(),
                           x2.shape[0], n, k, _WDTYPE[w.dtype],
                           torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.quant_matmul_error_string(err).decode()
        raise RuntimeError(f"quant_matmul launch failed: {msg} (cudaError {err})")
    launches += 1
    return out.reshape(*lead, n)


class QuantWeight:
    """One reduced-precision ``[K, N]`` weight of quantized serving: int8
    ``data`` with its f32 per-column ``scale`` (w8), or bf16 ``data`` and
    no scale (bf16w). ``matmul(x)`` is ``wq_matmul`` (on the card a K or N
    the kernel does not take is padded with zero rows and columns for the
    call, as ``Int8Linear`` pads, and the output sliced back); ``rows(idx)``
    dequantizes only the rows ``idx`` (an embedding's gather: the same bits
    as dequantize-then-gather); ``tensors(name)`` gives its (name, tensor)
    pairs in the reference's flat order (data, then scale).

    It stands in for the f32 matrix in code written for one: ``x @ w``,
    ``torch.matmul(x, w)`` (so the port's ``F.linear``) and ``wmatmul``
    run ``matmul``, ``w[idx]`` runs ``rows``; any other torch function
    given one raises a TypeError naming QuantWeight, so no use of the
    weight can fall back to a dequantized copy."""

    def __init__(self, data, scale=None):
        self.data = data
        self.scale = scale

    def matmul(self, x):
        k, n = self.data.shape
        pad_k, pad_n = -k % 4, -n % (16 if self.data.dtype == torch.int8 else 8)
        if x.is_cuda and (pad_k or pad_n):
            w = torch.nn.functional.pad(self.data, (0, pad_n, 0, pad_k))
            scale = (None if self.scale is None
                     else torch.nn.functional.pad(self.scale, (0, pad_n), value=1.0))
            return wq_matmul(torch.nn.functional.pad(x, (0, pad_k)), w, scale)[..., :n]
        return wq_matmul(x, self.data, self.scale)

    def rows(self, idx):
        return dequantize(self.data[idx], self.scale)

    def tensors(self, name):
        if self.scale is None:
            return [(name, self.data)]
        return [(name, self.data), (name + ".scale", self.scale)]

    def __getitem__(self, idx):
        return self.rows(idx)

    def __rmatmul__(self, x):
        return self.matmul(x)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if (func in _MATMULS and len(args) == 2 and not kwargs
                and isinstance(args[1], QuantWeight) and isinstance(args[0], torch.Tensor)):
            return args[1].matmul(args[0])
        return NotImplemented


_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


def wmatmul(x, w):
    """``x @ w`` for a weight of any serving mode and mesh: a plain tensor
    goes to ``torch.matmul``, any other weight to its own ``matmul``: a
    ``QuantWeight`` to ``wq_matmul`` (the kernel on the card), a serving
    mesh's ``ShardedWeight`` (inference/sharding.py) to its products per
    shard."""
    if isinstance(w, torch.Tensor):
        return torch.matmul(x, w)
    return w.matmul(x)
