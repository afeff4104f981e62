"""Flash (blockwise-softmax) attention forward: a hand-written CUDA kernel
for Hopper (counterpart of paddle_tpu/ops/pallas/flash_attention.py).

``_fwd`` launches ``csrc/flash_attention_fwd.cu`` for CUDA tensors and
runs ``mha_reference``, the plain PyTorch version of the same function,
for CPU tensors. There is no fallback: a CUDA tensor the kernel does not
take, a failed build or a failed launch raises. The kernel is built at
first use (core/cuda_build.py), never at import.

Forward only. The backward kernels (dq, dk/dv) and the autograd Function
arrive with the training slice; until then ``mha`` refuses a CUDA input
that would need a gradient.
"""
import ctypes
import math

import torch

from ..core import cuda_build
from ..core.random import U32, fmix32, keep_thresh_u32, mul32

NEG_INF = -1e30

HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches by ``_fwd`` in this process (reset it to count a run)
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("flash_attention_fwd")
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
               ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_fwd_smem_bytes.argtypes = [ctypes.c_int]
        lib.flash_attention_fwd_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(head_dim):
    """Dynamic shared memory one kernel block takes for ``head_dim``."""
    return _library().flash_attention_fwd_smem_bytes(int(head_dim))


def _keep_mask(seed, b, rows, cols, seq_k, keep_thresh):
    """Counter-hash dropout keep mask, bit-identical to the JAX kernel's
    ``_keep_mask``: the batch-head index folded into the seed by its own
    hash round, then fmix32 of the flat (row, col) index. ``b``, ``rows``
    and ``cols`` are int64 tensors that broadcast together."""
    bseed = (int(seed) & U32) ^ mul32(b, 0x85EBCA6B)
    bseed = bseed ^ (bseed >> 13)
    bseed = mul32(bseed, 0xC2B2AE35)
    idx = (rows * seq_k + cols) & U32
    return fmix32(mul32(idx, 0x9E3779B1) ^ bseed) < keep_thresh


def mha_reference(q, k, v, seed=0, scale=None, causal=False, dropout_p=0.0):
    """Plain PyTorch version of the kernel on [bh, seq, d] tensors: the
    whole softmax at once, with the kernel's NEG_INF mask, its
    max(l, 1e-30) clamp and its hash dropout (l sums the undropped p).
    Returns (O in q's dtype, LSE [bh, sq, 1] float32)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    if causal:
        s = torch.where(rows + (sk - sq) >= cols, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        # a fully masked row has m == NEG_INF and exp(s - m) == 1
        p = torch.where(s == NEG_INF, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_p > 0.0:
        b = torch.arange(bh, device=q.device)[:, None, None]
        keep = _keep_mask(seed, b, rows, cols, sk, keep_thresh_u32(1.0 - dropout_p))
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_p)), 0.0)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    l = l.clamp_min(1e-30)
    return (o / l).to(q.dtype), m + torch.log(l)


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash attention: q, k and v must all be on the "
                         "same device")
    if q.device != k.device or q.device != v.device:
        raise ValueError("flash attention: q, k and v are on different cards")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError("flash attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward (the dq and dk/dv kernels) arrives with "
            "the BERT training slice; run the forward under torch.no_grad() "
            "or torch.inference_mode()")


def _fwd(q, k, v, seed, scale, causal, dropout_p):
    """q [bh, sq, d], k/v [bh, sk, d] -> (O [bh, sq, d], LSE [bh, sq, 1] f32).
    CUDA tensors launch the kernel; CPU tensors run ``mha_reference``."""
    global launches
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if not q.is_cuda:
        return mha_reference(q, k, v, seed, scale, causal, dropout_p)
    _check(q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _library()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, sq, sk, d, float(scale), int(bool(causal)), int(dropout_p > 0.0),
        int(seed) & U32, keep_thresh_u32(1.0 - dropout_p), 1.0 / (1.0 - dropout_p),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()} "
                           f"(cudaError {err})")
    launches += 1
    return o, lse


def mha(q, k, v, *, scale=None, causal=False, dropout_p=0.0, seed=None,
        block_q=256, block_k=256):
    """Flash attention. q, k, v: [batch, heads, seq, head_dim] (or 3-d
    [batch*heads, seq, head_dim]). Returns the same shape as q.

    ``dropout_p > 0`` drops attention probabilities inside the kernel with
    the counter-hash mask keyed by ``seed`` (an int; same seed -> same
    mask). ``block_q``/``block_k`` are kept for signature parity with the
    JAX package: the CUDA kernel chooses its own tiles."""
    del block_q, block_k
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    seed = 0 if seed is None else int(seed)
    o, _ = _fwd(q.reshape(b * h, sq, d), k.reshape(b * h, sk, d),
                v.reshape(b * h, sk, d), seed, float(scale), bool(causal),
                float(dropout_p))
    o = o.reshape(b, h, sq, d)
    return o[0] if squeeze else o
