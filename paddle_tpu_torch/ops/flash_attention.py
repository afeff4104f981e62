"""Flash (blockwise-softmax) attention: hand-written CUDA kernels for Hopper
(counterpart of paddle_tpu/ops/pallas/flash_attention.py).

Three kernels, as in the JAX package:

- ``_fwd`` launches K1, ``csrc/flash_attention_fwd.cu`` (O and LSE);
- ``_bwd`` computes delta = rowsum(dO * O) in plain torch, as the
  reference does outside its kernels, then launches K2,
  ``csrc/flash_attention_bwd_dq.cu`` (dQ), and K3,
  ``csrc/flash_attention_bwd_dkv.cu`` (dK, dV). dQ has its own kernel, so
  nothing is accumulated with atomics and the gradients are the same run
  to run.

``_FlashAttention`` (the reference's ``_flash`` custom_vjp) ties them
together for autograd. CPU tensors run the plain PyTorch versions beside
the kernels (``mha_reference``, ``mha_bwd_reference``); CUDA tensors
launch the kernels or raise: a tensor the kernels do not take, a failed
build or a failed launch is an error, never a fallback. The kernels are
built at first use (core/cuda_build.py), never at import.
"""
import ctypes
import math

import torch

from ..core import cuda_build
from ..core.random import U32, fmix32, keep_thresh_u32, mul32

NEG_INF = -1e30

HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: launches in this process of K1 (``_fwd``), K2 and K3 (``_bwd``); reset
#: them to count a run
launches = 0
dq_launches = 0
dkv_launches = 0

# library -> number of pointer arguments of its launch function
_LIBS = {"flash_attention_fwd": 5, "flash_attention_bwd_dq": 7,
         "flash_attention_bwd_dkv": 8}
_libs = {}


def _library(name):
    lib = _libs.get(name)
    if lib is None:
        lib = cuda_build.load(name)
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * _LIBS[name] + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
               ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib_error = getattr(lib, name + "_error_string")
        lib_error.argtypes, lib_error.restype = [ctypes.c_int], ctypes.c_char_p
        lib_smem = getattr(lib, name + "_smem_bytes")
        # (head_dim, dtype code): each library's f32 and bf16 forms are
        # separate kernels with their own shared memory
        lib_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib_smem.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def smem_bytes(head_dim, kernel="flash_attention_fwd", dtype=torch.float32):
    """Dynamic shared memory one block of ``kernel`` (a library name of
    ``_LIBS``) takes for ``head_dim`` and ``dtype``."""
    fn = getattr(_library(kernel), kernel + "_smem_bytes")
    return fn(int(head_dim), _DTYPE_CODES[dtype])


def _launch(name, *args):
    lib = _library(name)
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = getattr(lib, name + "_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")


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


def _scores(q, k, scale, causal):
    """f32 S = Q K^T * scale with the kernels' NEG_INF causal mask, and the
    (rows, cols) index grids."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    if causal:
        s = torch.where(rows + (sk - sq) >= cols, s, NEG_INF)
    return s, rows, cols


def _dropout_keep(seed, bh, rows, cols, sk, dropout_p):
    b = torch.arange(bh, device=rows.device)[:, None, None]
    return _keep_mask(seed, b, rows, cols, sk, keep_thresh_u32(1.0 - dropout_p))


def mha_reference(q, k, v, seed=0, scale=None, causal=False, dropout_p=0.0):
    """Plain PyTorch version of K1 on [bh, seq, d] tensors: the whole
    softmax at once, with the kernel's NEG_INF mask, its max(l, 1e-30)
    clamp and its hash dropout (l sums the undropped p).
    Returns (O in q's dtype, LSE [bh, sq, 1] float32)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s, rows, cols = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        # a fully masked row has m == NEG_INF and exp(s - m) == 1
        p = torch.where(s == NEG_INF, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_p > 0.0:
        keep = _dropout_keep(seed, bh, rows, cols, sk, dropout_p)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_p)), 0.0)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    l = l.clamp_min(1e-30)
    return (o / l).to(q.dtype), m + torch.log(l)


def mha_bwd_reference(q, k, v, o, lse, do, seed=0, scale=None, causal=False,
                      dropout_p=0.0):
    """Plain PyTorch version of K2 and K3 on [bh, seq, d] tensors: the
    kernels' formulas over the whole [sq, sk] at once, from the saved LSE
    ([bh, sq, 1] f32). P = exp(S - LSE) with NEG_INF masking (zeroed where
    masked, so a fully masked row gives zero gradients), the forward's hash
    dropout on P and dP, dS and P_dropped rounded to the input dtype before
    their products as the kernels do. Returns (dQ, dK, dV) in the inputs'
    dtypes."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    do32 = do.float()
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    s, rows, cols = _scores(q, k, scale, causal)
    p = torch.exp(s - lse)
    if causal:
        p = torch.where(s == NEG_INF, 0.0, p)
    dp = torch.einsum("bqd,bkd->bqk", do32, v.float())
    p_d = p
    if dropout_p > 0.0:
        keep = _dropout_keep(seed, bh, rows, cols, sk, dropout_p)
        inv = 1.0 / (1.0 - dropout_p)
        p_d = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    dv = torch.einsum("bqk,bqd->bkd", p_d.to(do.dtype).float(), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, *more):
    if not (q.is_cuda and k.is_cuda and v.is_cuda and all(t.is_cuda for t in more)):
        raise ValueError("flash attention: q, k and v must all be on the "
                         "same device")
    if any(t.device != q.device for t in (k, v, *more)):
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


def _aligned(*ts):
    """The tensors, contiguous, each copied once more where its data does
    not start on a 16-byte boundary (the kernels stage rows with 16-byte
    copies; a view into another tensor can start anywhere)."""
    out = []
    for t in ts:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def _check_dropout(dropout_p):
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")


def _kernel_args(seed, scale, causal, dropout_p, dtype, device):
    return (float(scale), int(bool(causal)), int(dropout_p > 0.0), int(seed) & U32,
            keep_thresh_u32(1.0 - dropout_p), 1.0 / (1.0 - dropout_p),
            _DTYPE_CODES[dtype], torch.cuda.current_stream(device).cuda_stream)


def _fwd(q, k, v, seed, scale, causal, dropout_p):
    """q [bh, sq, d], k/v [bh, sk, d] -> (O [bh, sq, d], LSE [bh, sq, 1] f32).
    CUDA tensors launch K1; CPU tensors run ``mha_reference``."""
    global launches
    _check_dropout(dropout_p)
    if not q.is_cuda:
        return mha_reference(q, k, v, seed, scale, causal, dropout_p)
    _check(q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    q, k, v = _aligned(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    _launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
            *_kernel_args(seed, scale, causal, dropout_p, q.dtype, q.device))
    launches += 1
    return o, lse


def _bwd(q, k, v, o, lse, do, seed, scale, causal, dropout_p):
    """Gradients of ``_fwd`` from its saved O and LSE: (dQ, dK, dV) in the
    inputs' dtypes. CUDA tensors launch K2 and K3; CPU tensors run
    ``mha_bwd_reference``."""
    global dq_launches, dkv_launches
    _check_dropout(dropout_p)
    if not q.is_cuda:
        return mha_bwd_reference(q, k, v, o, lse, do, seed, scale, causal, dropout_p)
    _check(q, k, v, o, lse, do)
    if do.dtype != q.dtype or o.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"flash attention backward: dO {do.dtype} and O {o.dtype} must "
                        f"be q's dtype {q.dtype}, LSE float32 (got {lse.dtype})")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (bh, sq, 1):
        raise ValueError(f"flash attention backward: O {tuple(o.shape)}, dO "
                         f"{tuple(do.shape)}, LSE {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    q, k, v, do = _aligned(q, k, v, do)
    lse = lse.contiguous()
    # delta = rowsum(dO * O) in f32, outside the kernels as in the reference
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    args = _kernel_args(seed, scale, causal, dropout_p, q.dtype, q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    _launch("flash_attention_bwd_dq", *ptrs, dq.data_ptr(), bh, sq, sk, d, *args)
    dq_launches += 1
    _launch("flash_attention_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d,
            *args)
    dkv_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom_vjp: K1 forward saving
    (q, k, v, o, lse, seed), K2 + K3 backward."""

    @staticmethod
    def forward(ctx, q, k, v, seed, scale, causal, dropout_p):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _fwd(q, k, v, seed, scale, causal, dropout_p)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (seed, scale, causal, dropout_p)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do.to(q.dtype), *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def mha(q, k, v, *, scale=None, causal=False, dropout_p=0.0, seed=None,
        block_q=256, block_k=256):
    """Flash attention. q, k, v: [batch, heads, seq, head_dim] (or 3-d
    [batch*heads, seq, head_dim]). Returns the same shape as q, with a
    gradient through K2 and K3 where an input requires one.

    ``dropout_p > 0`` drops attention probabilities inside the kernels with
    the counter-hash mask keyed by ``seed`` (an int; same seed -> same
    mask). ``block_q``/``block_k`` are kept for signature parity with the
    JAX package: the CUDA kernels choose their own tiles."""
    del block_q, block_k
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    seed = 0 if seed is None else int(seed)
    args = (q.reshape(b * h, sq, d), k.reshape(b * h, sk, d), v.reshape(b * h, sk, d),
            seed, float(scale), bool(causal), float(dropout_p))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o = _FlashAttention.apply(*args)
    else:
        o, _ = _fwd(*args)
    o = o.reshape(b, h, sq, d)
    return o[0] if squeeze else o
