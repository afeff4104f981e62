"""Flash (blockwise-softmax) attention: hand-written CUDA kernels for Hopper
(counterpart of paddle_tpu/ops/pallas/flash_attention.py).

Three kernels, as in the JAX package:

- ``_fwd`` launches K1, ``csrc/flash_attention_fwd.cu`` (O and LSE),
  optionally with per-batch-row key lengths read from device memory
  (``k_len``: the continuous-batching decode step, whose rows sit at
  different lengths in one KV pool);
- ``_bwd`` computes delta = rowsum(dO * O) in plain torch, as the
  reference does outside its kernels, then launches K2,
  ``csrc/flash_attention_bwd_dq.cu`` (dQ), and K3,
  ``csrc/flash_attention_bwd_dkv.cu`` (dK, dV). dQ has its own kernel, so
  nothing is accumulated with atomics and the gradients are the same run
  to run.

Each kernel has three forms: float32 (CUDA cores), bfloat16 and float16
(one tensor-core template instantiated for each 16-bit type), chosen by
q's dtype, as the reference's kernels work in their inputs' dtype.

``flash_attention_fwd`` and ``flash_attention_bwd`` are the two as
``torch.library`` custom ops (K1's gradient registered on it: the
reference's ``_flash`` custom_vjp), which ``mha`` and every captured
program (jit.save, to_static) call. CPU tensors run the plain PyTorch versions beside
the kernels (``mha_reference``, ``mha_bwd_reference``); CUDA tensors
launch the kernels or raise: a tensor the kernels do not take, a failed
build or a failed launch is an error, never a fallback. The kernels are
built at first use (core/cuda_build.py), never at import.
"""
import ctypes
import math
from typing import Optional, Tuple

import torch
# a custom op's first call imports torch._dynamo (~2 s): import it with the
# ops, so that cost is never a serving loop's first step
import torch._dynamo  # noqa: F401

from ..core import cuda_build
from ..core.random import U32, dp_offset, fmix32, keep_thresh_u32, mul32

NEG_INF = -1e30

HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: launches in this process of K1 (``_fwd``), K2 and K3 (``_bwd``); reset
#: them to count a run. A CUDA graph's replay runs no Python, so each replay
#: credits the launches its capture recorded (core/cuda_graph.py)
launches = 0
dq_launches = 0
dkv_launches = 0
#: the same launches by form: (kernel "fwd" | "dq" | "dkv", sq, sk, dtype
#: "float32" | "bfloat16" | "float16") -> count; clear it to count a run (a
#: graph's replay credits it too)
form_launches = {}
#: the same launches by form and mask: (kernel, sq, sk, dtype, causal) ->
#: count; cleared and credited as ``form_launches``
mask_launches = {}


def _count_form(kernel, sq, sk, dtype, causal):
    key = (kernel, sq, sk, str(dtype)[6:])
    form_launches[key] = form_launches.get(key, 0) + 1
    key += (bool(causal),)
    mask_launches[key] = mask_launches.get(key, 0) + 1

# library -> (number of pointer arguments of its launch function, the
# arguments it takes after the four dimensions: K1 takes K/V's batch-head
# stride, then its per-row key lengths (a device pointer or null) and the
# heads per batch row)
_LIBS = {"flash_attention_fwd": (5, [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]),
         "flash_attention_bwd_dq": (7, []), "flash_attention_bwd_dkv": (8, [])}
_libs = {}


def _library(name):
    lib = _libs.get(name)
    if lib is None:
        lib = cuda_build.load(name)
        fn = getattr(lib, name)
        n_ptrs, extra = _LIBS[name]
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + extra
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
               ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib_error = getattr(lib, name + "_error_string")
        lib_error.argtypes, lib_error.restype = [ctypes.c_int], ctypes.c_char_p
        lib_smem = getattr(lib, name + "_smem_bytes")
        # (head_dim, dtype code): each library's f32 form and its 16-bit
        # forms are separate kernels with their own shared memory
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


def _scores(q, k, scale, causal, k_len=None, heads=1):
    """f32 S = Q K^T * scale with the kernels' NEG_INF masks (causal,
    bottom-right over the operand's sk; keys at or past ``k_len[bh //
    heads]``), and the (rows, cols) index grids."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    if causal:
        s = torch.where(rows + (sk - sq) >= cols, s, NEG_INF)
    if k_len is not None:
        lens = _row_lengths(k_len, q.shape[0], heads, q.device)
        s = torch.where(cols < lens[:, None, None], s, NEG_INF)
    return s, rows, cols


def _row_lengths(k_len, bh, heads, device):
    """int64 [bh]: each batch-head's key length from ``k_len`` [bh / heads]."""
    lens = torch.as_tensor(k_len, device=device).long().reshape(-1)
    if heads < 1 or lens.numel() * heads != bh:
        raise ValueError(f"k_len of {lens.numel()} rows x {heads} heads does not "
                         f"cover {bh} batch-heads")
    return lens.repeat_interleave(heads)


def _dropout_keep(seed, bh, rows, cols, sk, dropout_p, bh_offset=0):
    # batch-head i hashes as bh_offset + i: its index in the global batch
    b = torch.arange(bh_offset, bh_offset + bh, device=rows.device)[:, None, None] & U32
    return _keep_mask(seed, b, rows, cols, sk, keep_thresh_u32(1.0 - dropout_p))


def mha_reference(q, k, v, seed=0, scale=None, causal=False, dropout_p=0.0, k_len=None,
                  heads=1, bh_offset=0):
    """Plain PyTorch version of K1 on [bh, seq, d] tensors: the whole
    softmax at once, with the kernel's NEG_INF masks, its max(l, 1e-30)
    clamp and its hash dropout (l sums the undropped p). ``k_len`` (int
    [bh / heads], or None) masks each batch row's keys at or past its
    length, as K1's length form does. ``bh_offset`` is added to each
    batch-head's index before the dropout hash, as in the kernels.
    Returns (O in q's dtype, LSE [bh, sq, 1] float32)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _check_lengths(k_len, dropout_p)
    if k_len is not None:
        # rows past a length count as zeros, as K1 zero-fills them instead
        # of reading them: a stale NaN there must not reach P V
        keys = torch.arange(sk, device=q.device)
        v = torch.where((keys < _row_lengths(k_len, bh, heads, q.device)[:, None])[..., None],
                        v, torch.zeros((), dtype=v.dtype, device=v.device))
    s, rows, cols = _scores(q, k, scale, causal, k_len, heads)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal or k_len is not None:
        # a fully masked row has m == NEG_INF and exp(s - m) == 1
        p = torch.where(s == NEG_INF, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_p > 0.0:
        keep = _dropout_keep(seed, bh, rows, cols, sk, dropout_p, bh_offset)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_p)), 0.0)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    l = l.clamp_min(1e-30)
    return (o / l).to(q.dtype), m + torch.log(l)


def mha_bwd_reference(q, k, v, o, lse, do, seed=0, scale=None, causal=False,
                      dropout_p=0.0, bh_offset=0):
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
        keep = _dropout_keep(seed, bh, rows, cols, sk, dropout_p, bh_offset)
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
        raise TypeError("flash attention kernel takes float32, bfloat16 or float16 "
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


def _kv_operand(t):
    """K or V for K1 as (tensor, batch-head stride in elements). A
    [bh, sk, d] tensor whose rows are contiguous and whose heads start a
    multiple of 16 bytes apart, on a 16-byte boundary, goes to the kernel
    as it lies: the first sk rows of a longer cache are read in place.
    Anything else is made contiguous and aligned (``_aligned``) first."""
    bh, sk, d = t.shape
    rows_ok = t.stride(2) == 1 and (sk == 1 or t.stride(1) == d)
    stride = t.stride(0) if bh > 1 else sk * d
    if rows_ok and (stride * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0:
        return t, stride
    (t,) = _aligned(t)
    return t, sk * d


def _check_dropout(dropout_p):
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")


def _check_lengths(k_len, dropout_p):
    # the dropout hash is keyed by the operand's width, which the length
    # form promises not to depend on
    if k_len is not None and dropout_p > 0.0:
        raise ValueError("per-row key lengths (k_len) take no dropout")


def _kernel_args(seed, scale, causal, dropout_p, dtype, device, bh_offset=0):
    if not 0 <= bh_offset < 2**31:
        raise ValueError(f"flash attention: bh_offset {bh_offset} is not in [0, 2**31)")
    return (float(scale), int(bool(causal)), int(dropout_p > 0.0), int(seed) & U32,
            keep_thresh_u32(1.0 - dropout_p), 1.0 / (1.0 - dropout_p), int(bh_offset),
            _DTYPE_CODES[dtype], torch.cuda.current_stream(device).cuda_stream)


def _fwd(q, k, v, seed, scale, causal, dropout_p, k_len=None, heads=1, bh_offset=0):
    """q [bh, sq, d], k/v [bh, sk, d] -> (O [bh, sq, d], LSE [bh, sq, 1] f32).
    CUDA tensors launch K1; CPU tensors run ``mha_reference``. K and V may
    be prefix views of a longer buffer (``_kv_operand``). ``k_len``: None,
    or int32 [bh / heads] key lengths per batch row, read by K1 from
    device memory (a row sees keys < its length). ``bh_offset``: the first
    batch-head's index in the global batch, which the dropout hash takes
    (a data-parallel rank's slice; 0 otherwise)."""
    global launches
    _check_dropout(dropout_p)
    _check_lengths(k_len, dropout_p)
    if not q.is_cuda:
        return mha_reference(q, k, v, seed, scale, causal, dropout_p, k_len, heads, bh_offset)
    _check(q, k, v)
    k_len_ptr = None
    if k_len is not None:
        if not (isinstance(k_len, torch.Tensor) and k_len.device == q.device
                and k_len.dtype == torch.int32):
            raise TypeError("flash attention: k_len must be an int32 tensor on q's card")
        if heads < 1 or k_len.numel() * heads != q.shape[0]:
            raise ValueError(f"k_len of {k_len.numel()} rows x {heads} heads does not "
                             f"cover {q.shape[0]} batch-heads")
        k_len = k_len.contiguous()
        k_len_ptr = k_len.data_ptr()
    bh, sq, d = q.shape
    sk = k.shape[1]
    (q,) = _aligned(q)
    k, k_stride = _kv_operand(k)
    v, v_stride = _kv_operand(v)
    if v_stride != k_stride:  # one stride serves both
        (k,), (v,) = _aligned(k), _aligned(v)
        k_stride = sk * d
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    _launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, sq, sk, d, k_stride, k_len_ptr, int(heads),
            *_kernel_args(seed, scale, causal, dropout_p, q.dtype, q.device, bh_offset))
    launches += 1
    _count_form("fwd", sq, sk, q.dtype, causal)
    return o, lse


def _bwd(q, k, v, o, lse, do, seed, scale, causal, dropout_p, bh_offset=0):
    """Gradients of ``_fwd`` from its saved O and LSE: (dQ, dK, dV) in the
    inputs' dtypes. CUDA tensors launch K2 and K3; CPU tensors run
    ``mha_bwd_reference``. ``bh_offset``: as in ``_fwd``."""
    global dq_launches, dkv_launches
    _check_dropout(dropout_p)
    if not q.is_cuda:
        return mha_bwd_reference(q, k, v, o, lse, do, seed, scale, causal, dropout_p,
                                 bh_offset)
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
    args = _kernel_args(seed, scale, causal, dropout_p, q.dtype, q.device, bh_offset)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    _launch("flash_attention_bwd_dq", *ptrs, dq.data_ptr(), bh, sq, sk, d, *args)
    dq_launches += 1
    _count_form("dq", sq, sk, q.dtype, causal)
    _launch("flash_attention_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d,
            *args)
    dkv_launches += 1
    _count_form("dkv", sq, sk, q.dtype, causal)
    return dq, dk, dv


# The kernels as torch.library custom ops: a fake (meta) implementation
# gives their output shapes without launching, so torch.export can capture
# a model that runs them (jit.save, to_static) and a captured program still
# calls the real implementation, which launches and counts. K1's gradient
# is registered on its op (K2 + K3 through the backward op), so a captured
# training step differentiates through the kernels too.

@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seed: Optional[torch.Tensor], scale: float, causal: bool,
                        dropout_p: float, k_len: Optional[torch.Tensor] = None,
                        heads: int = 1, bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as an op: ``_fwd`` on [bh, sq, d] tensors -> (O, LSE). ``seed``:
    the dropout seed as an int64 scalar tensor on the host (a captured
    training step feeds it from its key table), or None for 0.
    ``bh_offset`` defaults to 0, so a program saved before it existed
    loads and runs as it did."""
    args = (q, k, v, 0 if seed is None else int(seed), scale, causal, dropout_p)
    if k_len is None:
        return _fwd(*args, bh_offset=bh_offset)
    return _fwd(*args, k_len=k_len, heads=heads, bh_offset=bh_offset)


@flash_attention_fwd.register_fake
def _(q, k, v, seed, scale, causal, dropout_p, k_len=None, heads=1, bh_offset=0):
    bh, sq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((bh, sq, 1), dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, seed: Optional[torch.Tensor],
                        scale: float, causal: bool,
                        dropout_p: float,
                        bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 then K3 as an op: ``_bwd`` -> (dQ, dK, dV)."""
    return _bwd(q, k, v, o, lse, do.to(q.dtype), 0 if seed is None else int(seed), scale,
                causal, dropout_p, bh_offset)


@flash_attention_bwd.register_fake
def _(q, k, v, o, lse, do, seed, scale, causal, dropout_p, bh_offset=0):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _fwd_setup(ctx, inputs, output):
    q, k, v, seed, scale, causal, dropout_p, k_len, _, bh_offset = inputs
    ctx.k_len = k_len is not None
    ctx.save_for_backward(q, k, v, output[0], output[1], seed)
    ctx.cfg = (scale, causal, dropout_p, bh_offset)


def _fwd_backward(ctx, do, _dlse):
    """The reference's ``_flash`` custom_vjp backward: K2 + K3 from the
    saved (q, k, v, o, lse, seed); LSE's gradient is not taken."""
    if ctx.k_len:
        raise NotImplementedError("k_len is a forward-only form of the kernel")
    q, k, v, o, lse, seed = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, seed, *ctx.cfg)
    return dq, dk, dv, None, None, None, None, None, None, None


flash_attention_fwd.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def _seed_tensor(seed):
    """The dropout seed as the op takes it: None for no seed, a tensor as
    it is (a captured key word), an int as an int64 host scalar."""
    if seed is None or isinstance(seed, torch.Tensor):
        return seed
    return torch.tensor(int(seed), dtype=torch.int64)


def mha(q, k, v, *, scale=None, causal=False, dropout_p=0.0, seed=None,
        block_q=256, block_k=256, k_len=None):
    """Flash attention. q, k, v: [batch, heads, seq, head_dim] (or 3-d
    [batch*heads, seq, head_dim]). Returns the same shape as q, with a
    gradient through K2 and K3 where an input requires one.

    ``dropout_p > 0`` drops attention probabilities inside the kernels with
    the counter-hash mask keyed by ``seed`` (an int; same seed -> same
    mask). Inside a data-parallel step (``core.random.dp_shard_guard``) the
    mask is this rank's slice of the global batch's: K1-K3 take
    ``bh_offset`` = rank * local batch * heads. ``k_len`` (int32 [batch] on
    q's device, forward only, no dropout): batch row b sees only its keys
    j < k_len[b]. ``block_q``/
    ``block_k`` are kept for signature parity with the JAX package: the
    CUDA kernels choose their own tiles."""
    del block_q, block_k
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if k_len is not None:
        if q.requires_grad or k.requires_grad or v.requires_grad:
            if torch.is_grad_enabled():
                raise NotImplementedError("k_len is a forward-only form of the kernel")
        if not isinstance(k_len, torch.Tensor):
            k_len = torch.as_tensor(k_len)
    bh_offset = dp_offset((b,), h) if dropout_p > 0.0 else 0
    o, _ = flash_attention_fwd(q.reshape(b * h, sq, d), k.reshape(b * h, sk, d),
                               v.reshape(b * h, sk, d), _seed_tensor(seed), float(scale),
                               bool(causal), float(dropout_p), k_len,
                               h if k_len is not None else 1, bh_offset)
    o = o.reshape(b, h, sq, d)
    return o[0] if squeeze else o
