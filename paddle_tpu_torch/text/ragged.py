"""Ragged-sequence helpers, the LoD replacement (counterpart of
paddle_tpu/text/ragged.py).

The reference threads ragged batches through LoDTensor
(paddle/fluid/framework/lod_tensor.h:109) and the sequence_* ops; the
representation here is the JAX package's: a dense padded tensor and its
lengths, with mask-aware reductions. ``sequence_expand``'s width and the
packing ops (``sequence_concat``, ``sequence_pad``, ``sequence_unpad``)
read their lengths on the host, as the reference does, so a recording
Program keeps their build-time values.
"""
import numpy as np
import torch

from ..core.tensor import Tensor, boundary, to_tensor


def _host(x):
    return np.asarray(Tensor.numpy(x) if isinstance(x, torch.Tensor) else x)


def pad_sequences(seqs, maxlen=None, dtype="int64", pad_value=0):
    """list of 1-D arrays -> (padded [B, L], lengths [B])."""
    lengths = np.asarray([len(s) for s in seqs], np.int64)
    maxlen = maxlen or int(lengths.max())
    out = np.full((len(seqs), maxlen), pad_value, np.dtype(dtype))
    for i, s in enumerate(seqs):
        n = min(len(s), maxlen)
        out[i, :n] = np.asarray(s[:n])
    return to_tensor(out), to_tensor(np.minimum(lengths, maxlen))


@boundary
def length_mask(lengths, maxlen, dtype="float32"):
    from ..core.dtype import convert_dtype

    r = torch.arange(int(maxlen), device=lengths.device)
    return (r[None, :] < lengths[:, None]).to(convert_dtype(dtype))


@boundary
def sequence_pool(x, lengths, pool_type="sum"):
    """Masked pooling over the time axis (reference: sequence_pool_op)."""
    t = x.shape[1]
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    m = mask[..., None].to(x.dtype) if x.dim() == 3 else mask.to(x.dtype)

    def per_row(v):
        return v[:, None] if x.dim() == 3 else v

    if pool_type == "sum":
        return torch.sum(x * m, dim=1)
    if pool_type in ("average", "mean"):
        return torch.sum(x * m, dim=1) / per_row(torch.clamp(lengths.to(x.dtype), min=1))
    if pool_type == "max":
        return torch.amax(torch.where(m > 0, x, torch.finfo(x.dtype).min), dim=1)
    if pool_type == "sqrt":
        return torch.sum(x * m, dim=1) / per_row(torch.sqrt(
            torch.clamp(lengths.to(x.dtype), min=1)))
    if pool_type == "last":
        idx = torch.clamp(lengths - 1, 0, t - 1).long()
        return x[torch.arange(x.shape[0], device=x.device), idx]
    if pool_type == "first":
        return x[:, 0]
    raise ValueError(pool_type)


@boundary
def attention_mask_from_lengths(lengths, maxlen):
    """[B] lengths -> additive [B, 1, 1, L] mask (0 keep / float32 min
    drop)."""
    keep = torch.arange(int(maxlen), device=lengths.device)[None, :] < lengths[:, None]
    m = torch.where(keep, 0.0, torch.finfo(torch.float32).min).to(torch.float32)
    return m[:, None, None, :]


@boundary
def sequence_reverse(x, lengths):
    """Reverse each sequence within its length (reference:
    sequence_ops/sequence_reverse_op.cc; dense [B, T, ...] + lengths)."""
    t = x.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    src = lengths[:, None].long() - 1 - idx
    src = torch.where(idx < lengths[:, None], src, idx)  # the padding stays
    if x.dim() > 2:
        src = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, src)


@boundary
def sequence_softmax(x, lengths):
    """Masked softmax per sequence (reference: sequence_ops/
    sequence_softmax_op.cc): the padding gets 0."""
    t = x.shape[1]
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    p = torch.softmax(torch.where(mask, x, -torch.inf).float(), dim=1)
    return torch.where(mask, p, 0.0).to(x.dtype)


@boundary
def _expand(x, ref, maxlen):
    mask = torch.arange(maxlen, device=x.device)[None, :] < ref[:, None]
    rep = x[:, None].expand((x.shape[0], maxlen) + tuple(x.shape[1:]))
    return rep * mask.reshape(mask.shape + (1,) * (x.dim() - 1)).to(x.dtype)


def sequence_expand(x, lengths, ref_lengths):
    """Row i of x repeated ref_lengths[i] times along a new time axis,
    padded to max(ref_lengths) (reference: sequence_ops/
    sequence_expand_op.cc)."""
    return _expand(x, ref_lengths, int(np.max(_host(ref_lengths))))


def sequence_concat(xs, lengths_list):
    """Ragged sequences concatenated row by row (reference:
    sequence_ops/sequence_concat_op.cc): row b holds x1[b, :l1[b]] ++
    x2[b, :l2[b]] ++ ..., padded to the longest total."""
    arrs = [_host(x) for x in xs]
    lens = [_host(v) for v in lengths_list]
    total = np.stack(lens).sum(0)
    b = arrs[0].shape[0]
    out = np.zeros((b, int(total.max())) + arrs[0].shape[2:], arrs[0].dtype)
    for bi in range(b):
        pos = 0
        for a, n in zip(arrs, lens):
            out[bi, pos:pos + int(n[bi])] = a[bi, :int(n[bi])]
            pos += int(n[bi])
    return to_tensor(out), to_tensor(total.astype(np.int32))


def sequence_pad(x_rows, lengths, maxlen=None, pad_value=0.0):
    """Packed rows [sum(len), ...] + lengths -> dense [B, T, ...]
    (reference: sequence_ops/sequence_pad_op.cc)."""
    lens = _host(lengths).astype(np.int64)
    arr = _host(x_rows)
    t = int(maxlen or lens.max())
    out = np.full((len(lens), t) + arr.shape[1:], pad_value, arr.dtype)
    pos = 0
    for i, n in enumerate(lens):
        out[i, :n] = arr[pos:pos + int(n)]
        pos += int(n)
    return to_tensor(out)


def sequence_unpad(x, lengths):
    """Dense [B, T, ...] + lengths -> packed rows (reference:
    sequence_ops/sequence_unpad_op.cc)."""
    lens = _host(lengths).astype(np.int64)
    arr = _host(x)
    return to_tensor(np.concatenate([arr[i, :int(n)] for i, n in enumerate(lens)], axis=0))


__all__ = ["pad_sequences", "length_mask", "sequence_pool", "attention_mask_from_lengths",
           "sequence_reverse", "sequence_softmax", "sequence_expand", "sequence_concat",
           "sequence_pad", "sequence_unpad"]
