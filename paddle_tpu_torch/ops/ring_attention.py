"""Ring attention: exact attention over sequence-sharded q/k/v
(counterpart of paddle_tpu/ops/ring_attention.py).

The port's collectives are per rank, so both entry points take this
rank's local sequence shard ``[B, H, S_local, D]`` (the reference's take
the global arrays, which its ``shard_map`` splits) and give the rank's
shard of the output. The ring is the mesh's ``axis_name`` axis ("sp"):
``n`` ranks, rank ``r`` holding positions ``[r * S_local, (r + 1) *
S_local)``.

The forward (``RingAttention``) is n - 1 hops of the K/V blocks one rank
to the right (``collective.ppermute``; over gloo a CUDA tensor goes
through the host). At step i the rank holds the block of rank ``(r - i)
mod n`` and runs it through K1 (``flash_attention._fwd``), which returns
the block's O and LSE; the blocks combine exactly by their LSE. Causal:
step 0 is the rank's own diagonal block (K1 causal, so every row's LSE is
finite from then on); a block of an earlier rank is unmasked (K1
non-causal), and a block of a later rank is fully masked, adds exactly 0
(alpha = 1) and is skipped. The backward runs K2 and K3
(``flash_attention._bwd``) on each block with the global O and LSE, which
gives each block's exact gradient; dQ sums on the rank and each block's
dK/dV travel the ring with it, with one more hop back to the rank that owns
the block. On CPU tensors K1-K3 run their plain versions, on CUDA tensors
the kernels; nothing falls back to plain attention on the card. Each
hop's seconds on the host clock are appended to ``hop_seconds``, which
every call empties first: it holds the last call's hops, forward and
backward.

``ring_attention_reference`` is the plain version: the reference's
online-softmax fold (ring_attention.py:33-88) transcribed in float32 torch,
its hops a differentiable permute; with one shard, ``_ring_attn_local``.
"""
import contextlib
import contextvars
import math
import time

import torch

from ..distributed import collective
from . import flash_attention as fa

NEG = -1e30

#: the seconds of each hop of the last call (K/V forward, K/V and dK/dV
#: backward)
hop_seconds = []

_SHARD_MESH = contextvars.ContextVar("ring_shard_mesh", default=None)


def _ring(mesh, axis_name):
    """The ring: ``mesh``'s ``axis_name`` axis (one rank where ``mesh`` is
    None)."""
    from ..distributed import topology

    return topology.AxisGroup(mesh if mesh is not None else topology.Mesh((1,) * 6), axis_name)


def _hop(ring, t, back=False):
    """``t`` of the rank to the left (``back``: to the right)."""
    n = ring.n
    perm = [((i + 1) % n, i) if back else (i, (i + 1) % n) for i in range(n)]
    t0 = time.perf_counter()
    out = collective.ppermute(t.contiguous(), ring.group, perm)
    hop_seconds.append(time.perf_counter() - t0)
    return out


@contextlib.contextmanager
def shard_scope(mesh):
    """Inside it ``ring_attention_in_shard_map`` rings over ``mesh`` (the
    pipeline's stage interior, whose trunk is sequence-sharded over
    "sp"); outside it that call is local attention, as the reference's
    outside a manual context."""
    token = _SHARD_MESH.set(mesh)
    try:
        yield
    finally:
        _SHARD_MESH.reset(token)


def _flat(t):
    b, h, s, d = t.shape
    return t.reshape(b * h, s, d)


class RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, scale, causal):
        b, h, s, d = q.shape
        q3, k3, v3 = _flat(q), _flat(k), _flat(v)
        kv = torch.stack([k3, v3])
        o = lse = None
        for i in range(ring.n):
            if i:
                kv = _hop(ring, kv)
            src = (ring.rank - i) % ring.n
            if causal and src > ring.rank:
                continue  # fully masked: adds exactly 0
            o_i, lse_i = fa._fwd(q3, kv[0], kv[1], 0, scale, causal and i == 0, 0.0)
            if o is None:
                o, lse = o_i.float(), lse_i
                continue
            m = torch.maximum(lse, lse_i)
            a, c = torch.exp(lse - m), torch.exp(lse_i - m)
            o = (o * a + o_i.float() * c) / (a + c)
            lse = m + torch.log(a + c)
        o = o.to(q.dtype)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.cfg = (ring, scale, causal, (b, h, s, d))
        return o.reshape(b, h, s, d)

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        ring, scale, causal, shape = ctx.cfg
        do3 = _flat(do.to(q3.dtype))
        dq = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
        kv = torch.stack([k3, v3])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
        for i in range(ring.n):
            if i:
                kv, dkv = _hop(ring, kv), _hop(ring, dkv)
            src = (ring.rank - i) % ring.n
            if causal and src > ring.rank:
                continue
            dq_i, dk_i, dv_i = fa._bwd(q3, kv[0], kv[1], o, lse, do3, 0, scale,
                                       causal and i == 0, 0.0)
            dq += dq_i.float()
            dkv[0] += dk_i.float()
            dkv[1] += dv_i.float()
        if ring.n > 1:
            dkv = _hop(ring, dkv)  # each block's gradient back to its owner
        return (dq.to(q3.dtype).reshape(shape), dkv[0].to(k3.dtype).reshape(shape),
                dkv[1].to(v3.dtype).reshape(shape), None, None, None)


def _check(q, k, v):
    if not (q.dim() == k.dim() == v.dim() == 4) or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"ring attention takes q, k, v of one shape [B, H, S_local, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _run(q, k, v, ring, scale, causal):
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    hop_seconds.clear()
    return RingAttention.apply(q, k, v, ring, float(scale), bool(causal))


def ring_attention(q, k, v, mesh=None, axis_name="sp", scale=None, causal=False):
    """Exact attention of this rank's sequence shard of q over the whole
    ring's keys. q, k, v: [batch, heads, S_local, head_dim], the rank's
    positions of the global sequence; the shard count is ``mesh``'s (the
    global mesh's by default) ``axis_name`` axis."""
    from ..distributed import topology

    return _run(q, k, v, _ring(mesh or topology.get_global_mesh(), axis_name), scale, causal)


def ring_attention_in_shard_map(q, k, v, axis_name="sp", scale=None, causal=False):
    """Ring attention for code inside a sequence-sharded region (a
    pipeline stage's interior, ``shard_scope``): the ring is the scope's
    mesh's ``axis_name`` axis. Outside a scope (or with one shard) it is
    local attention, the reference's one-device oracle (through K1 on the
    card)."""
    return _run(q, k, v, _ring(_SHARD_MESH.get(), axis_name), scale, causal)


class _Permute(torch.autograd.Function):
    """A hop to the right; its gradient hops back to the left."""

    @staticmethod
    def forward(ctx, t, ring):
        ctx.ring = ring
        return _hop(ring, t)

    @staticmethod
    def backward(ctx, g):
        return _hop(ctx.ring, g, back=True), None


def _ring_attn_local(q, k, v, *, scale, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None]
        s = torch.where(rows + (sk - sq) >= cols, s, torch.full((), NEG, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ring_attention_reference(q, k, v, mesh=None, axis_name="sp", scale=None, causal=False):
    """The plain version of ``ring_attention``: the reference's fold in
    float32, differentiable (torch autograd through its hops)."""
    from ..distributed import topology

    _check(q, k, v)
    ring = _ring(mesh or topology.get_global_mesh(), axis_name)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if ring.n == 1:
        return _ring_attn_local(q, k, v, scale=scale, causal=causal)
    hop_seconds.clear()
    s_local = q.shape[2]
    qf = q.float() * scale
    m = torch.full(q.shape[:3] + (1,), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:3] + (1,), dtype=torch.float32, device=q.device)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    rows = ring.rank * s_local + torch.arange(s_local, device=q.device)[:, None]
    k_blk, v_blk = k, v
    for i in range(ring.n):
        if i:
            k_blk, v_blk = _Permute.apply(k_blk, ring), _Permute.apply(v_blk, ring)
        src = (ring.rank - i) % ring.n
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float())
        if causal:
            cols = src * s_local + torch.arange(s_local, device=q.device)[None]
            s = torch.where(rows >= cols, s, torch.full((), NEG, device=s.device))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_blk.float())
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
