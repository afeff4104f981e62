"""Mixture-of-Experts with expert parallelism over the "ep" mesh axis
(counterpart of paddle_tpu/incubate/moe.py).

``MoELayer(hidden_size, ffn_hidden, num_experts, top_k=2, ...)``: a
top-k gated expert FFN block, [B, S, H] -> [B, S, H], with the
reference's parameters (``gate`` a Linear [H, E], ``w_up [E, H, F]``,
``w_down [E, F, H]``, the experts' ``mp_spec = ("ep",)``) and its three
dispatch modes, as plain products (the reference leaves them to XLA):

- ``dense``: every expert's FFN on every token, the top-k gate mask
  zeroing the rest;
- ``capacity`` (GShard/Switch): each expert takes at most
  ``C = ceil(capacity_factor * k * N / E)`` tokens, which claim its slots
  in token order, choice 0 before choice 1; a token past C drops that
  expert (``capacity_combine``);
- ``alltoall``: tokens split over the data axes x ep (GShard's groups),
  each group routing its own tokens into [E, C, H] buffers that
  ``AllToAll`` exchanges over ep, so each rank's experts see every
  group's tokens for them.

``dispatch_mode="auto"`` picks capacity at E >= 8, dense below. The
top-k is jax's: on a tie the lower expert index wins (a stable sort).
GELU is jax's tanh form. The GShard aux loss (``aux_weight`` times it)
goes through ``nn.aux_loss.emit_aux_loss``.

Inside a training step over an "ep" axis (``distributed.
expert_parallel``), a rank holds E/ep experts: dense and capacity modes
run the rank's experts on the (ep-replicated) tokens and sum the experts'
outputs over the ep group (the reference's psum over the expert
contraction; the tokens and gates enter through ``CopyToMP``, whose
backward sums their gradients over ep); alltoall takes the rank's ep
shard of its tokens, exchanges the buffers over ep and all-gathers the
output. Where the forward is the global program over several data ranks
the capacity slots and the aux loss's means count every data rank's
tokens, as the reference's one program does. Outside a step the experts
are whole; alltoall then computes the reference's global program on one
process, its token groups taken from the global mesh (which must have
ep > 1, as in the reference).
"""
import numpy as np
import torch

from .. import nn
from ..distributed import collective, expert_parallel, topology
from ..distributed.meta_parallel.mp_layers import (CopyToMP, GatherFromMP, ReduceFromMP,
                                                   ScatterToMP)
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.aux_loss import emit_aux_loss


def top_k(probs, k):
    """(values, indices) of the k largest along the last axis, ties to
    the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n, dtype=torch.float32):
    """``jax.nn.one_hot``: a row of zeros for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _gelu(x):
    return F.gelu(x, approximate=True)


def capacity_combine(xf, probs, k, cap, data=None, ep=None):
    """The GShard combine/dispatch build for one token group (reference
    moe.py:46): tokens claim per-expert capacity slots in order, overflow
    drops. Returns (combine [N, E, C] f32, dispatch [N, E, C], top-k
    indices). ``data``: a ``DataGroup`` whose ranks' tokens come before
    and after this rank's (rank order) in one global group. ``ep``: the
    ep ``AxisGroup``; combine and dispatch are then the rank's experts'
    [N, E/ep, C], and the gates enter through ``CopyToMP`` (their
    gradient, [N, k], summed over ep)."""
    n, e = probs.shape
    topv, topi = top_k(probs, k)
    gates = topv / torch.clamp(torch.sum(topv, dim=-1, keepdim=True), min=1e-9)
    masks = [_one_hot(topi[:, j], e) for j in range(k)]
    before = total = None
    if data is not None:
        # the tokens of the earlier data ranks claim their slots first
        mine = torch.stack([m.sum(dim=0) for m in masks])  # [k, E]
        every = torch.stack(collective.all_gather([], mine.detach().contiguous(),
                                                  data.group))
        before, total = every[:data.rank].sum(dim=0), every.sum(dim=0)
    lo, hi = 0, e
    if ep is not None:
        gates = CopyToMP.apply(gates, ep)
        lo, hi = ep.rank * e // ep.n, (ep.rank + 1) * e // ep.n
    combine = torch.zeros((n, hi - lo, cap), dtype=torch.float32, device=probs.device)
    counts = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    for j, mask_j in enumerate(masks):
        # 0-indexed slot: exclusive cumsum over tokens + slots taken by
        # earlier choices (choice 0 claims before choice 1, like GShard)
        pos_in_e = torch.cumsum(mask_j, dim=0) - mask_j + counts
        if before is not None:
            pos_in_e = pos_in_e + before[j]
        counts = counts + (torch.sum(mask_j, dim=0) if total is None else total[j])
        slot = torch.sum(pos_in_e * mask_j, dim=-1)
        keep = (slot < cap).to(torch.float32)
        combine = combine + (gates[:, j, None, None] * keep[:, None, None]
                             * mask_j[:, lo:hi, None] * _one_hot(slot, cap)[:, None, :])
    dispatch = (combine > 0).to(xf.dtype)
    return combine, dispatch, topi


def _means(sums, count, data):
    """Means over the global token set: ``sums`` (a tensor of sums over
    this rank's tokens) added over ``data``'s ranks (differentiably)."""
    if data is not None:
        sums = data.sum(sums)
        count = count * data.n
    return sums / count


def gshard_aux(probs, topi, data=None):
    """GShard's aux loss from the full softmax and the top-1 routing
    fraction (reference moe.py:71), over ``data``'s ranks' tokens too."""
    e = probs.shape[-1]
    with torch.no_grad():
        frac = _means(_one_hot(topi[:, 0], e).sum(dim=0), probs.shape[0], data)
    imp = _means(probs.sum(dim=0), probs.shape[0], data)
    return e * torch.sum(frac * imp)


class MoELayer(nn.Layer):
    """Top-k gated expert FFN block (pre-norm residual not included); see
    the module docstring. In eager use ``self.aux_loss`` holds the aux
    loss (add it to the objective yourself); the training steps collect
    it into their loss."""

    def __init__(self, hidden_size, ffn_hidden, num_experts, top_k=2, shard_axis="ep",
                 aux_weight=0.01, dispatch_mode="auto", capacity_factor=1.25, *, device=None,
                 generator=None):
        super().__init__()
        self.num_experts = int(num_experts)
        self.top_k = int(top_k)
        self.aux_weight = float(aux_weight)
        if dispatch_mode == "auto":
            dispatch_mode = "capacity" if self.num_experts >= 8 else "dense"
        if dispatch_mode not in ("dense", "capacity", "alltoall"):
            raise ValueError(f"dispatch_mode must be 'auto'/'dense'/"
                             f"'capacity'/'alltoall', got {dispatch_mode!r}")
        if shard_axis != "ep":
            raise NotImplementedError(f"shard_axis {shard_axis!r}: the port's steps shard "
                                      "experts over 'ep' only")
        self.shard_axis = shard_axis
        self.dispatch_mode = dispatch_mode
        self.capacity_factor = float(capacity_factor)
        kw = dict(device=device, generator=generator)
        self.gate = nn.Linear(hidden_size, num_experts, **kw)
        k = 1.0 / np.sqrt(hidden_size)
        self.w_up = self.create_parameter([num_experts, hidden_size, ffn_hidden],
                                          default_initializer=I.Uniform(-k, k), **kw)
        k2 = 1.0 / np.sqrt(ffn_hidden)
        self.w_down = self.create_parameter([num_experts, ffn_hidden, hidden_size],
                                            default_initializer=I.Uniform(-k2, k2), **kw)
        # the experts are blocks over "ep" in a step over an ep axis
        self.w_up.mp_spec = (shard_axis,)
        self.w_down.mp_spec = (shard_axis,)
        self.aux_loss = None

    def forward(self, x):
        logits = self.gate(x)  # [B, S, E]
        s = expert_parallel.scope()
        if self.dispatch_mode == "alltoall":
            out, aux = self._forward_alltoall(x, logits, s)
        elif self.dispatch_mode == "capacity":
            out, aux = self._forward_capacity(x, logits, s)
        else:
            out, aux = self._forward_dense(x, logits, s)
        emit_aux_loss(self, aux * self.aux_weight)
        return out

    def _forward_dense(self, x, logits, s):
        ep = None if s is None else s.ep
        data = None if s is None else s.data
        e = logits.shape[-1]
        probs = torch.softmax(logits.float(), dim=-1)
        # an exact top-k mask from the indices (a >= threshold compare
        # would select every tied expert on uniform probs)
        idx = top_k(probs, self.top_k)[1]  # [B, S, k]
        mask = torch.clamp(torch.sum(_one_hot(idx, e, probs.dtype), dim=-2), max=1.0)
        gates = probs * mask
        gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)
        xe, ge = x, gates
        if ep is not None:
            xe = CopyToMP.apply(x, ep)
            ge = ep.block(CopyToMP.apply(gates, ep), 2)
        h = _gelu(torch.einsum("bsh,ehf->besf", xe, self.w_up))
        y = torch.einsum("besf,efh->besh", h, self.w_down)
        out = torch.einsum("bse,besh->bsh", ge.to(y.dtype), y)
        if ep is not None:
            out = ReduceFromMP.apply(out, ep)
        n = mask.shape[0] * mask.shape[1]
        with torch.no_grad():
            frac = _means(mask.sum(dim=(0, 1)), n, data)
        imp = _means(probs.sum(dim=(0, 1)), n, data)
        aux = e * torch.sum(frac / self.top_k * imp)
        return out, aux.to(x.dtype)

    def _forward_capacity(self, x, logits, s):
        ep = None if s is None else s.ep
        data = None if s is None else s.data
        b, sq, hdim = x.shape
        e = logits.shape[-1]
        n = b * sq
        n_all = n * (1 if data is None else data.n)
        cap = max(1, int(np.ceil(self.capacity_factor * self.top_k * n_all / e)))
        xf = x.reshape(n, hdim)
        probs = torch.softmax(logits.float(), dim=-1).reshape(n, e)
        combine, dispatch, topi = capacity_combine(xf, probs, self.top_k, cap, data, ep)
        if ep is not None:
            xf = CopyToMP.apply(xf, ep)
        buf = torch.einsum("nec,nh->ech", dispatch, xf)
        h = _gelu(torch.einsum("ech,ehf->ecf", buf, self.w_up))
        y = torch.einsum("ecf,efh->ech", h, self.w_down)
        out = torch.einsum("nec,ech->nh", combine.to(y.dtype), y)
        if ep is not None:
            out = ReduceFromMP.apply(out, ep)
        aux = gshard_aux(probs, topi, data)
        return out.reshape(b, sq, hdim), aux.to(x.dtype)

    def _group(self, x, logits, w_up, w_down, exchange):
        """One token group's capacity dispatch (reference moe.py:222):
        ``exchange(buf, split, concat)`` moves the [E, C, H] buffers
        between the ep ranks (the identity for whole experts)."""
        b, sq, hdim = x.shape
        e = self.num_experts
        n = b * sq
        cap = max(1, int(np.ceil(self.capacity_factor * self.top_k * n / e)))
        xf = x.reshape(n, hdim)
        probs = torch.softmax(logits.float(), dim=-1).reshape(n, e)
        combine, dispatch, topi = capacity_combine(xf, probs, self.top_k, cap)
        buf = exchange(torch.einsum("nec,nh->ech", dispatch, xf), 0, 1)  # [E/ep, ep*C, H]
        h = _gelu(torch.einsum("ech,ehf->ecf", buf, w_up))
        y = exchange(torch.einsum("ecf,efh->ech", h, w_down), 1, 0)  # [E, C, H]
        out = torch.einsum("nec,ech->nh", combine.to(y.dtype), y)
        return out.reshape(b, sq, hdim), gshard_aux(probs, topi)

    def _forward_alltoall(self, x, logits, s):
        axis = self.shard_axis
        e = self.num_experts
        ep_group = None if s is None else s.ep
        if ep_group is None:
            # outside a step: the global program on one process, its token
            # groups taken from the global mesh (the reference's)
            mesh = topology.get_global_mesh()
            ep = mesh.shape.get(axis, 1)
            tok_axes = topology.data_axes(mesh) + (axis,)
            groups = chunks = mesh.axis_size(tok_axes) if ep > 1 else ep
        else:  # this data rank's batch, split over the ep group
            ep = ep_group.n
            tok_axes = ("data", axis)
            groups = ep * (1 if s.data is None else s.data.n)
            chunks = ep
        if ep <= 1:
            raise ValueError(
                "dispatch_mode='alltoall' needs a global mesh with "
                f"{axis!r} > 1 (set_global_mesh(build_mesh(ep=...)))")
        if e % ep:
            raise ValueError(f"num_experts={e} must divide over "
                             f"{axis}={ep} for all_to_all dispatch")
        if x.shape[0] % chunks:
            raise ValueError(f"batch {x.shape[0] * (groups // chunks)} must be divisible by "
                             f"the token shard count {groups} (axes {tok_axes})")
        if ep_group is None:
            # each group's tokens through the whole experts, the aux loss
            # the groups' mean
            outs, auxes = zip(*(self._group(xg, lg, self.w_up, self.w_down,
                                            lambda t, split, concat: t)
                                for xg, lg in zip(x.chunk(chunks), logits.chunk(chunks))))
            return torch.cat(outs), torch.stack(auxes).mean().to(x.dtype)

        def exchange(t, split, concat):
            return expert_parallel.AllToAll.apply(t, ep_group.group, split, concat)
        out, aux = self._group(ScatterToMP.apply(x, 0, ep_group),
                               ScatterToMP.apply(logits, 0, ep_group), self.w_up, self.w_down,
                               exchange)
        # the groups' mean: over ep here, over the data ranks by the
        # step's mean of the loss
        aux = ReduceFromMP.apply(aux, ep_group) / ep
        return GatherFromMP.apply(out, 0, ep_group), aux.to(x.dtype)
