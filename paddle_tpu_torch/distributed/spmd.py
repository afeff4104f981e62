"""The training step (counterpart of ``build_train_step``,
``build_fsdp_train_step`` and ``shard_batch`` in
paddle_tpu/distributed/spmd.py), on one device or over a data-parallel
mesh.

``build_train_step(layer, loss_fn, optimizer, ...)`` returns
``(step_fn, init_fn)`` as the reference does: ``init_fn()`` gives
``(params, opt_state)``, dictionaries keyed by the layer's parameter names
(a tied parameter once, under its first name), and
``step_fn(params, opt_state, x, y, key=None, lr=None)`` runs one step and
returns ``(loss, params, opt_state)``.

A step runs the layer's forward on ``params`` (``torch.func.functional_call``,
which keeps tied parameters tied) under ``rng_guard(key)``, so dropout takes
the reference's keys in the reference's order, and under ``auto_cast`` for
``amp_level`` O1/O2 with float32 master weights. The gradients of every
parameter (zeros for one the loss does not reach, as ``jax.grad`` gives)
go through the optimizer's grad clip and then its functional ``_update``.
With ``donate=True`` (the default, as in the reference) the new values are
written into the given params and state tensors in place, which saves a
copy of both on the device; the returned dictionaries are the ones passed
in. With ``donate=False`` the inputs are left as they were.

The optimizer's hypers are read once, for no parameter, as in the
reference (spmd.py:238): an L1 regularizer adds ``l1 * sign(p)`` to every
gradient before ``_update``; a parameter's own ``regularizer``,
``optimize_attr`` and AdamW's ``apply_decay_param_fun`` act only in the
eager ``Optimizer.step()``. With ``lr=None`` a step takes
``optimizer.get_lr()``, a scheduler's current rate, as a float32 scalar;
stepping the scheduler between steps is the caller's.

A layer's buffers (BatchNorm's running statistics) thread through the
step as the reference threads them (spmd.py:192-231, 413-448): each step
reads the layer's buffers as they are then (so buffers loaded onto the
layer between steps are picked up), runs the forward on copies of them,
which the forward updates in place, and writes the copies' new values
back onto the layer after the step, so ``state_dict()`` and ``eval()``
see them.

``recompute=True`` is the reference's ``jax.checkpoint`` around the whole
loss function (spmd.py:235-236): ``torch.utils.checkpoint.checkpoint``
(non-reentrant) around the forward and loss, with ``rng_guard(key)``
entered inside it, so the backward runs the forward again and its dropout
draws the same keys; the recomputed forward updates copies of its own,
which are dropped, so the buffers move once a step, bitwise as in a
plain step. It saves no peak memory (the recomputed forward's
activations are all alive at once again) and runs the forward twice.

``amp_dtype="float16"`` runs the forward under ``auto_cast(dtype=
"float16")`` (the flash kernels' fp16 form) with float32 master weights.
As in the reference (spmd.py:200-236), the step scales no loss: dynamic
loss scaling is ``amp.GradScaler``'s, on the eager path.

``bad_step_guard=True`` (reference spmd.py:344-356): a step whose loss or
(clipped) gradients hold a NaN or an Inf keeps the old params, optimizer
state and buffers, chosen by ``torch.where`` on the device before any
value is written back, so ``donate=True`` never writes a bad step into
the given tensors; the step returns ``(loss, params, opt_state, bad)``,
``bad`` a 0-d bool tensor on the device, the same on every rank.

``offload=True`` (the reference's ``_bounce``, spmd.py:418-448): every
optimizer-state tensor that is not a scalar lives in pinned host memory
between steps (``init_fn`` puts it there). A step runs the forward and
backward first, then copies each parameter's state to the card, updates,
and copies it back (``non_blocking``, on the current stream), so the card
holds one parameter's state at a time; the step synchronizes its stream
before it returns, so the host tensors are complete when the caller reads
them. The bits are the resident step's. On the CPU the host is the
device and the state stays where it is. It composes with ZeRO: the host
holds the rank's blocks.

The mesh. ``mesh`` (default: the global mesh, which
``init_parallel_env`` makes dp over every rank of the job; one rank
outside a job) shards the batch over its data axes, "dp" and "sharding"
combined (``topology.data_axes``; N ranks, rank r's index
``dp_idx * sharding + sharding_idx``). With N > 1 the step is the
reference's global program over N ranks (spmd.py:139-187, 460-479). Each
rank passes its local batch (``shard_batch``), rows ``[r * B, (r + 1) *
B)`` of the global one; it takes the gradients of its local mean loss,
then one coalesced all-reduce mean over the data group
(``collective.coalesced_mean``, the loss riding in the same buffer) gives
every rank the global batch's gradients and loss (mean losses over equal
local batches average to the global mean); the grad clip, the bad-step
check and ``_update_one`` then see the global gradients, so every rank
keeps or drops the same step and holds bitwise the same parameters. The
dropout masks are the global program's: the forward runs under
``dp_shard_guard(r, B)``, so ``fast_keep_mask`` and the flash kernels
(``bh_offset``) draw this rank's slice of the global mask. Training-mode
batch norm takes the global batch's statistics
(``nn.functional.norm.global_batch_stats``: its two sums all-reduced,
differentiably), as the reference's one program does. The all-reduce is
a profiler range, ``build_train_step.grad_allreduce``. Against the
one-device step on the global batch the only difference is the sums'
order.

ZeRO (reference spmd.py:83-103, :185-191, :243-269; ``sharding_stage``,
``shard_optimizer=True`` for stage 1, ``strategy.sharding`` with
``sharding_configs.stage``, or a layer tagged ``_sharding_stage`` by
``sharding.group_sharded_parallel``), over the data axes: a parameter is
sharded on its first dimension that N divides (``zero_dim``), else
replicated (every rank updates it whole).

- Stage 1: each rank keeps only its block of each non-scalar optimizer
  state tensor. After the all-reduce it updates its block of the
  parameter with ``_update_one``, which acts on each element alone
  (``Optimizer._elementwise``), so a block's update is bitwise that block
  of the whole update; Lamb's and LARS' trust ratio reads the whole
  parameter's norms, whose sums of squares the rank adds over the group
  (``block_sum_sq``, as the clip's ``sum_sq_over``). Then it all-gathers
  the parameter (``collective.coalesced_all_gather``). Bitwise the
  stage-0 step (Lamb and LARS: to the sums' order).
- Stage 2: the sharded parameters' gradients are reduce-scattered
  (``collective.coalesced_reduce_scatter``) instead of all-reduced; a
  clip that reads a norm adds the blocks' sums of squares over the ranks
  (``clip_arrays(sum_sq=...)``), and the bad-step flag is all-reduced.
- Stage 3: ``init_fn`` returns each sharded parameter as the rank's
  block (the reference's addressable shard), and so does each step. A
  step all-gathers the parameters once, up front (the reference's own
  non-guarantee, spmd.py:310-316: it does not promise one layer at a
  time; ``build_fsdp_train_step`` does), and frees the whole copies
  after the backward.

The local-gradient modes (reference comm_opt.py, spmd.py:270-309):
``fp16_allreduce`` and ``dgc_configs`` (or ``strategy.fp16_allreduce`` /
``strategy.dgc``) run the forward and backward as the reference's
``shard_map`` body does: on the local batch with the rank's own key
(``fold_in(key, index)`` along each data axis), no mask offset, local
batch statistics; then ``comm_opt.exchange_local_grads``. DGC's ``(u,
v)`` live in ``opt_state["__comm__"]``, each rank's own at the parameter's
shape (row r of the reference's ``[N, ...]``). ``strategy.localsgd`` and
``strategy.adaptive_localsgd`` return ``comm_opt.build_localsgd_train_step``'s
step. The reference's refusals stay: dgc/fp16 with ZeRO 2-3, offload with
dgc, localsgd with recompute, dgc, fp16_allreduce, sharding or offload.

``build_fsdp_train_step`` (reference spmd.py:482-651) is ZeRO-3 over a
homogeneous trunk gathered one layer at a time; see its docstring.

Tensor parallelism (reference spmd.py:73, :258-266): over a mesh with an
"mp" axis of more than one rank, each parameter whose ``mp_spec`` shards a
dimension over "mp" (a layer of ``meta_parallel.mp_layers``, or
``LlamaModel(tensor_parallel=True)``) is held as the rank's block on that
dimension (``mesh.rank_in("mp")``): ``init_fn`` and each step give the
block, the others stay whole. The forward runs inside
``mp_layers.tensor_parallel(mesh)``, where the stamped layers run their
Megatron collectives over the mp group. The gradients are averaged over
the data axes only; a norm clip adds the blocks' sums of squares over the
mp ranks, and the bad-step flag is the same on every rank. ZeRO composes
as the reference's ``has_mp`` says: an mp parameter keeps its mp layout at
every stage (its gradient all-reduced, never reduce-scattered; never
sharded at rest), and at stages 1-3 its optimizer state is sharded on
the first dimension of the rank's block that the data ranks divide. The
local-gradient modes refuse mp, as the reference's do.

``strategy`` (a fleet DistributedStrategy) maps ``amp`` (O1, or O2 with
``amp_configs.use_pure_fp16``), ``recompute``, ``fp16_allreduce``,
``dgc``, ``sharding`` and ``sharding_configs.offload`` as the reference
does (spmd.py:139-187). A "pp" or "sp" axis of more than one rank raises
NotImplementedError (the pipeline's axes: ``pipeline.
build_pipeline_train_step``, as in the reference, whose
``build_train_step`` has no pipeline).

Expert parallelism: over an "ep" axis of more than one rank, a parameter
whose ``mp_spec`` names "ep" (``incubate.moe.MoELayer``'s stacked experts)
is held as the rank's block on that dimension, as an mp parameter is
(``step_fn.ep_dims``); the batch is not split over ep. The forward runs
inside ``expert_parallel.expert_parallel(mesh, data)``, where the MoE
layers run their experts over the ep group (``incubate/moe.py``). ZeRO,
the clip and the bad-step flag treat an ep block as they treat an mp one.

The aux losses a forward emits through ``nn.aux_loss.emit_aux_loss`` (or
assigns to a layer's ``aux_loss``) are added to the loss, as in the
reference (spmd.py:211-225); the layer's ``aux_loss`` is None after a
step.

``step_fn.layout`` records the cuts of the global arrays a rank holds:
``{"params": {name: cuts}, "opt_state": {name: cuts}}``, each cut a
``(dimension, rank, ranks)`` outer first (a scalar state tensor is
whole); ``distributed.checkpoint`` writes a rank's blocks by it.
"""
import contextlib
import weakref

import numpy as np
import torch
import torch.profiler
import torch.utils.checkpoint

from ..amp.auto_cast import auto_cast
from ..core import place
from ..core import random as random_core
from ..nn import aux_loss
from ..nn.functional import norm as norm_fn
from ..resilience.badstep import tree_nonfinite
from . import collective, expert_parallel, topology
from .meta_parallel import mp_layers

_REFUSED_AXES = {"pp": "the pipeline's axis: use pipeline.build_pipeline_train_step",
                 "sp": "the pipeline's axis: use pipeline.build_pipeline_train_step"}


def param_sharding_spec(layer, mesh):
    """Per-parameter placement over ``mesh`` (reference spmd.py:99): the
    parameter's ``mp_spec`` where a tensor-parallel layer attached one,
    else None (replicated, every rank holds it whole)."""
    return {name: getattr(p, "mp_spec", None) for name, p in layer.named_parameters()}


def zero_dim(shape, n, start=0):
    """The dimension ZeRO shards a tensor of ``shape`` on over ``n`` ranks
    (reference ``_zero1_spec``): the first from ``start`` that ``n``
    divides; None for one rank, a scalar, or no such dimension (the
    tensor is then replicated)."""
    if n == 1 or len(shape) == 0:
        return None
    return next((d for d in range(start, len(shape)) if shape[d] % n == 0), None)


def shard_batch(batch, mesh=None, axis=None):
    """This rank's part of the global batch, on its device (reference
    spmd.py:460-479: each process passes its LOCAL batch, rows [r * B,
    (r + 1) * B) of the global one, which the step treats as such). A
    tensor stays where it is; an array goes to the current place."""
    if isinstance(batch, torch.Tensor):
        return batch
    return torch.as_tensor(np.asarray(batch), device=place.current_device())


def _to_host(t):
    """An optimizer-state tensor as offload keeps it: a non-scalar CUDA
    tensor copied into pinned host memory (asynchronously, on the current
    stream); a scalar, or a tensor already on the host, as it is."""
    if t.dim() == 0 or not t.is_cuda:
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)


def _sync(tensors):
    """Wait for the streams of the devices ``tensors`` are on (offload's
    host copies are complete before anyone reads them)."""
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


class DataGroup:
    """The mesh's data axes ("dp" and "sharding" combined): their number
    of ranks ``n``, this rank's index ``rank`` and ``group``, the
    collectives' group (None for one rank)."""

    def __init__(self, mesh):
        self.axes = topology.data_axes(mesh)
        self.n = mesh.axis_size(self.axes) if self.axes else 1
        self.rank = mesh.rank_in(self.axes) if self.axes else 0
        self.index = {a: mesh.rank_in(a) for a in self.axes}
        self.group = None
        if self.n > 1:
            pg = mesh.group(self.axes)
            if pg is None:
                raise RuntimeError(f"{mesh} has {self.n} data-parallel ranks but this process "
                                   "has no group over them (call init_parallel_env)")
            self.group = collective.Group(axis=self.axes, process_group=pg)

    def sum(self, t):
        """A differentiable sum over the ranks (batch norm's statistics)."""
        return collective.AllReduceSum.apply(t, self.group)

    def sum_sq(self, sharded):
        """``clip_arrays``' ``sum_sq`` for gradients of which those at
        positions ``sharded`` are blocks: their sums of squares are added
        over the ranks (one all-reduce), the others' kept."""
        return sum_sq_over({self.group: sharded})

    def any(self, flag):
        return any_over(flag, self.group)


def any_over(flag, group):
    """A 0-d bool that is true on every rank of ``group`` where it is on
    one."""
    t = collective.all_reduce(flag.to(torch.int32).reshape(1), collective.ReduceOp.MAX, group)
    return t.reshape(()).bool()


def sum_sq_over(blocks):
    """``clip_arrays``' ``sum_sq`` for gradients that are blocks over
    groups: ``blocks`` maps a collectives' group to the positions of the
    gradients split over it, whose sums of squares are added over its
    ranks (one all-reduce a group); the others' are kept. None when no
    gradient is a block."""
    blocks = {g: list(ix) for g, ix in blocks.items() if g is not None and ix}
    if not blocks:
        return None

    def reduce(sums):
        out = list(sums)
        for group, ix in blocks.items():
            both = collective.all_reduce(torch.stack([out[i] for i in ix]),
                                         collective.ReduceOp.SUM, group)
            for j, i in enumerate(ix):
                out[i] = both[j]
        return out
    return reduce


def _lr_tensor(lr, device):
    if isinstance(lr, torch.Tensor):
        return lr.to(device=device, dtype=torch.float32)
    return torch.full((), float(lr), dtype=torch.float32, device=device)


def block_sum_sq(groups):
    """``Optimizer._update_one``'s ``sum_sq`` for a parameter block split
    over ``groups`` (collectives' groups, None for a group of one rank):
    each tensor's sum of squares over the block, added over every group's
    ranks, so Lamb's and LARS' trust ratio reads the whole parameter's
    norms, as the reference's global arrays give them. None when the
    block is the whole parameter."""
    groups = [g for g in groups if g is not None]
    if not groups:
        return None

    def sum_sq(*tensors):
        sums = torch.stack([torch.sum(torch.square(t)) for t in tensors])
        for g in groups:
            sums = collective.all_reduce(sums, collective.ReduceOp.SUM, g)
        return list(sums)
    return sum_sq


def _init_blocks(optimizer, params, dims, data):
    """Each parameter's optimizer state for its block (the whole parameter
    where it is replicated); a non-scalar state tensor must have the
    block's shape."""
    state = {}
    for n, p in params.items():
        block = collective.shard(p, dims[n], data.rank, data.n)
        st = optimizer._init_state(block.contiguous())
        for a in st:
            if a.dim() and tuple(a.shape) != tuple(block.shape):
                raise NotImplementedError(
                    f"{n}: {type(optimizer).__name__} keeps a state tensor of shape "
                    f"{tuple(a.shape)} for a parameter block of {tuple(block.shape)}: ZeRO "
                    "shards the state by the parameter's blocks")
        state[n] = st
    return state


def _update_all(names, opt_state, grads, lr, blocks, hypers, update_one, l1_coeff, donate,
                offload, bad, sum_sq=None):
    """Every parameter's ``_update_one``: ``blocks[n]`` is the part of a
    parameter to update (its ZeRO block, or the whole), ``grads[n]``
    and ``opt_state[n]`` are that part's, ``sum_sq[n]`` its
    ``block_sum_sq`` (None for all: every part is whole). Returns {name:
    new part}, {name: new state}; with ``donate`` the parts and state are
    written in place (and returned)."""
    new_parts, new_state = {}, {}
    lr_t = {}  # one float32 scalar per device
    for n in names:
        target = blocks[n]
        if target.device not in lr_t:
            lr_t[target.device] = _lr_tensor(lr, target.device)
        state = opt_state[n]
        if offload:  # this parameter's state onto the card for its update
            state = tuple(a.to(target.device, non_blocking=True) for a in state)
        new_p, new_st = update_one(target, grads[n].to(target.dtype), lr_t[target.device],
                                   state, hypers, l1_coeff, None if sum_sq is None else sum_sq[n])
        if bad is not None:
            new_p = torch.where(bad, target, new_p)
            new_st = tuple(torch.where(bad, o, w) for o, w in zip(state, new_st))
        if donate:
            for old, new in zip((target, *opt_state[n]), (new_p, *new_st)):
                old.copy_(new, non_blocking=offload)
            new_parts[n], new_state[n] = target, opt_state[n]
        else:
            new_parts[n] = new_p
            new_state[n] = tuple(_to_host(a) for a in new_st) if offload else new_st
    return new_parts, new_state


def _gradients(loss, leaves, names):
    grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(leaves[n]) if g is None else g for n, g in zip(names, grads)}


def _refuse_localsgd_mixes(strategy, recompute, fp16_allreduce, dgc_configs, offload,
                           sharding_stage, bad_step_guard):
    """The reference's list (spmd.py:144-161), and the guard, which its
    LocalSGD step never reads."""
    unsupported = [k for k in ("recompute", "dgc", "fp16_allreduce", "sharding")
                   if getattr(strategy, k)]
    for flag, name in ((recompute, "recompute=True"), (fp16_allreduce, "fp16_allreduce=True"),
                       (dgc_configs is not None, "dgc_configs"), (offload, "offload=True"),
                       (sharding_stage, f"sharding_stage={sharding_stage}"),
                       (bad_step_guard, "bad_step_guard=True")):
        if flag:
            unsupported.append(name)
    if unsupported:
        raise NotImplementedError(f"localsgd does not compose with {unsupported}; "
                                  "disable them or drop localsgd")


def build_train_step(layer, loss_fn, optimizer, mesh=None, recompute=False,
                     shard_optimizer=False, sharding_stage=None, donate=True,
                     amp_level="O0", amp_dtype="bfloat16", fp16_allreduce=False,
                     dgc_configs=None, strategy=None, offload=False,
                     bad_step_guard=False):
    """The training step for ``layer`` on one device or over ``mesh``'s
    data axes; ``loss_fn(model_out, y)`` returns a scalar tensor, a mean
    over the batch. See the module docstring."""
    from . import comm_opt

    mesh = mesh or topology.get_global_mesh()
    refused = [f"a mesh axis {a} of {n} ranks ({_REFUSED_AXES[a]})"
               for a, n in mesh.shape.items() if a in _REFUSED_AXES and n > 1]
    if refused:
        raise NotImplementedError(f"build_train_step: {'; '.join(refused)}")
    if strategy is not None:
        if strategy.adaptive_localsgd or strategy.localsgd:
            _refuse_localsgd_mixes(strategy, recompute, fp16_allreduce, dgc_configs, offload,
                                   sharding_stage, bad_step_guard)
            acfg = dict(strategy.adaptive_localsgd_configs or {}) \
                if strategy.adaptive_localsgd else {}
            return comm_opt.build_localsgd_train_step(
                layer, loss_fn, optimizer, mesh=mesh,
                k_steps=int(strategy.localsgd_configs.get("k_steps", 1) or 1),
                amp_level="O1" if strategy.amp else amp_level, amp_dtype=amp_dtype,
                adaptive=bool(strategy.adaptive_localsgd),
                init_k_steps=int(acfg.get("init_k_steps", 1) or 1),
                begin_step=int(acfg.get("begin_step", 1) or 1))
        if strategy.amp and amp_level == "O0":
            amp_level = "O2" if strategy.amp_configs.get("use_pure_fp16") else "O1"
        recompute = recompute or strategy.recompute
        fp16_allreduce = fp16_allreduce or strategy.fp16_allreduce
        if strategy.dgc and dgc_configs is None:
            dgc_configs = dict(strategy.dgc_configs)
        if strategy.sharding and sharding_stage is None:
            sharding_stage = int(strategy.sharding_configs.get("stage", 1) or 1)
        offload = offload or bool(strategy.sharding_configs.get("offload"))
    if sharding_stage is None:
        # group_sharded_parallel() tags the model with its ZeRO stage
        sharding_stage = getattr(layer, "_sharding_stage", None) or (1 if shard_optimizer else 0)
    if sharding_stage not in (0, 1, 2, 3):
        raise ValueError(f"sharding_stage must be 0..3, got {sharding_stage}")
    if offload and dgc_configs is not None:
        raise NotImplementedError("offload does not compose with dgc")
    data = DataGroup(mesh)
    tp = topology.AxisGroup(mesh) if mesh.axis_size("mp") > 1 else None
    ep = topology.AxisGroup(mesh, "ep") if mesh.axis_size("ep") > 1 else None
    named = dict(layer.named_parameters())
    # the dimension each parameter is split on over "mp" and over "ep"
    # (None: whole)
    mpd = {n: mp_layers.mp_dim(getattr(p, "mp_spec", None)) if tp is not None else None
           for n, p in named.items()}
    epd = {n: mp_layers.mp_dim(getattr(p, "mp_spec", None), "ep") if ep is not None else None
           for n, p in named.items()}
    mp_names = [n for n in named if mpd[n] is not None]
    ep_names = [n for n in named if epd[n] is not None]
    use_local = fp16_allreduce or dgc_configs is not None
    dgc = None
    if use_local and (mp_names or ep_names):
        raise NotImplementedError("dgc/fp16_allreduce compose with data parallelism only "
                                  "(reference dgc_optimizer.py has the same constraint)")
    if use_local:
        if sharding_stage >= 2:
            raise NotImplementedError(
                "dgc/fp16_allreduce replace the gradient allreduce and cannot combine with "
                "ZeRO-2/3 reduce-scatter")
        if data.n == 1:
            raise ValueError("dgc/fp16_allreduce need a data-parallel mesh axis > 1")
        dgc = comm_opt.dgc_settings(dgc_configs) if dgc_configs is not None else None
    if amp_level not in ("O0", "O1", "O2"):
        raise ValueError(f"amp_level must be 'O0'|'O1'|'O2', got {amp_level!r}")
    amp_enabled = amp_level in ("O1", "O2")
    names = list(named)
    hypers = optimizer._hypers()
    l1_coeff = type(optimizer)._take_l1(hypers)
    update_one = type(optimizer)._update_one
    grad_clip = optimizer._grad_clip

    def mp_block(t, n):
        if mpd[n] is not None:
            return tp.block(t, mpd[n])
        return t if epd[n] is None else ep.block(t, epd[n])

    # ZeRO's dimension of each parameter's (mp or ep) block, for its state
    dims = {n: zero_dim(tuple(mp_block(p, n).shape), data.n) if sharding_stage >= 1 else None
            for n, p in named.items()}
    sharded = [n for n in names if dims[n] is not None]
    # an mp or ep parameter keeps its layout: its gradient is all-reduced
    # and it is whole (its mp or ep block) at rest, whatever the stage
    scattered = ([n for n in sharded if mpd[n] is None and epd[n] is None]
                 if sharding_stage >= 2 else [])
    at_rest = scattered if sharding_stage >= 3 else []
    gathered = [n for n in sharded if n not in at_rest]
    comm_stats = {}
    # the cuts of each parameter's global array a rank holds, outer first:
    # (dimension, rank, ranks)
    model_cuts = {n: ([(mpd[n], tp.rank, tp.n)] if mpd[n] is not None else [])
                  + ([(epd[n], ep.rank, ep.n)] if epd[n] is not None else []) for n in names}
    zero_cut = {n: [(dims[n], data.rank, data.n)] if dims[n] is not None else [] for n in names}
    layout = {"params": {n: tuple(model_cuts[n] + (zero_cut[n] if n in at_rest else []))
                         for n in names},
              "opt_state": {n: tuple(model_cuts[n] + zero_cut[n]) for n in names}}
    # Lamb's and LARS' norms over a block: added over its groups
    update_sum_sq = None if type(optimizer)._elementwise(hypers) else {
        n: block_sum_sq([tp.group if mpd[n] is not None else None,
                         ep.group if epd[n] is not None else None,
                         data.group if dims[n] is not None else None]) for n in names}

    def block(t, n):
        return collective.shard(t, dims[n], data.rank, data.n)

    def init_fn():
        params = {n: mp_block(p.detach(), n).clone() for n, p in named.items()}
        opt_state = _init_blocks(optimizer, params, dims, data)
        if at_rest:
            params = {n: block(p, n).clone() if n in at_rest else p for n, p in params.items()}
        if offload:
            opt_state = {n: tuple(_to_host(a) for a in st) for n, st in opt_state.items()}
            _sync(params.values())
        if dgc is not None:
            opt_state["__comm__"] = comm_opt.init_dgc_state(params)
        return params, opt_state

    def forward_loss(leaves, buffers, x, y, key):
        work = {n: b.clone() for n, b in buffers.items()}  # the forward updates these
        with contextlib.ExitStack() as stack:
            stack.enter_context(random_core.rng_guard(key))
            global_program = data.n > 1 and not use_local
            if global_program:
                # the global program: this rank's slice of the global
                # dropout masks, the global batch's statistics
                stack.enter_context(random_core.dp_shard_guard(data.rank, x.shape[0]))
                stack.enter_context(norm_fn.global_batch_stats(data.sum, data.n))
            if amp_enabled:
                stack.enter_context(auto_cast(enable=True, level=amp_level,
                                              dtype=amp_dtype))
            stack.enter_context(mp_layers.tensor_parallel(mesh))
            stack.enter_context(expert_parallel.expert_parallel(
                mesh, data if global_program else None))
            # the aux losses the forward emits (MoE load balancing) join
            # the objective (reference spmd.py:211-225)
            auxes = stack.enter_context(aux_loss.collect_aux_losses())
            aux_loss.clear_direct_aux_losses(layer)
            out = torch.func.functional_call(layer, {**leaves, **work}, (x,))
            aux_loss.sweep_direct_aux_losses(layer, auxes)
            return loss_fn(out, y) + aux_loss.total_aux_loss(auxes), work

    if recompute:
        plain_forward_loss = forward_loss

        def forward_loss(leaves, buffers, x, y, key):
            return torch.utils.checkpoint.checkpoint(plain_forward_loss, leaves, buffers, x,
                                                     y, key, use_reentrant=False)

    def step_fn(params, opt_state, x, y, key=None, lr=None):
        if key is None:
            key = random_core.PRNGKey(0)
        if lr is None:
            lr = optimizer.get_lr()
        whole = dict(params)
        if at_rest:  # ZeRO-3: the whole parameters for this step only
            for n, t in zip(at_rest, collective.coalesced_all_gather(
                    [params[n] for n in at_rest], [dims[n] for n in at_rest], data.group)):
                whole[n] = t
        leaves = {n: whole[n].detach().requires_grad_(True) for n in names}
        del whole
        buffers = dict(layer.named_buffers())
        if use_local:  # the reference's shard_map body: the rank's own key
            for a in data.axes:
                key = random_core.fold_in(key, data.index[a])
        loss, new_buffers = forward_loss(leaves, buffers, x, y, key)
        grads = _gradients(loss, leaves, names)
        del leaves
        loss = loss.detach()
        new_comm = None
        if data.n > 1:
            # the global batch's loss and gradients on every rank
            with torch.profiler.record_function("build_train_step.grad_allreduce"):
                loss = loss.float().reshape(1)
                if use_local:
                    new_comm = comm_opt.exchange_local_grads(
                        grads, loss, new_buffers, opt_state.get("__comm__"), data.group,
                        fp16_allreduce, dgc, comm_stats)
                else:
                    rest = [n for n in names if n not in scattered]
                    for n in rest:
                        grads[n] = grads[n].contiguous()
                    collective.coalesced_mean([loss, *(grads[n] for n in rest)], data.group)
                    if scattered:
                        for n, g in zip(scattered, collective.coalesced_reduce_scatter(
                                [grads[n] for n in scattered], [dims[n] for n in scattered],
                                data.group)):
                            grads[n] = g
                loss = loss.reshape(())
        if grad_clip is not None:
            sum_sq = sum_sq_over({data.group: [names.index(n) for n in scattered],
                                  None if tp is None else tp.group:
                                  [names.index(n) for n in mp_names],
                                  None if ep is None else ep.group:
                                  [names.index(n) for n in ep_names]})
            grads = dict(zip(names, grad_clip.clip_arrays([grads[n] for n in names],
                                                          sum_sq=sum_sq)))
        bad = None
        if bad_step_guard:
            # the loss and the clipped gradients, as the reference checks
            # them; decided on the device, before anything is written
            with torch.no_grad():
                bad = tree_nonfinite(loss) | tree_nonfinite(list(grads.values()))
                if scattered:
                    bad = data.any(bad)
                if mp_names:
                    bad = any_over(bad, tp.group)
                if ep_names:
                    bad = any_over(bad, ep.group)
        # the update's range is named for a profiler to read (its cost when
        # no profiler runs: one host call)
        with torch.no_grad(), torch.profiler.record_function("build_train_step.update"):
            for n, b in new_buffers.items():
                buffers[n].copy_(b if bad is None else torch.where(bad, buffers[n], b))
            blocks = {n: p if n in at_rest or dims[n] is None else block(p, n)
                      for n, p in params.items()}
            grads = {n: block(g, n) if dims[n] is not None and n not in scattered else g
                     for n, g in grads.items()}
            parts, new_state = _update_all(names, opt_state, grads, lr, blocks, hypers,
                                           update_one, l1_coeff, donate, offload, bad,
                                           update_sum_sq)
            new_params = dict(parts)
            if gathered:
                # ZeRO 1-2 (and an mp or ep parameter's block at any stage):
                # every rank's blocks make the whole parameters
                for n, t in zip(gathered, collective.coalesced_all_gather(
                        [parts[n] for n in gathered], [dims[n] for n in gathered], data.group)):
                    if donate:
                        params[n].copy_(t)
                        new_params[n] = params[n]
                    else:
                        new_params[n] = t
            if new_comm is not None:
                old = opt_state["__comm__"]
                if bad is not None:
                    new_comm = {n: tuple(torch.where(bad, o, w) for o, w in zip(old[n], uv))
                                for n, uv in new_comm.items()}
                if donate:
                    for n, uv in new_comm.items():
                        for o, w in zip(old[n], uv):
                            o.copy_(w)
                    new_comm = old
                new_state["__comm__"] = new_comm
        if offload:
            _sync(params.values())
        if bad_step_guard:
            return loss, new_params, new_state, bad
        return loss, new_params, new_state

    step_fn.comm_stats = comm_stats  # the local-gradient modes' last exchange, bytes by dtype
    step_fn.zero_dims = dims
    step_fn.mp_dims = mpd
    step_fn.ep_dims = epd
    step_fn.layout = layout
    return step_fn, init_fn


class _GatherLayer(torch.autograd.Function):
    """One trunk layer's sharded parameters made whole: an all-gather of
    the rank's blocks in the forward, a reduce-scatter (mean) of the
    whole gradients in the backward."""

    @staticmethod
    def forward(ctx, group, dims, tracker, *blocks):
        ctx.group, ctx.dims = group, dims
        whole = collective.coalesced_all_gather(list(blocks), dims, group)
        tracker.gathered(whole)
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous() for g in grads]
        return (None, None, None, *collective.coalesced_reduce_scatter(grads, ctx.dims,
                                                                       ctx.group))


class GatherTracker:
    """Counts the trunk layers whose gathered (whole) parameters are alive:
    ``alive`` now, ``peak`` since ``reset()``, ``gathers`` made. A layer
    stays alive until every whole tensor of its gather is freed."""

    def __init__(self):
        self.alive = self.peak = self.gathers = 0

    def reset(self):
        self.peak = self.alive
        self.gathers = 0

    def gathered(self, tensors):
        self.gathers += 1
        self.alive += 1
        self.peak = max(self.peak, self.alive)
        left = [len(tensors)]

        def freed():
            left[0] -= 1
            if left[0] == 0:
                self.alive -= 1
        for t in tensors:
            weakref.finalize(t, freed)


def build_fsdp_train_step(layers, loss_fn, optimizer, mesh=None, recompute=True,
                          amp_level="O0", amp_dtype="bfloat16", donate=False):
    """ZeRO-3 with a trunk gathered one layer at a time (FSDP; reference
    spmd.py:482-651, sharding_optimizer.py:180's per-segment staging).

    ``layers``: an ``nn.Sequential`` (or a list of layers) whose longest
    run of structurally identical blocks (``pipeline.split_pre_trunk_post``)
    is the trunk. Its parameters are stacked ``[L, ...]`` under
    ``trunk.<name>`` and sharded over the data axes on a per-layer
    dimension (the first from 1 that N divides, never the stacked one;
    ``init_fn`` and each step give the rank's block); ``pre.<i>.<name>``
    and ``post.<i>.<name>`` are replicated. The trunk runs layer by layer:
    each layer's gather is ``_GatherLayer`` (all-gather forward,
    reduce-scatter mean backward). ``recompute=True`` (the default) wraps
    each layer's gather and body in ``torch.utils.checkpoint``, so the
    backward gathers again and at most one trunk layer's gathered weights
    are alive at a time (``step_fn.tracker`` counts them). The other
    gradients and the loss are all-reduced (mean); a norm clip adds the
    trunk blocks' sums of squares over the ranks. Keys as the reference's:
    ``fold_in(key, 1000 + i)`` for pre layer i, ``split(fold_in(key, 7),
    L)`` for the trunk, ``fold_in(key, 2000 + i)`` for post layer i; the
    forward is the global program (``dp_shard_guard``). A layer with
    buffers raises, as in the reference.

    Returns ``(step_fn, init_fn)`` with the ``build_train_step`` contract.
    """
    from .pipeline import functional_apply, split_pre_trunk_post

    if isinstance(layers, torch.nn.Module):
        layer_list = list(layers.children())
    else:
        layer_list = list(layers)
    for l in layer_list:
        if any(True for _ in l.named_buffers()):
            raise NotImplementedError(
                "build_fsdp_train_step does not thread layer buffers; use "
                "build_train_step(sharding_stage=3) for models with BatchNorm-style state")
    pre, trunk, post = split_pre_trunk_post(layer_list, 1)
    mesh = mesh or topology.get_global_mesh()
    data = DataGroup(mesh)
    template = trunk[0]
    n_trunk = len(trunk)
    amp = (amp_level, amp_dtype) if amp_level in ("O1", "O2") else None
    trunk_names = [n for n, _ in template.named_parameters()]
    whole0 = {}
    for i, l in enumerate(pre):
        for n, p in l.named_parameters():
            whole0[f"pre.{i}.{n}"] = p.detach()
    for n in trunk_names:
        whole0[f"trunk.{n}"] = torch.stack([dict(l.named_parameters())[n].detach()
                                            for l in trunk])
    for i, l in enumerate(post):
        for n, p in l.named_parameters():
            whole0[f"post.{i}.{n}"] = p.detach()
    names = list(whole0)
    dims = {n: zero_dim(tuple(a.shape), data.n, start=1) if n.startswith("trunk.") else None
            for n, a in whole0.items()}
    sharded = [n for n in names if dims[n] is not None]
    gathered_names = [n for n in trunk_names if dims[f"trunk.{n}"] is not None]
    layer_dims = [dims[f"trunk.{n}"] - 1 for n in gathered_names]  # within one layer
    hypers = optimizer._hypers()
    l1_coeff = type(optimizer)._take_l1(hypers)
    update_one = type(optimizer)._update_one
    grad_clip = optimizer._grad_clip
    update_sum_sq = None if type(optimizer)._elementwise(hypers) else {
        n: block_sum_sq([data.group if dims[n] is not None else None]) for n in names}
    tracker = GatherTracker()

    def block(t, n):
        return collective.shard(t, dims[n], data.rank, data.n)

    def trunk_layer(h, key, *slices):
        own = dict(zip(trunk_names, slices))
        if gathered_names:
            whole = _GatherLayer.apply(data.group, layer_dims, tracker,
                                       *(own[n] for n in gathered_names))
            own.update(zip(gathered_names, whole))
        # entered here too: the backward's recompute may run on another
        # thread (the autograd engine's, on a card), outside step_fn's guard
        with global_masks(h.shape[0]):
            return functional_apply(template, own, h, key, amp)

    def global_masks(local_batch):
        if data.n == 1:
            return contextlib.nullcontext()
        return random_core.dp_shard_guard(data.rank, local_batch)

    def forward_loss(params, x, y, key):
        h = x
        for i, l in enumerate(pre):
            h = functional_apply(l, {n: params[f"pre.{i}.{n}"] for n, _ in l.named_parameters()},
                                 h, random_core.fold_in(key, 1000 + i), amp)
        keys = random_core.split(random_core.fold_in(key, 7), n_trunk)
        for j in range(n_trunk):
            slices = [params[f"trunk.{n}"][j] for n in trunk_names]
            if recompute:
                h = torch.utils.checkpoint.checkpoint(trunk_layer, h, keys[j], *slices,
                                                      use_reentrant=False)
            else:
                h = trunk_layer(h, keys[j], *slices)
        for i, l in enumerate(post):
            h = functional_apply(l, {n: params[f"post.{i}.{n}"] for n, _ in l.named_parameters()},
                                 h, random_core.fold_in(key, 2000 + i), amp)
        return loss_fn(h, y)

    def init_fn():
        params = {n: block(a, n).clone() for n, a in whole0.items()}
        return params, {n: optimizer._init_state(p) for n, p in params.items()}

    def step_fn(params, opt_state, x, y, key=None, lr=None):
        if key is None:
            key = random_core.PRNGKey(0)
        if lr is None:
            lr = optimizer.get_lr()
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        with global_masks(x.shape[0]):
            loss = forward_loss(leaves, x, y, key)
            grads = _gradients(loss, leaves, names)  # the trunk's: reduce-scattered
        del leaves
        loss = loss.detach()
        if data.n > 1:
            with torch.profiler.record_function("build_fsdp_train_step.grad_allreduce"):
                loss = loss.float().reshape(1)
                rest = [n for n in names if dims[n] is None]
                collective.coalesced_mean([loss, *(grads[n] for n in rest)], data.group)
                loss = loss.reshape(())
        if grad_clip is not None:
            sum_sq = data.sum_sq([names.index(n) for n in sharded]) if sharded else None
            grads = dict(zip(names, grad_clip.clip_arrays([grads[n] for n in names],
                                                          sum_sq=sum_sq)))
        with torch.no_grad():
            new_params, new_state = _update_all(names, opt_state, grads, lr, params, hypers,
                                                update_one, l1_coeff, donate, False, None,
                                                update_sum_sq)
        return loss, new_params, new_state

    step_fn.tracker = tracker
    step_fn.shard_dims = dims
    cuts = {n: ((dims[n], data.rank, data.n),) if dims[n] is not None else () for n in names}
    step_fn.layout = {"params": cuts, "opt_state": cuts}
    return step_fn, init_fn
