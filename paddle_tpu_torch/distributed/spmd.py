"""The training step (counterpart of ``build_train_step`` and
``shard_batch`` in paddle_tpu/distributed/spmd.py), on one device or over
a data-parallel mesh.

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
``bad`` a 0-d bool tensor on the device.

``offload=True`` (the reference's ``_bounce``, spmd.py:418-448): every
optimizer-state tensor that is not a scalar lives in pinned host memory
between steps (``init_fn`` puts it there). A step runs the forward and
backward first, then copies each parameter's state to the card, updates,
and copies it back (``non_blocking``, on the current stream), so the card
holds one parameter's state at a time; the step synchronizes its stream
before it returns, so the host tensors are complete when the caller reads
them. The bits are the resident step's. On the CPU the host is the
device and the state stays where it is.

``mesh`` (default: the global mesh, which ``init_parallel_env`` makes dp
over every rank of the job; one rank outside a job): with a "dp" axis
of N > 1 ranks the step is the reference's global program over N ranks
(spmd.py:139-187, 460-479). Each rank passes its local batch
(``shard_batch``), rows ``[r * B, (r + 1) * B)`` of the global one; it
takes the gradients of its local mean loss, then one coalesced
all-reduce mean over the dp group (``collective.coalesced_mean``, the
loss riding in the same buffer) gives every rank the global batch's
gradients and loss (mean losses over equal local batches average to the
global mean); the grad clip, the bad-step check and ``_update_one``
then see the global gradients, so every rank keeps or drops the same
step and holds bitwise the same parameters. The dropout masks are the
global program's: the forward runs under ``dp_shard_guard``, so
``fast_keep_mask`` and the flash kernels (``bh_offset``) draw this rank's
slice of the global mask. The all-reduce is a profiler range,
``build_train_step.grad_allreduce``. Against the one-device step on the
global batch the only difference is the sums' order.

``strategy`` (a fleet DistributedStrategy) maps ``amp`` (O1, or O2 with
``amp_configs.use_pure_fp16``), ``recompute`` and
``sharding_configs.offload`` as the reference does (spmd.py:139-187).

Options of the reference that this port does not implement yet raise
NotImplementedError naming the slice that brings them: ZeRO sharding
(``shard_optimizer``, ``sharding_stage``, ``strategy.sharding``),
``fp16_allreduce``, DGC, localsgd and adaptive localsgd (meshed
training), and a mesh axis other than dp of more than one rank (model
parallel); none is ignored. A layer with buffers (BatchNorm's running
statistics) refuses a dp mesh: its batch statistics would be the rank's,
not the global batch's.
"""
import contextlib

import numpy as np
import torch
import torch.profiler
import torch.utils.checkpoint

from ..amp.auto_cast import auto_cast
from ..core import place
from ..core import random as random_core
from ..resilience.badstep import tree_nonfinite
from . import collective, topology

_MESHED = "the meshed-training slice (build_fsdp_train_step, ZeRO 1-3, comm_opt.py)"
_MODEL_PARALLEL = "the model-parallel slice (meta_parallel)"


def _unsupported(mesh, shard_optimizer, sharding_stage, fp16_allreduce, dgc_configs,
                 strategy):
    """The options given that the port does not implement yet, each with
    the slice that brings it."""
    found = []
    if strategy is not None:
        for knob in ("sharding", "fp16_allreduce", "dgc", "localsgd", "adaptive_localsgd"):
            if getattr(strategy, knob):
                found.append(f"strategy.{knob} ({_MESHED})")
    for flag, name in ((shard_optimizer, "shard_optimizer"),
                       (sharding_stage, f"sharding_stage={sharding_stage}"),
                       (fp16_allreduce, "fp16_allreduce"), (dgc_configs is not None, "dgc_configs")):
        if flag:
            found.append(f"{name} ({_MESHED})")
    for axis, n in mesh.shape.items():
        if axis != "dp" and n > 1:
            found.append(f"a mesh axis {axis} of {n} ranks ({_MODEL_PARALLEL})")
    return found


def param_sharding_spec(layer, mesh):
    """Per-parameter placement over ``mesh`` (reference spmd.py:99): the
    parameter's ``mp_spec`` where a tensor-parallel layer attached one,
    else None (replicated, every rank holds it whole)."""
    return {name: getattr(p, "mp_spec", None) for name, p in layer.named_parameters()}


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


def build_train_step(layer, loss_fn, optimizer, mesh=None, recompute=False,
                     shard_optimizer=False, sharding_stage=None, donate=True,
                     amp_level="O0", amp_dtype="bfloat16", fp16_allreduce=False,
                     dgc_configs=None, strategy=None, offload=False,
                     bad_step_guard=False):
    """The training step for ``layer`` on one device or over ``mesh``'s
    dp axis; ``loss_fn(model_out, y)`` returns a scalar tensor, a mean
    over the batch. See the module docstring."""
    mesh = mesh or topology.get_global_mesh()
    found = _unsupported(mesh, shard_optimizer, sharding_stage, fp16_allreduce,
                         dgc_configs, strategy)
    if found:
        raise NotImplementedError(f"build_train_step: {'; '.join(found)} not ported yet")
    if strategy is not None:
        if strategy.amp and amp_level == "O0":
            amp_level = "O2" if strategy.amp_configs.get("use_pure_fp16") else "O1"
        recompute = recompute or strategy.recompute
        offload = offload or bool(strategy.sharding_configs.get("offload"))
    dp_size = mesh.shape.get("dp", 1)
    dp_rank = mesh.rank_in("dp")
    dp_group = collective.Group(axis="dp", process_group=mesh.group("dp"))
    if dp_size > 1:
        if mesh.group("dp") is None:
            raise RuntimeError(f"build_train_step: {mesh} has {dp_size} dp ranks but this "
                               "process has no group over them (call init_parallel_env)")
        if list(layer.named_buffers()):
            raise NotImplementedError(
                "build_train_step: a layer with buffers over a dp mesh (its batch statistics "
                f"would be the rank's, not the global batch's) is not ported yet ({_MESHED})")
    if amp_level not in ("O0", "O1", "O2"):
        raise ValueError(f"amp_level must be 'O0'|'O1'|'O2', got {amp_level!r}")
    amp_enabled = amp_level in ("O1", "O2")
    names = [n for n, _ in layer.named_parameters()]
    hypers = optimizer._hypers()
    l1_coeff = type(optimizer)._take_l1(hypers)
    update_one = type(optimizer)._update_one
    grad_clip = optimizer._grad_clip

    def init_fn():
        params = {n: p.detach().clone() for n, p in layer.named_parameters()}
        opt_state = {n: optimizer._init_state(params[n]) for n in names}
        if offload:
            opt_state = {n: tuple(_to_host(a) for a in st) for n, st in opt_state.items()}
            _sync(params)
        return params, opt_state

    def _sync(params):
        # the host copies are complete before anyone reads them
        for dev in {p.device for p in params.values() if p.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()

    def forward_loss(leaves, buffers, x, y, key):
        work = {n: b.clone() for n, b in buffers.items()}  # the forward updates these
        with contextlib.ExitStack() as stack:
            stack.enter_context(random_core.rng_guard(key))
            if dp_size > 1:  # this rank's slice of the global dropout masks
                stack.enter_context(random_core.dp_shard_guard(dp_rank, x.shape[0]))
            if amp_enabled:
                stack.enter_context(auto_cast(enable=True, level=amp_level,
                                              dtype=amp_dtype))
            out = torch.func.functional_call(layer, {**leaves, **work}, (x,))
            return loss_fn(out, y), work

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
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        buffers = dict(layer.named_buffers())
        loss, new_buffers = forward_loss(leaves, buffers, x, y, key)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(names, grads)]
        loss = loss.detach()
        if dp_size > 1:
            # the global batch's loss and gradients on every rank
            with torch.profiler.record_function("build_train_step.grad_allreduce"):
                grads = [g.contiguous() for g in grads]
                loss = loss.float().reshape(1)
                collective.coalesced_mean([loss, *grads], dp_group)
                loss = loss.reshape(())
        if grad_clip is not None:
            grads = grad_clip.clip_arrays(grads)
        bad = None
        if bad_step_guard:
            # the loss and the clipped gradients, as the reference checks
            # them; decided on the device, before anything is written
            with torch.no_grad():
                bad = tree_nonfinite(loss) | tree_nonfinite(grads)
        new_params, new_state = {}, {}
        lr_t = {}  # one float32 scalar per device
        # the update's range is named for a profiler to read (its cost when
        # no profiler runs: one host call)
        with torch.no_grad(), torch.profiler.record_function("build_train_step.update"):
            for n, b in new_buffers.items():
                buffers[n].copy_(b if bad is None else torch.where(bad, buffers[n], b))
            for n, g in zip(names, grads):
                p = params[n]
                if p.device not in lr_t:
                    lr_t[p.device] = (
                        lr.to(device=p.device, dtype=torch.float32)
                        if isinstance(lr, torch.Tensor)
                        else torch.full((), float(lr), dtype=torch.float32, device=p.device))
                state = opt_state[n]
                if offload:  # this parameter's state onto the card for its update
                    state = tuple(a.to(p.device, non_blocking=True) for a in state)
                new_p, new_st = update_one(p, g.to(p.dtype), lr_t[p.device], state, hypers,
                                           l1_coeff)
                if bad is not None:
                    new_p = torch.where(bad, p, new_p)
                    new_st = tuple(torch.where(bad, o, w) for o, w in zip(state, new_st))
                if donate:
                    for old, new in zip((p, *opt_state[n]), (new_p, *new_st)):
                        old.copy_(new, non_blocking=offload)
                    new_params[n], new_state[n] = p, opt_state[n]
                else:
                    new_params[n] = new_p
                    new_state[n] = tuple(_to_host(a) for a in new_st) if offload else new_st
        if offload:
            _sync(params)
        if bad_step_guard:
            return loss, new_params, new_state, bad
        return loss, new_params, new_state

    return step_fn, init_fn
