"""The training step (counterpart of ``build_train_step`` in
paddle_tpu/distributed/spmd.py), single-device subset.

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

Options of the reference that this port does not implement yet raise
NotImplementedError (a mesh, ZeRO sharding, fp16 all-reduce, DGC, a
strategy); none is ignored.
"""
import contextlib

import torch
import torch.profiler
import torch.utils.checkpoint

from ..amp.auto_cast import auto_cast
from ..core import random as random_core
from ..resilience.badstep import tree_nonfinite


def _unsupported(mesh, shard_optimizer, sharding_stage, fp16_allreduce,
                 dgc_configs, strategy):
    found = []
    if mesh is not None and getattr(mesh, "size", None) != 1:
        found.append("a mesh of more than one device")
    for flag, name in ((shard_optimizer, "shard_optimizer"),
                       (sharding_stage, f"sharding_stage={sharding_stage}"),
                       (fp16_allreduce, "fp16_allreduce")):
        if flag:
            found.append(name)
    if dgc_configs is not None:
        found.append("dgc_configs")
    if strategy is not None:
        found.append("strategy")
    return found


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
    """One-device training step for ``layer``; ``loss_fn(model_out, y)``
    returns a scalar tensor. See the module docstring."""
    found = _unsupported(mesh, shard_optimizer, sharding_stage, fp16_allreduce,
                         dgc_configs, strategy)
    if found:
        raise NotImplementedError(
            f"build_train_step: {', '.join(found)} not ported yet (the port's "
            "training step runs on one device)")
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
        if grad_clip is not None:
            grads = grad_clip.clip_arrays(grads)
        bad = None
        if bad_step_guard:
            # the loss and the clipped gradients, as the reference checks
            # them; decided on the device, before anything is written
            with torch.no_grad():
                bad = tree_nonfinite(loss.detach()) | tree_nonfinite(grads)
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
            return loss.detach(), new_params, new_state, bad
        return loss.detach(), new_params, new_state

    return step_fn, init_fn
