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

Options of the reference that this port does not implement yet raise
NotImplementedError; none is ignored.
"""
import contextlib

import torch

from ..amp.auto_cast import auto_cast
from ..core import random as random_core


def _unsupported(mesh, recompute, shard_optimizer, sharding_stage, fp16_allreduce,
                 dgc_configs, strategy, offload, bad_step_guard):
    found = []
    if mesh is not None and getattr(mesh, "size", None) != 1:
        found.append("a mesh of more than one device")
    for flag, name in ((recompute, "recompute"), (shard_optimizer, "shard_optimizer"),
                       (sharding_stage, f"sharding_stage={sharding_stage}"),
                       (fp16_allreduce, "fp16_allreduce"), (offload, "offload"),
                       (bad_step_guard, "bad_step_guard")):
        if flag:
            found.append(name)
    if dgc_configs is not None:
        found.append("dgc_configs")
    if strategy is not None:
        found.append("strategy")
    return found


def build_train_step(layer, loss_fn, optimizer, mesh=None, recompute=False,
                     shard_optimizer=False, sharding_stage=None, donate=True,
                     amp_level="O0", amp_dtype="bfloat16", fp16_allreduce=False,
                     dgc_configs=None, strategy=None, offload=False,
                     bad_step_guard=False):
    """One-device training step for ``layer``; ``loss_fn(model_out, y)``
    returns a scalar tensor. See the module docstring."""
    found = _unsupported(mesh, recompute, shard_optimizer, sharding_stage, fp16_allreduce,
                         dgc_configs, strategy, offload, bad_step_guard)
    if found:
        raise NotImplementedError(
            f"build_train_step: {', '.join(found)} not ported yet (the port's "
            "training step runs on one device)")
    if amp_level not in ("O0", "O1", "O2"):
        raise ValueError(f"amp_level must be 'O0'|'O1'|'O2', got {amp_level!r}")
    if any(True for _ in layer.buffers()):
        raise NotImplementedError("build_train_step: layers with buffers (BatchNorm "
                                  "statistics) are not ported yet")
    amp_enabled = amp_level in ("O1", "O2")
    names = [n for n, _ in layer.named_parameters()]
    hypers = optimizer._hypers()
    opt_update = type(optimizer)._update
    grad_clip = optimizer._grad_clip

    def init_fn():
        params = {n: p.detach().clone() for n, p in layer.named_parameters()}
        opt_state = {n: optimizer._init_state(params[n]) for n in names}
        return params, opt_state

    def forward_loss(leaves, x, y, key):
        with contextlib.ExitStack() as stack:
            stack.enter_context(random_core.rng_guard(key))
            if amp_enabled:
                stack.enter_context(auto_cast(enable=True, level=amp_level,
                                              dtype=amp_dtype))
            out = torch.func.functional_call(layer, leaves, (x,))
            return loss_fn(out, y)

    def step_fn(params, opt_state, x, y, key=None, lr=None):
        if key is None:
            key = random_core.PRNGKey(0)
        if lr is None:
            lr = optimizer.get_lr()
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        loss = forward_loss(leaves, x, y, key)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(names, grads)]
        if grad_clip is not None:
            grads = grad_clip.clip_arrays(grads)
        new_params, new_state = {}, {}
        with torch.no_grad():
            for n, g in zip(names, grads):
                p = params[n]
                lr_t = (lr.to(device=p.device, dtype=torch.float32)
                        if isinstance(lr, torch.Tensor)
                        else torch.full((), float(lr), dtype=torch.float32, device=p.device))
                out = opt_update(p, g.to(p.dtype), lr_t, *opt_state[n], **hypers)
                if donate:
                    for old, new in zip((p, *opt_state[n]), out):
                        old.copy_(new)
                    new_params[n], new_state[n] = p, opt_state[n]
                else:
                    new_params[n], new_state[n] = out[0], tuple(out[1:])
        return loss.detach(), new_params, new_state

    return step_fn, init_fn
