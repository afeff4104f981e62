"""Communication-efficient training: fp16 all-reduce, DGC, LocalSGD and
adaptive LocalSGD (counterpart of paddle_tpu/distributed/comm_opt.py;
reference: fleet/meta_optimizers/dgc_optimizer.py with
operators/dgc_op.cc, localsgd_optimizer.py, fp16_allreduce_optimizer.py).

The reference computes each worker's gradient inside ``shard_map`` over
the data axes, before any reduction; in the port each rank is such a
worker, so its gradient is its own already:

- **fp16_allreduce**: the local gradients are cast to float16, averaged
  over the group in float16 (the reference's pmean on float16: a sum over
  the ranks, then a division by their number) and cast back to float32.
  The loss is averaged in float32.
- **DGC** (``dgc_sparsify``): per rank, momentum correction (u = m*u + g),
  error accumulation (v += u), and the top-k of |v| by ``torch.topk``'s
  k-th value with the reference's ``>=`` mask; only the selected entries
  enter the average, and u, v are cleared there. Each rank's ``(u, v)``
  has the parameter's shape: row r of the reference's ``[N, ...]``.
  ``sparsity`` is the list's last value; the reference reads no ramp-up
  (``rampup_begin_step``, ``rampup_step``), so other values than the
  defaults raise.
- The floating buffers a local forward updated (BatchNorm's running
  statistics of the local batch) are averaged over the group.
- **LocalSGD** (``build_localsgd_train_step``): each rank keeps its own
  replica of the parameters and optimizer state (row r of the
  reference's ``[D, ...]``), runs local updates on its batch, and every
  k-th step the replicas are averaged. Every rank takes the same key,
  unchanged (the reference passes one key to every worker), and the
  layer's buffers stay as they were when the step was built (its forward
  loads them and threads none out).

``average_params`` is the group mean of a LocalSGD replica.
"""
import contextlib

import torch

from ..amp.auto_cast import auto_cast
from ..core import random as random_core
from ..nn import aux_loss
from . import collective, topology
from .spmd import DataGroup, _gradients, _lr_tensor, _update_all


def dgc_settings(dgc_configs):
    """(momentum, sparsity) from ``dgc_configs`` as the reference reads
    them: momentum 0.9, sparsity the last of a list (0.999)."""
    cfg = dict(dgc_configs or {})
    for knob, default in (("rampup_begin_step", 0), ("rampup_step", 1)):
        if cfg.get(knob, default) != default:
            raise NotImplementedError(
                f"dgc_configs {knob}={cfg[knob]!r}: the reference never reads it (no ramp-up)")
    sparsity = cfg.get("sparsity", [0.999])
    sparsity = sparsity[-1] if isinstance(sparsity, list) else sparsity
    return float(cfg.get("momentum", 0.9)), float(sparsity)


def dgc_sparsify(g, u, v, momentum, sparsity):
    """One DGC step for a single gradient tensor (local, before the
    average). Returns (send, new_u, new_v): ``send`` holds only the
    top-(1 - sparsity) fraction of |v| (the rest zero), u and v are
    cleared where it sends (error feedback). Reference: dgc_op.cc."""
    u = momentum * u + g
    v = v + u
    flat = torch.abs(v.reshape(-1))
    k = max(1, int(round(flat.numel() * (1.0 - sparsity))))
    kth = torch.topk(flat, k).values[-1]
    mask = (torch.abs(v) >= kth).to(v.dtype)
    send = v * mask
    keep = 1.0 - mask
    return send, u * keep, v * keep


def init_dgc_state(params):
    """Each parameter's (u, v), float32 zeros of its shape: this rank's."""
    return {n: (torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                torch.zeros(p.shape, dtype=torch.float32, device=p.device))
            for n, p in params.items()}


def exchange_local_grads(grads, loss, buffers, comm, group, fp16_allreduce, dgc, stats):
    """The local-gradient modes' exchange, in place: ``grads`` ({name:
    local gradient}) become the group's average (DGC's sent part, in
    float16 with ``fp16_allreduce``), ``loss`` (a float32 [1] tensor) the
    group's mean loss, the floating ``buffers`` their mean. ``dgc``:
    (momentum, sparsity) or None. ``stats`` gets the all-reduced bytes by
    dtype. Returns DGC's new {name: (u, v)} or None."""
    new_comm = None
    if dgc is not None:
        new_comm = {}
        for n, g in grads.items():
            u, v = comm[n]
            grads[n], nu, nv = dgc_sparsify(g, u, v, *dgc)
            new_comm[n] = (nu, nv)
    names = list(grads)
    sent = [grads[n].half() if fp16_allreduce else grads[n].contiguous() for n in names]
    floats = [b for b in buffers.values() if b.is_floating_point()]
    stats.clear()
    for t in (loss, *sent, *floats):
        stats[str(t.dtype)[6:]] = stats.get(str(t.dtype)[6:], 0) + t.numel() * t.element_size()
    collective.coalesced_mean([loss, *sent, *floats], group)
    for n, g in zip(names, sent):
        grads[n] = g.float() if fp16_allreduce else g
    return new_comm


def build_localsgd_train_step(layer, loss_fn, optimizer, mesh=None, k_steps=4, amp_level="O0",
                              amp_dtype="bfloat16", adaptive=False, init_k_steps=1,
                              begin_step=1):
    """LocalSGD's step (reference comm_opt.py:135, localsgd_optimizer.py):
    every rank updates its own replica on its batch, and the replicas are
    averaged at step i (0-based) when ``i % k_steps == k_steps - 1``.

    ``adaptive=True`` is AdaptiveLocalSGD (reference comm_opt.py:237-254,
    localsgd_optimizer.py:194): with ``step = i + 1``, ``loss0``/``lr0``
    taken at step 1 from the group's mean loss and the rate, a step syncs
    when ``step <= begin_step`` or ``step - last >= k``; past
    ``begin_step`` a due step sets ``k = clip(ceil(sqrt(lr0 * avg_loss *
    init_k / (lr * loss0 + 1e-12))), 1, 16)``. ``k`` and ``last`` are
    int32, ``loss0`` and ``lr0`` float32 device scalars, computed in the
    reference's order, in ``step_fn.comm_state["comm"]``.

    Returns (step_fn, init_fn). ``init_fn()`` gives this rank's replica
    (the layer's parameters) and optimizer state; ``step_fn(params,
    opt_state, x, y, key=None, lr=None)`` updates them in place and
    returns ``(loss, params, opt_state)``, the loss the group's mean. The
    key defaults to ``PRNGKey(i)``, as in the reference.
    """
    data = DataGroup(mesh or topology.get_global_mesh())
    if data.n == 1:
        raise ValueError("LocalSGD needs a data-parallel mesh axis >1")
    named = dict(layer.named_parameters())
    names = list(named)
    buffers0 = {n: b.detach().clone() for n, b in layer.named_buffers()}
    amp_enabled = amp_level in ("O1", "O2")
    hypers = optimizer._hypers()
    l1_coeff = type(optimizer)._take_l1(hypers)
    update_one = type(optimizer)._update_one
    grad_clip = optimizer._grad_clip

    def forward_loss(leaves, x, y, key):
        with contextlib.ExitStack() as stack:
            stack.enter_context(random_core.rng_guard(key))
            if amp_enabled:
                stack.enter_context(auto_cast(enable=True, level=amp_level, dtype=amp_dtype))
            work = {n: b.clone() for n, b in buffers0.items()}
            # the forward's aux losses join the objective (reference
            # comm_opt.py:188)
            auxes = stack.enter_context(aux_loss.collect_aux_losses())
            aux_loss.clear_direct_aux_losses(layer)
            out = torch.func.functional_call(layer, {**leaves, **work}, (x,))
            aux_loss.sweep_direct_aux_losses(layer, auxes)
            return loss_fn(out, y) + aux_loss.total_aux_loss(auxes)

    counter = {"i": 0, "comm": None}

    def init_comm(device):
        return {"k": torch.tensor(init_k_steps, dtype=torch.int32, device=device),
                "last": torch.tensor(0, dtype=torch.int32, device=device),
                "loss0": torch.tensor(0.0, dtype=torch.float32, device=device),
                "lr0": torch.tensor(0.0, dtype=torch.float32, device=device)}

    def step_fn(params, opt_state, x, y, key=None, lr=None):
        i = counter["i"]
        if key is None:
            key = random_core.PRNGKey(i)
        if lr is None:
            lr = optimizer.get_lr()
        device = next(iter(params.values())).device
        lr_t = _lr_tensor(lr, device)
        if counter["comm"] is None:
            counter["comm"] = init_comm(device)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        loss = forward_loss(leaves, x, y, key)
        grads = _gradients(loss, leaves, names)
        del leaves
        if grad_clip is not None:
            grads = dict(zip(names, grad_clip.clip_arrays([grads[n] for n in names])))
        with torch.no_grad():
            _update_all(names, opt_state, grads, lr_t, params, hypers, update_one, l1_coeff,
                        True, False, None)
            avg_loss = collective.all_reduce(loss.detach().float().reshape(1),
                                             collective.ReduceOp.AVG, data.group).reshape(())
            comm = counter["comm"]
            if adaptive:
                step = i + 1  # 1-based, as the reference's counter
                loss0 = avg_loss if step == 1 else comm["loss0"]
                lr0 = lr_t if step == 1 else comm["lr0"]
                due = (step - comm["last"]) >= comm["k"]
                sync = due | (step <= begin_step)
                next_k = torch.clamp(torch.ceil(torch.sqrt(
                    lr0 * avg_loss * float(init_k_steps) / (lr_t * loss0 + 1e-12))),
                    1, 16).to(torch.int32)
                counter["comm"] = {
                    "k": torch.where(due & (step > begin_step), next_k, comm["k"]),
                    "last": torch.where(sync, torch.full_like(comm["last"], step),
                                        comm["last"]),
                    "loss0": loss0.clone(), "lr0": lr0.clone()}
                sync = bool(sync)
            else:
                sync = i % k_steps == k_steps - 1
            if sync:
                collective.coalesced_mean([params[n] for n in names], data.group)
        counter["i"] += 1
        return avg_loss, params, opt_state

    step_fn.comm_state = counter

    def init_fn():
        params = {n: p.detach().clone() for n, p in named.items()}
        return params, {n: optimizer._init_state(params[n]) for n in names}

    return step_fn, init_fn


def average_params(params, layer=None):
    """The mean of LocalSGD's replicas over the global mesh's data group
    (the reference's mean over their leading axis); with ``layer``,
    written onto its parameters."""
    data = DataGroup(topology.get_global_mesh())
    avg = {n: v.detach().clone().contiguous() for n, v in params.items()}
    collective.coalesced_mean(list(avg.values()), data.group)
    if layer is not None:
        named = dict(layer.named_parameters())
        with torch.no_grad():
            for n, v in avg.items():
                named[n].copy_(v)
    return avg

