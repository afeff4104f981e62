"""Pipeline-parallel training (counterpart of
paddle_tpu/distributed/pipeline.py; reference analogs: the static
PipelineOptimizer's program split with send_v2/recv_v2
(fluid/optimizer.py:3718, 4269) and SectionWorker's F-then-B schedule
(framework/section_worker.cc:116)).

``build_pipeline_train_step(pre, trunk, post, loss_fn, optimizer, mesh,
num_micro)`` returns ``(step_fn, init_fn)`` with the ``build_train_step``
contract. The reference is one SPMD program whose trunk weights are
stacked ``[S, lps, ...]`` over the "pp" axis; here rank (pp = s) holds
stage s: ``init_fn`` returns ``stages.<name>`` as the rank's ``[1, lps,
...]`` block of the reference's array, and ``pre.<i>.<name>`` /
``post.<i>.<name>`` whole on every rank.

A step is GPipe over point-to-point messages on the pp group: stage 0
runs the pre layers on the local batch and splits it into ``num_micro``
microbatches; at tick t, stage s runs microbatch m = t - s (the ranks skip
the reference's inactive ticks, which only carry zeros) with the key
``fold_in(fold_in(key, t), s)`` split into one key per layer, receives it
from stage s - 1 and sends its output to s + 1. The last stage joins the
outputs in order, runs the post layers and ``loss_fn`` over the whole local
batch; then every microbatch's gradient travels back in reverse order (the
reference's whole-graph gradient). Pre layer i runs under
``fold_in(fold_in(key, 10000), i)``, post layer i under
``fold_in(fold_in(key, 20000), i)``, both under ``dp_shard_guard`` (the
reference runs them on the global batch), the trunk under the keys alone
(its shard_map body draws each device's local mask). The loss and the pre
and post gradients are summed over the pp group (zeros on the stages that
do not own them, so the sum is exact): the loss comes back on every rank,
and pre/post stay bitwise equal on every pp rank. ``step_fn.recv_seconds``
holds the last step's seconds spent in ``recv`` (host clock).

``recompute=True`` wraps each stage application in
``torch.utils.checkpoint`` (its keys entered inside), so the backward runs
it again. ``amp_level`` O1/O2: pre, post and the loss run under
``auto_cast``; the trunk carry stays float32 and each stage interior runs
in ``amp_dtype``, its parameters and input cast at the stage boundary and
its output cast back (pipeline.py:201-212, 292-296).

Composition: the data axes ("dp", "sharding") shard the batch (each rank
passes its local rows) and average the gradients and the loss; with a
data axis the optimizer state is ZeRO-1 sharded (pipeline.py:331-349) on
the first dimension of the rank's block that the data ranks divide, from
dimension 2 for ``stages.*`` (behind the [stage, layer] dims), each rank
updating its block and all-gathering the parameter. An "mp" axis runs
inside each stage: the trunk's tensor-parallel parameters are the rank's
mp blocks behind the [stage, layer] dims, and the stage runs inside
``mp_layers.tensor_parallel``. An "sp" axis shards the trunk's sequence
(dimension 1): the pre layers see the whole sequence and the trunk its
rank's slice (the slice's gradient all-gathered), the outputs are
all-gathered before the post layers, the stage interior rings its
attention through ``ring_attention_in_shard_map``, and the trunk's
gradients are summed over sp. An "ep" axis runs inside each stage too
(the reference's auto axis of the pp ``shard_map``): the trunk's expert
parameters (``mp_spec`` "ep", ``incubate.moe.MoELayer``) are the rank's ep
blocks behind the [stage, layer] dims, and the stage runs inside
``expert_parallel.expert_parallel(mesh)`` on its local microbatch.

Aux losses (an MoE layer's load balancing) are dropped in every layer
application, pre, stage and post, as the reference's per-stage applies
drop them (``nn.aux_loss.drop_aux_losses``); ``build_fsdp_train_step``
shares ``functional_apply`` and drops them too.

Lamb's and LARS' trust ratio reads the norms of the reference's global
arrays (a ``stages.*`` array is every stage's layers stacked): a block's
sums of squares are added over pp, mp, ep and the data ranks that split
it (``spmd.block_sum_sq``). ``step_fn.layout`` records each leaf's cuts
(``spmd.build_train_step``'s contract).

``step_fn.schedule`` is ``schedule_stats(S, M)``. The layer helpers
``functional_apply`` and ``split_pre_trunk_post`` are shared with
ZeRO-3's ``build_fsdp_train_step``.
"""
import contextlib
import time

import torch
import torch.profiler
import torch.utils.checkpoint

from ..amp.auto_cast import auto_cast
from ..core import random as random_core
from ..nn import aux_loss
from ..ops import ring_attention as ring_ops
from . import collective, expert_parallel, topology
from .meta_parallel import mp_layers


def functional_apply(layer, params, x, key, amp=None):
    """``layer``'s forward on ``x`` with ``params`` ({name: tensor}) in
    place of its own, its random ops under ``rng_guard(key)``; ``amp``:
    (level, dtype) to run it under ``auto_cast``, or None."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(random_core.rng_guard(key))
        stack.enter_context(aux_loss.drop_aux_losses())
        if amp is not None:
            stack.enter_context(auto_cast(enable=True, level=amp[0], dtype=amp[1]))
        return torch.func.functional_call(layer, params, (x,))


def _layer_signature(layer):
    """Structural identity for homogeneity: class + param shapes/dtypes."""
    return (type(layer).__name__,
            tuple((n, tuple(p.shape), str(p.dtype)) for n, p in layer.named_parameters()))


def split_pre_trunk_post(layers, num_stages):
    """Find the longest contiguous run of structurally identical layers
    whose length divides into num_stages equal segments (right-aligned
    in its run). Returns (pre_layers, trunk_layers, post_layers)."""
    n = len(layers)
    sigs = [_layer_signature(l) for l in layers]
    best = None  # (length, start)
    i = 0
    while i < n:
        j = i
        while j < n and sigs[j] == sigs[i]:
            j += 1
        usable = ((j - i) // num_stages) * num_stages
        if usable >= num_stages and (best is None or usable > best[0]):
            best = (usable, i + (j - i - usable))
        i = j
    if best is None:
        raise ValueError(f"no contiguous run of {num_stages}+ structurally-identical layers "
                         "found; pipeline needs a homogeneous trunk")
    length, start = best
    return (list(layers[:start]), list(layers[start:start + length]),
            list(layers[start + length:]))


def schedule_stats(num_stages, num_micro):
    """Analytic schedule properties of the GPipe pipeline: ``num_micro +
    num_stages - 1`` ticks, the bubble fraction (S - 1) / (M + S - 1)
    (reference section_worker.cc:135's ramp geometry)."""
    ticks = num_micro + num_stages - 1
    return {"num_stages": int(num_stages), "num_micro": int(num_micro), "ticks": int(ticks),
            "bubble_fraction": float((num_stages - 1) / ticks)}


_AMP_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
               "float16": torch.float16, "fp16": torch.float16}
_DTYPE_CODES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


def build_pipeline_train_step(pre_layers, trunk_layers, post_layers, loss_fn, optimizer,
                              mesh=None, num_micro=None, recompute=False, donate=True,
                              amp_level="O0", amp_dtype="bfloat16"):
    """A pipeline-parallel training step; see the module docstring.
    ``loss_fn(out, y)`` returns a scalar tensor, a mean over the batch."""
    from .spmd import DataGroup, _init_blocks, _update_all, block_sum_sq, sum_sq_over, zero_dim

    if amp_level not in ("O0", "O1", "O2"):
        raise ValueError(f"amp_level must be 'O0'|'O1'|'O2', got {amp_level!r}")
    amp_enabled = amp_level in ("O1", "O2")
    if amp_dtype not in _AMP_DTYPES:
        raise ValueError(f"amp_dtype must be bfloat16/bf16/float16/fp16, got {amp_dtype!r}")
    amp_dt = _AMP_DTYPES[amp_dtype]
    amp = (amp_level, amp_dtype) if amp_enabled else None
    mesh = mesh or topology.get_global_mesh()
    num_stages = mesh.axis_size("pp")
    n_trunk = len(trunk_layers)
    if n_trunk % num_stages != 0:
        raise ValueError(f"{n_trunk} trunk layers not divisible into {num_stages} pipeline "
                         "stages")
    lps = n_trunk // num_stages
    num_micro = int(num_micro or num_stages)
    stage = mesh.rank_in("pp")
    last = num_stages - 1
    pp = topology.AxisGroup(mesh, "pp") if num_stages > 1 else None
    sp = topology.AxisGroup(mesh, "sp") if mesh.axis_size("sp") > 1 else None
    tp = topology.AxisGroup(mesh) if mesh.axis_size("mp") > 1 else None
    ep = topology.AxisGroup(mesh, "ep") if mesh.axis_size("ep") > 1 else None
    data = DataGroup(mesh)
    template = trunk_layers[0]
    trunk_names = [n for n, _ in template.named_parameters()]
    # the trunk parameters' mp and ep dimensions within one layer (None:
    # whole)
    trunk_mpd = {n: (mp_layers.mp_dim(getattr(p, "mp_spec", None)) if tp is not None else None)
                 for n, p in template.named_parameters()}
    trunk_epd = {n: (mp_layers.mp_dim(getattr(p, "mp_spec", None), "ep")
                     if ep is not None and trunk_mpd[n] is None else None)
                 for n, p in template.named_parameters()}

    def own(layer):
        return {n: p.detach() for n, p in layer.named_parameters()}

    whole0 = {}
    for i, l in enumerate(pre_layers):
        whole0.update({f"pre.{i}.{n}": a for n, a in own(l).items()})
    mine = trunk_layers[stage * lps:(stage + 1) * lps]
    for n in trunk_names:
        t = torch.stack([own(l)[n] for l in mine])[None]  # [1, lps, ...]
        if trunk_mpd[n] is not None:
            t = tp.block(t, 2 + trunk_mpd[n])
        if trunk_epd[n] is not None:
            t = ep.block(t, 2 + trunk_epd[n])
        whole0[f"stages.{n}"] = t
    for i, l in enumerate(post_layers):
        whole0.update({f"post.{i}.{n}": a for n, a in own(l).items()})
    names = list(whole0)
    stage_names = [f"stages.{n}" for n in trunk_names]
    mp_names = [f"stages.{n}" for n in trunk_names if trunk_mpd[n] is not None]
    ep_names = [f"stages.{n}" for n in trunk_names if trunk_epd[n] is not None]
    edge_names = [n for n in names if not n.startswith("stages.")]
    # ZeRO-1's dimension of each parameter's block: from 2 for a stage's
    # (behind the [stage, layer] dims)
    dims = {n: zero_dim(tuple(a.shape), data.n, start=2 if n.startswith("stages.") else 0)
            for n, a in whole0.items()}
    sharded = [n for n in names if dims[n] is not None]
    hypers = optimizer._hypers()
    l1_coeff = type(optimizer)._take_l1(hypers)
    update_one = type(optimizer)._update_one
    grad_clip = optimizer._grad_clip
    # each leaf's cuts of the reference's global array, outer first
    model_cuts = {n: () for n in names}
    for n in trunk_names:
        model_cuts[f"stages.{n}"] = (((0, stage, num_stages),)
                                     + (((2 + trunk_mpd[n], tp.rank, tp.n),)
                                        if trunk_mpd[n] is not None else ())
                                     + (((2 + trunk_epd[n], ep.rank, ep.n),)
                                        if trunk_epd[n] is not None else ()))
    layout = {"params": model_cuts,
              "opt_state": {n: model_cuts[n] + (((dims[n], data.rank, data.n),)
                                                if dims[n] is not None else ())
                            for n in names}}
    update_sum_sq = None if type(optimizer)._elementwise(hypers) else {
        n: block_sum_sq([pp.group if pp is not None and n in stage_names else None,
                         tp.group if n in mp_names else None,
                         ep.group if n in ep_names else None,
                         data.group if dims[n] is not None else None]) for n in names}
    carry_spec = {}  # (x shape, x dtype) -> (microbatch shape, dtype)
    recv_seconds = []

    def block(t, n):
        return collective.shard(t, dims[n], data.rank, data.n)

    def init_fn():
        params = {n: a.clone() for n, a in whole0.items()}
        return params, _init_blocks(optimizer, params, dims, data)

    def stage_apply(x, key, *slices):
        """This stage's lps layers on ``x`` (``slices``: each trunk
        parameter's [lps, ...] stack)."""
        keys = random_core.split(key, lps)
        dtype = x.dtype
        if amp_enabled:
            x = x.to(amp_dt)
            slices = [s.to(amp_dt) if s.is_floating_point() else s for s in slices]
        h = x
        with contextlib.ExitStack() as stack:
            stack.enter_context(mp_layers.tensor_parallel(mesh))
            stack.enter_context(expert_parallel.expert_parallel(mesh))
            if sp is not None:
                stack.enter_context(ring_ops.shard_scope(mesh))
            for j in range(lps):
                h = functional_apply(template, {n: s[j] for n, s in zip(trunk_names, slices)},
                                     h, keys[j])
        return h.to(dtype)

    def run_stage(x, key, slices):
        if recompute:
            return torch.utils.checkpoint.checkpoint(stage_apply, x, key, *slices,
                                                     use_reentrant=False)
        return stage_apply(x, key, *slices)

    def edge_guards(local_batch):
        stack = contextlib.ExitStack()
        if data.n > 1:
            stack.enter_context(random_core.dp_shard_guard(data.rank, local_batch))
        if amp is not None:
            stack.enter_context(auto_cast(enable=True, level=amp[0], dtype=amp[1]))
        return stack

    def edge(layers, prefix, leaves, h, key, base):
        k = random_core.fold_in(key, base)
        for i, layer in enumerate(layers):
            h = functional_apply(layer, {n: leaves[f"{prefix}.{i}.{n}"]
                                         for n, _ in layer.named_parameters()},
                                 h, random_core.fold_in(k, i))
        return h

    def carry_of(x, pre_out):
        """The microbatch's shape and dtype on every stage: stage 0 knows
        it from the pre layers' output and broadcasts it over the pp
        group the first time a batch of this shape comes."""
        spec_key = (tuple(x.shape), str(x.dtype))
        if spec_key in carry_spec:
            return carry_spec[spec_key]
        head = torch.zeros(9, dtype=torch.int64, device=x.device)
        if stage == 0:
            shape = list(pre_out.shape)
            head[0] = len(shape)
            head[1:1 + len(shape)] = torch.tensor(shape)
            head[8] = _DTYPE_CODES.index(pre_out.dtype)
        if pp is not None:
            collective.broadcast(head, 0, pp.group)
        head = head.tolist()
        shape = head[1:1 + head[0]]
        shape[0] //= num_micro
        carry_spec[spec_key] = (shape, _DTYPE_CODES[head[8]])
        return carry_spec[spec_key]

    def recv(buf, src):
        t0 = time.perf_counter()
        collective.recv(buf, src, pp.group)
        recv_seconds[-1] += time.perf_counter() - t0
        return buf

    def step_fn(params, opt_state, x, y, key=None, lr=None):
        if key is None:
            key = random_core.PRNGKey(0)
        if lr is None:
            lr = optimizer.get_lr()
        if x.shape[0] % num_micro:
            raise ValueError(f"pipeline step: a local batch of {x.shape[0]} rows does not split "
                             f"into {num_micro} microbatches")
        recv_seconds.append(0.0)
        del recv_seconds[:-1]
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        slices = [leaves[f"stages.{n}"][0] for n in trunk_names]
        trunk_grads = {n: None for n in stage_names}
        grads = {}

        # ---- forward: pre on stage 0, then the ticks
        pre_out = trunk_in = None
        if stage == 0:
            with edge_guards(x.shape[0]):
                pre_out = edge(pre_layers, "pre", leaves, x, key, 10_000)
            if amp_enabled:
                pre_out = pre_out.float()  # the trunk carry is float32
            trunk_in = pre_out if sp is None else mp_layers.ScatterToMP.apply(pre_out, 1, sp)
        shape, dtype = carry_of(x, trunk_in)
        ins, outs = [], []
        micro = None
        if stage == 0:
            micro = [t.detach().requires_grad_(True) for t in trunk_in.chunk(num_micro)]
        for t in range(num_micro + num_stages - 1):
            m = t - stage
            if not 0 <= m < num_micro:
                continue
            x_in = (micro[m] if stage == 0 else
                    recv(torch.empty(shape, dtype=dtype, device=x.device), stage - 1)
                    .requires_grad_(True))
            out = run_stage(x_in, random_core.fold_in(random_core.fold_in(key, t), stage),
                            slices)
            if stage < last:
                collective.send(out.detach(), stage + 1, pp.group)
            ins.append(x_in)
            outs.append(out)

        # ---- the loss on the last stage, then the backward in reverse
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        if stage == last:
            held = [o.detach().requires_grad_(True) for o in outs]
            h = torch.cat(held)
            if sp is not None:
                h = mp_layers.GatherFromMP.apply(h, 1, sp)
            with edge_guards(x.shape[0]):
                h = edge(post_layers, "post", leaves, h, key, 20_000)
                value = loss_fn(h, y)
            post = [n for n in names if n.startswith("post.")]
            got = torch.autograd.grad(value, [leaves[n] for n in post] + held, allow_unused=True)
            grads.update(zip(post, got[:len(post)]))
            out_grads = list(got[len(post):])
            loss = value.detach().float().reshape(())
        in_grads = [None] * len(outs)
        for m in reversed(range(len(outs))):
            if stage == last:
                g = out_grads[m] if out_grads[m] is not None else torch.zeros_like(outs[m])
            else:
                g = recv(torch.empty_like(outs[m]), stage + 1)
            got = torch.autograd.grad(outs[m], slices + [ins[m]], g, allow_unused=True)
            for n, gi in zip(stage_names, got[:-1]):
                if gi is not None:
                    trunk_grads[n] = gi if trunk_grads[n] is None else trunk_grads[n] + gi
            in_grads[m] = got[-1] if got[-1] is not None else torch.zeros_like(ins[m])
            if stage > 0:
                collective.send(in_grads[m].contiguous(), stage - 1, pp.group)
        if stage == 0:
            pre = [n for n in names if n.startswith("pre.")]
            if pre:
                got = torch.autograd.grad(trunk_in, [leaves[n] for n in pre],
                                          torch.cat(in_grads), allow_unused=True)
                grads.update(zip(pre, got))
        del leaves, outs, ins, micro, in_grads
        for n in names:
            g = grads.get(n, trunk_grads.get(n))
            if g is None:
                g = torch.zeros_like(params[n])
            grads[n] = g.reshape(params[n].shape) if n in trunk_grads else g
        # ---- the gradients' sums: pre/post and the loss over pp (zeros on
        # the stages that do not own them), the trunk's over sp, then the
        # mean over the data axes
        with torch.no_grad(), torch.profiler.record_function("pipeline.grad_allreduce"):
            for n in names:
                grads[n] = grads[n].contiguous()
            loss = loss.reshape(1)
            if pp is not None:
                collective.coalesced_sum([loss] + [grads[n] for n in edge_names], pp.group)
            if sp is not None:
                collective.coalesced_sum([grads[n] for n in stage_names], sp.group)
            if data.n > 1:
                collective.coalesced_mean([loss] + [grads[n] for n in names], data.group)
            loss = loss.reshape(())
        if grad_clip is not None:
            idx = {n: i for i, n in enumerate(names)}
            sum_sq = sum_sq_over({None if pp is None else pp.group:
                                  [idx[n] for n in stage_names],
                                  None if tp is None else tp.group: [idx[n] for n in mp_names],
                                  None if ep is None else ep.group: [idx[n] for n in ep_names]})
            grads = dict(zip(names, grad_clip.clip_arrays([grads[n] for n in names],
                                                          sum_sq=sum_sq)))
        with torch.no_grad(), torch.profiler.record_function("pipeline.update"):
            blocks = {n: block(p, n) for n, p in params.items()}
            grads = {n: block(g, n) for n, g in grads.items()}
            parts, new_state = _update_all(names, opt_state, grads, lr, blocks, hypers,
                                           update_one, l1_coeff, donate, False, None,
                                           update_sum_sq)
            new_params = dict(parts)
            if sharded:  # ZeRO-1: every data rank's blocks make the whole
                for n, t in zip(sharded, collective.coalesced_all_gather(
                        [parts[n] for n in sharded], [dims[n] for n in sharded], data.group)):
                    if donate:
                        params[n].copy_(t)
                        new_params[n] = params[n]
                    else:
                        new_params[n] = t
        return loss, new_params, new_state

    step_fn.schedule = schedule_stats(num_stages, num_micro)
    step_fn.recv_seconds = recv_seconds
    step_fn.zero_dims = dims
    step_fn.mp_dims = {f"stages.{n}": (None if d is None else 2 + d)
                       for n, d in trunk_mpd.items()}
    step_fn.ep_dims = {f"stages.{n}": (None if d is None else 2 + d)
                       for n, d in trunk_epd.items()}
    step_fn.stage = stage
    step_fn.layout = layout
    return step_fn, init_fn
