"""Pipeline-parallel runtime (counterpart of
paddle_tpu/distributed/meta_parallel/pipeline_parallel.py; reference:
fleet/meta_parallel/pipeline_parallel.py:36 PipelineParallel,
train_batch:85).

``pipeline_spmd_fn(stage_apply, num_stages, num_micro)`` is the forward
primitive: ``body(params_local, micro)`` runs on each rank of the global
mesh's "pp" axis with the rank's stage (``params_local``: {name: [1,
...]}), ``micro`` [num_micro, B, ...] (only stage 0 reads it); at tick t
stage s applies ``stage_apply`` to microbatch t - s, received from stage
s - 1, and sends it on; every rank returns the last stage's outputs
(summed over pp with zeros elsewhere, so exactly).

``PipelineParallel.train_batch(data, optimizer)``: over a mesh with pp >
1 it drives ``pipeline.build_pipeline_train_step`` over the wrapped
``PipelineLayer``'s homogeneous trunk (``split_pre_trunk_post``), with
``strategy.pipeline_configs["accumulate_steps"]`` microbatches, the key
``PRNGKey(n)`` at its n-th call, the optimizer's rate, and ``strategy.amp``
as O1 (O2 with ``use_pure_fp16``). ``data`` is this rank's local batch
(``spmd.shard_batch``): the global batch, rows of every data rank, must
divide by microbatches x data ranks, else the reference's ValueError. A
trunk that cannot be split warns loudly (RuntimeWarning) and trains on
the sequential path, as does a mesh without pp: the stages in order over
microbatches, each one's loss / n backward, then one ``optimizer.step()``.
The wrapped layers see the trained values lazily: ``forward``,
``eval_batch`` and ``state_dict`` first write them back, gathering every
stage's (and every mp block) over the mesh, so every rank calls them
together; ``state_dict`` is then the reference's whole dictionary.
"""
import warnings

import torch

from ...core import random as random_core
from ...core.tensor import wrap
from ...nn.layer import Layer
from .. import collective, topology
from . import mp_layers


def pipeline_spmd_fn(stage_apply, num_stages, num_micro):
    """Build ``body(params_local, micro)`` -> the last stage's outputs
    [num_micro, B, ...] on every pp rank (see the module docstring)."""

    def body(params_local, micro):
        mesh = topology.get_global_mesh()
        if mesh.axis_size("pp") != num_stages:
            raise ValueError(f"pipeline_spmd_fn: the global mesh has {mesh.axis_size('pp')} pp "
                             f"ranks, not {num_stages} stages")
        stage = mesh.rank_in("pp")
        pp = topology.AxisGroup(mesh, "pp") if num_stages > 1 else None
        p_slice = {n: a[0] for n, a in params_local.items()}
        outputs = torch.zeros_like(micro)
        for t in range(num_micro + num_stages - 1):
            m = t - stage
            if not 0 <= m < num_micro:
                continue
            if stage == 0:
                x_in = micro[m]
            else:
                x_in = collective.recv(torch.empty_like(micro[0]), stage - 1, pp.group)
            y = stage_apply(p_slice, x_in)
            if stage < num_stages - 1:
                collective.send(y.contiguous(), stage + 1, pp.group)
            else:
                outputs[m] = y
        if pp is not None:
            collective.all_reduce(outputs, collective.ReduceOp.SUM, pp.group)
        return outputs

    return body


class PipelineParallel(Layer):
    """reference pipeline_parallel.py:36; see the module docstring."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        acc = 1
        if strategy is not None:
            acc = strategy.pipeline_configs.get("accumulate_steps", 1)
        self._micro_batches = max(acc, 1)
        self._spmd = None
        self._spmd_key = None  # (optimizer, mesh) the step was built for
        self._dirty = False  # the step's parameters newer than the layers'
        self._step_count = 0

    def forward(self, *args, **kwargs):
        self._sync_params()
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **kw):
        self._sync_params()
        return super().state_dict(*a, **kw)

    def _ensure_spmd(self, optimizer):
        """The pp step for ``optimizer`` over the global mesh (rebuilt when
        either changes), or None where the mesh has no pp or the trunk
        cannot be split."""
        from .. import pipeline as pipe

        mesh = topology.get_global_mesh()
        if self._spmd_key is not None and self._spmd_key[0] is optimizer \
                and self._spmd_key[1] is mesh:
            return self._spmd
        self._sync_params()
        self._spmd = None
        self._spmd_key = (optimizer, mesh)
        pp = mesh.axis_size("pp")
        if pp <= 1:
            return None
        layers = (list(self._layers.run_functions) if hasattr(self._layers, "run_functions")
                  else [self._layers])
        try:
            pre, trunk, post = pipe.split_pre_trunk_post(layers, pp)
        except ValueError as e:
            warnings.warn(
                f"PipelineParallel: no homogeneous trunk divisible into pp={pp} stages ({e}); "
                "FALLING BACK to sequential single-device microbatching — no pipeline "
                "parallelism is happening. Make the repeated blocks structurally identical "
                "or set pp=1.", RuntimeWarning, stacklevel=3)
            return None
        amp_level, amp_dtype = "O0", "bfloat16"
        if self._strategy is not None and getattr(self._strategy, "amp", False):
            cfg = getattr(self._strategy, "amp_configs", {}) or {}
            amp_level = "O2" if cfg.get("use_pure_fp16") else "O1"
            amp_dtype = cfg.get("dtype", "bfloat16")
        inner = getattr(optimizer, "_inner", optimizer)  # fleet's wrapper
        step, init = pipe.build_pipeline_train_step(
            pre, trunk, post, self._layers._loss_fn, inner, mesh=mesh,
            num_micro=self._micro_batches, amp_level=amp_level, amp_dtype=amp_dtype)
        params, state = init()
        self._spmd = dict(step=step, params=params, state=state, pre=pre, trunk=trunk,
                          post=post, lps=len(trunk) // pp, mesh=mesh)
        return self._spmd

    def _sync_params(self):
        """Write the step's parameters into the layers: pre/post as they
        are, the trunk's stage blocks gathered over pp (and mp)."""
        if not self._dirty or self._spmd is None:
            return
        ctx = self._spmd
        params, mesh, step = ctx["params"], ctx["mesh"], ctx["step"]
        with torch.no_grad():
            for prefix in ("pre", "post"):
                for i, layer in enumerate(ctx[prefix]):
                    for n, p in layer.named_parameters():
                        p.copy_(params[f"{prefix}.{i}.{n}"])
            template = ctx["trunk"][0]
            for n, _ in template.named_parameters():
                a = params[f"stages.{n}"]
                d = step.mp_dims[f"stages.{n}"]
                if d is not None:
                    a = mp_layers._all_gather(a, d, topology.AxisGroup(mesh))
                if mesh.axis_size("pp") > 1:
                    a = mp_layers._all_gather(a, 0, topology.AxisGroup(mesh, "pp"))
                whole = a.reshape((-1,) + tuple(a.shape[2:]))
                for layer, w in zip(ctx["trunk"], whole):
                    dict(layer.named_parameters())[n].copy_(w)
        self._dirty = False

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """reference pipeline_parallel.py:85; see the module docstring."""
        x, y = data
        ctx = self._ensure_spmd(optimizer)
        if ctx is not None:
            mesh = ctx["mesh"]
            n_data = mesh.axis_size(("dp", "sharding"))
            need = self._micro_batches * n_data
            if (x.shape[0] * n_data) % need != 0:
                raise ValueError(
                    f"pipeline train_batch needs batch size divisible by micro_batches*dp "
                    f"({need}); got {x.shape[0] * n_data}")
            self._step_count += 1
            loss, ctx["params"], ctx["state"] = ctx["step"](
                ctx["params"], ctx["state"], x, y,
                key=random_core.PRNGKey(self._step_count), lr=optimizer.get_lr())
            self._dirty = True
            if lr_scheduler is not None:
                lr_scheduler.step()
            return wrap(loss)
        n_micro = min(self._micro_batches, x.shape[0])
        total = 0.0
        for xb, yb in zip(torch.tensor_split(x, n_micro), torch.tensor_split(y, n_micro)):
            out = self._layers.forward(xb)
            loss = self._layers._loss_fn(out, yb)
            (loss * (1.0 / n_micro)).backward()
            total += float(loss)
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return wrap(torch.tensor(total / n_micro, dtype=torch.float32))

    def eval_batch(self, data, compute_loss=True):
        self._sync_params()
        x, y = data
        out = self._layers.forward(x)
        if compute_loss:
            return self._layers._loss_fn(out, y)
        return out
