"""Megatron tensor-parallel layers (counterpart of
paddle_tpu/distributed/meta_parallel/mp_layers.py; reference:
fleet/meta_parallel/parallel_layers/mp_layers.py:31 VocabParallelEmbedding,
:87 ColumnParallelLinear, :145 RowParallelLinear; the RNG tracker
parallel_layers/random.py:24).

A layer is built whole, as in the reference, and carries the reference's
``mp_spec`` (the dimension sharded over "mp") and ``is_distributed``.
Outside a tensor-parallel scope it is the plain layer (the reference's
``_constraint`` is a no-op outside jit, :25-31). Inside one
(``tensor_parallel(mesh)`` with mp > 1, which the training steps enter)
its parameters are the rank's blocks on the ``mp_spec`` dimension (the
step's ``functional_call`` passes them), the block of rank
``mesh.rank_in("mp")``, and it runs the collectives that XLA inserts for
the reference, as ``torch.autograd.Function``s over the mesh's mp group:

- ``CopyToMP``: the identity forward, an all-reduce (sum) of the gradient
  backward (a column-parallel input);
- ``ReduceFromMP``: an all-reduce (sum) forward, the identity backward
  (a row-parallel output, before its bias; the vocab-parallel lookup);
- ``GatherFromMP``: an all-gather of the blocks along a dimension forward,
  the rank's slice of the gradient backward (``gather_output``; every
  rank computes the same downstream, so no sum is needed);
- ``ScatterToMP``: the rank's slice forward, an all-gather of the
  gradients backward (a row-parallel input that is not yet parallel);
- ``GatherWeight``: a block of a weight made whole forward, the summed
  gradient's block backward (Llama's K/V projections where mp does not
  divide the KV heads).

The vocab-parallel lookup masks the ids outside the rank's rows and sums
the ranks' rows. The replicated parameters see the same gradient on every
rank (the all-reduces give every rank the same bits), so they stay equal.

``ParallelCrossEntropy`` is ``cross_entropy(reduction="none")`` on whole
logits, as the reference's. ``RNGStatesTracker`` holds named keys on the
port's jax-compatible key stream (``core/random.py``): ``rng_state(name)``
splits the name's key and runs the block under ``rng_guard`` of the
second half, giving the reference's keys bitwise. As in the reference, an
unknown name is seeded with ``hash(name) % 2**31``, which Python salts per
process: ranks can then draw different keys for one name unless its seed
is ``add``ed.
"""
import contextlib
import contextvars

import numpy as np
import torch

from ...amp.auto_cast import cast_inputs
from ...core import random as random_core
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer import Layer
from .. import collective
from ..topology import AxisGroup

_TP = contextvars.ContextVar("tensor_parallel", default=None)


@contextlib.contextmanager
def tensor_parallel(mesh):
    """Run the enclosed forward with the tensor-parallel layers in their
    parallel form over ``mesh``'s mp axis (yields the ``AxisGroup``); with
    mp = 1 (or no mesh) the layers stay plain (yields None)."""
    if mesh is None or mesh.axis_size("mp") == 1:
        yield None
        return
    token = _TP.set(AxisGroup(mesh))
    try:
        yield _TP.get()
    finally:
        _TP.reset(token)


def mp_group():
    """The active ``AxisGroup``, or None outside a tensor-parallel scope."""
    return _TP.get()


def mp_dim(spec, axis="mp"):
    """The dimension an ``mp_spec`` shards over ``axis``, or None."""
    if spec is None:
        return None
    return next((d for d, a in enumerate(spec) if a == axis
                 or (isinstance(a, tuple) and axis in a)), None)


def _all_gather(t, dim, tp):
    parts = collective.all_gather([], t.contiguous(), tp.group)
    return torch.cat(parts, dim=dim)


class CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective.all_reduce(g.contiguous().clone(), collective.ReduceOp.SUM,
                                     ctx.tp.group), None


class ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return collective.all_reduce(x.contiguous().clone(), collective.ReduceOp.SUM, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _all_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.block(g, ctx.dim).contiguous(), None, None


class ScatterToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return tp.block(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.tp), None, None


class GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _all_gather(w, dim, tp)

    @staticmethod
    def backward(ctx, g):
        g = collective.all_reduce(g.contiguous().clone(), collective.ReduceOp.SUM, ctx.tp.group)
        return ctx.tp.block(g, ctx.dim).contiguous(), None, None


def vocab_parallel_lookup(ids, w, tp):
    """The embedding rows of ``ids`` from this rank's rows ``w`` of the
    table: the ids outside the rank's rows give zeros, and the ranks' rows
    are summed."""
    rows = w.shape[0]
    start = tp.rank * rows
    ids = ids.long()
    mine = (ids >= start) & (ids < start + rows)
    out = w[torch.where(mine, ids - start, 0)]
    out = torch.where(mine[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return ReduceFromMP.apply(out, tp)


class VocabParallelEmbedding(Layer):
    """Embedding with the vocab axis sharded over 'mp'."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None, name=None,
                 mp_group=None, *, device=None, generator=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 0.02), device=device, generator=generator)
        self.weight.is_distributed = True
        self.weight.mp_spec = ("mp", None)

    def forward(self, x):
        (w,) = cast_inputs("vocab_parallel_embedding", self.weight)
        tp = mp_group()
        if tp is None:
            return w[x.long()]
        return vocab_parallel_lookup(x, w, tp)


class ColumnParallelLinear(Layer):
    """Linear with output features sharded over 'mp' (reference :87)."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=None,
                 gather_output=True, name=None, mp_group=None, *, device=None,
                 generator=None):
        super().__init__()
        self.gather_output = gather_output
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter([in_features, out_features], attr=weight_attr,
                                            default_initializer=I.XavierNormal(), **kw)
        self.weight.is_distributed = True
        self.weight.mp_spec = (None, "mp")
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True, **kw)
            self.bias.mp_spec = ("mp",)

    def forward(self, x):
        x, w, b = cast_inputs("column_parallel_linear", x, self.weight, self.bias)
        tp = mp_group()
        if tp is not None:
            x = CopyToMP.apply(x, tp)
        y = torch.matmul(x, w)
        if b is not None:
            y = y + b
        if tp is not None and self.gather_output:
            y = GatherFromMP.apply(y, y.dim() - 1, tp)
        return y


class RowParallelLinear(Layer):
    """Linear with input features sharded over 'mp' (reference :145); the
    partial products are summed over the ranks before the bias, as the
    reference's c_allreduce_sum."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=False, name=None, mp_group=None, *, device=None,
                 generator=None):
        super().__init__()
        self.input_is_parallel = input_is_parallel
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter([in_features, out_features], attr=weight_attr,
                                            default_initializer=I.XavierNormal(), **kw)
        self.weight.is_distributed = True
        self.weight.mp_spec = ("mp", None)
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True, **kw)

    def forward(self, x):
        x, w, b = cast_inputs("row_parallel_linear", x, self.weight, self.bias)
        tp = mp_group()
        if tp is None:
            y = torch.matmul(x, w)
        else:
            if not self.input_is_parallel:
                x = ScatterToMP.apply(x, x.dim() - 1, tp)
            y = ReduceFromMP.apply(torch.matmul(x, w), tp)
        if b is not None:
            y = y + b
        return y


class ParallelCrossEntropy(Layer):
    def __init__(self, mp_group=None, name=None):
        super().__init__()

    def forward(self, input, label):
        return F.cross_entropy(input, label, reduction="none")


class RNGStatesTracker:
    """reference: parallel_layers/random.py:24 — distinct dropout streams
    for replicated and mp-sharded regions; a state is a named key."""

    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        self.states_[name] = random_core.PRNGKey(seed)

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng"):
        if name not in self.states_:
            self.add(name, hash(name) % (2 ** 31))
        key, sub = random_core.split(self.states_[name])
        self.states_[name] = key
        with random_core.rng_guard(sub):
            yield


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    global _RNG_STATE_TRACKER
    seed = seed or np.random.randint(0, 2 ** 31)
    _RNG_STATE_TRACKER = RNGStatesTracker()
    _RNG_STATE_TRACKER.add("global_seed", seed)
    _RNG_STATE_TRACKER.add("model_parallel_rng", seed + 1024)
