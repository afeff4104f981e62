"""Carry weights across from the JAX package.

``load_numpy_state(module, state)`` takes ``{name: np.ndarray}`` (the JAX
model's ``named_parameters()`` as numpy arrays; parameter names and
layouts are the same in both packages) and copies it into ``module``'s
parameters. It is a checked copy: a missing or unexpected name, a shape
or a dtype that differs raises, and nothing is copied.

Buffers travel too: a name in ``state`` that is one of ``module``'s
buffers (an ``Int8Linear``'s or ``Int8Conv2D``'s int8 ``qweight``, its
``w_scale`` and ``act_scale``; a QAT wrapper's ``act_scale``, its layer's
parameters under ``inner.*``; BatchNorm's running statistics) is copied
into it under the same checks. Arrays keep their dtypes: int8, float32 and
bfloat16 (ml_dtypes' numpy bfloat16, which torch cannot read directly,
travels as its raw 16-bit words). The values may be numpy arrays or
anything numpy can read (the JAX package's Tensors and arrays, as its
``state_dict()`` gives them).

A tied parameter (one Parameter reachable under several names, as
``BertForPretraining``'s decoder weight is the word embedding) is listed
once by ``named_parameters()``, under its first name, in both packages,
and is copied once. ``state`` may also hold it under its other names (a
``state_dict()`` does); each such entry must equal the array under the
first name, since a tie cannot hold two values.
"""
import numpy as np
import torch

_LAYOUTS = ("zero", "fsdp", "rows", "mp", "ep", "pp")


def _aliases(module):
    """{other name: first name} for every tied parameter of ``module``."""
    first = {}
    out = {}
    for name, p in module.named_parameters(remove_duplicate=False):
        if id(p) in first:
            out[name] = first[id(p)]
        else:
            first[id(p)] = name
    return out


def _numpy_dtype_name(dt):
    """numpy's name of the torch dtype ``dt`` ("bfloat16" for bf16, which
    torch cannot hand to numpy)."""
    if dt == torch.bfloat16:
        return "bfloat16"
    return torch.empty((), dtype=dt).numpy().dtype.name


def _to_tensor(arr):
    """A writable torch copy of ``arr``; a bfloat16 array through its raw
    16-bit words."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _check(name, arr, p):
    if tuple(arr.shape) != tuple(p.shape):
        raise ValueError(f"{name}: shape {tuple(arr.shape)} does not match "
                         f"the parameter's {tuple(p.shape)}")
    want = _numpy_dtype_name(p.dtype)
    if np.dtype(arr.dtype).name != want:
        raise TypeError(f"{name}: dtype {arr.dtype} does not match the "
                        f"parameter's {want}")


def _arrays(state):
    return {k: np.asarray(getattr(v, "_value", v)) for k, v in state.items()}


def load_numpy_state(module, state):
    state = _arrays(state)
    params = dict(module.named_parameters())
    buffers = {n: b for n, b in module.named_buffers() if n in state}
    aliases = _aliases(module)
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params) - set(buffers) - set(aliases))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for alias, name in aliases.items():
        if alias in state and not np.array_equal(state[alias], state[name]):
            raise ValueError(f"{alias} is tied to {name} but the state gives it "
                             "another value")
    targets = {**params, **buffers}
    for name, p in targets.items():
        _check(name, state[name], p)
    with torch.no_grad():
        for name, p in targets.items():
            p.copy_(_to_tensor(state[name]))
    return module


def load_state_dict(layer, state):
    """Load a JAX ``Layer.state_dict()`` (numpy arrays) by structured name
    (see the module docstring)."""
    state = _arrays(state)
    own = layer.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state_dict names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, t in own.items():
        _check(name, state[name], t)
    layer.set_state_dict(state)
    return layer


def program_state_by_position(program, state):
    """Weights for ``program`` by position, checked: ``state`` is a
    sequence of arrays in another program's ``all_parameters()`` order
    (recording order, the same in both packages for one model), or a
    ``{name: ndarray}`` of a ``static.save`` in that order. Returns
    ``[(parameter, array)]``; ``set_by_position`` writes them. The counts
    and every shape must agree. A name-keyed state is not enough for a
    model whose layers are deep copies (``TransformerEncoder``'s): the
    copies share their parameters' names, so ``static.save`` (the
    reference's format) keeps one array per name."""
    arrays = list(state.values()) if isinstance(state, dict) else list(state)
    mine = program.all_parameters()
    if len(mine) != len(arrays):
        raise ValueError(f"program has {len(mine)} parameters, the state {len(arrays)}")
    out = []
    for i, (p, arr) in enumerate(zip(mine, arrays)):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"parameter {i}: {arr.shape} does not fit {tuple(p.shape)}")
        out.append((p, arr))
    return out


def set_by_position(program, state):
    """Copy ``program_state_by_position(program, state)`` into the
    program's parameters."""
    for p, arr in program_state_by_position(program, state):
        p.set_value(arr)


def _layout_dim(name, shape, world, layout, dims):
    """The dimension ``layout`` splits an array of ``shape`` on, or None."""
    from .distributed.spmd import zero_dim

    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {_LAYOUTS}, got {layout!r}")
    if layout == "fsdp":
        return zero_dim(shape, world, start=1) if name.startswith("trunk.") else None
    if layout in ("mp", "ep"):
        d = (dims or {}).get(name)
        return d if d is not None and d < len(shape) else None
    if layout == "pp":
        return 0 if name.startswith("stages.") and len(shape) else None
    return zero_dim(shape, world, start=2 if name.startswith("stages.") else 0)


def _walk(fn, tree, *others, name=""):
    """``fn(name, leaf, *other leaves)`` over a nested dict/tuple/list,
    ``name`` the nearest dictionary key."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, *(o[k] for o in others), name=k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(fn, v, *(o[i] for o in others), name=name)
                          for i, v in enumerate(tree))
    return fn(name, tree, *others)


def to_rank_state(state, rank, world, layout="zero", dims=None):
    """Rank ``rank``'s part (of ``world`` ranks) of a global state of the
    JAX package (parameters or optimizer state, keyed by parameter name),
    as numpy arrays, in the layout a rank of the port holds:

    - "zero": ZeRO's block over the data ranks, on the first dimension
      ``world`` divides (from 2 for a pipeline's ``stages.*``), else whole;
    - "fsdp": ``build_fsdp_train_step``'s ``trunk.*`` on the first
      per-layer dimension ``world`` divides;
    - "rows": row ``rank`` (a per-rank stack such as LocalSGD's);
    - "mp": the block on the dimension ``dims[name]`` (a step's
      ``mp_dims``: the ``mp_spec`` dimension), else whole;
    - "ep": the same over the ep ranks (``dims``: a step's ``ep_dims``;
      an ``incubate.moe.MoELayer``'s experts on dimension 0, or 2 behind
      a pipeline's [stage, layer] dims);
    - "pp": stage ``rank``'s ``[1, lps, ...]`` of a ``stages.*`` array
      ``[S, lps, ...]``, else whole.

    ``layout`` may be a tuple of them, applied in order, with ``rank`` and
    ``world`` tuples alike: ``("pp", "mp", "zero")`` cuts the stage, then
    its mp block, then ZeRO's block of that."""
    if isinstance(layout, tuple):
        for r, w, lay in zip(rank, world, layout):
            state = to_rank_state(state, r, w, lay, dims)
        return state

    def one(name, a):
        a = np.asarray(getattr(a, "_value", a))
        if layout == "rows":
            return a[rank]
        d = _layout_dim(name, a.shape, world, layout, dims)
        if d is None:
            return a
        k = a.shape[d] // world
        return np.take(a, np.arange(rank * k, (rank + 1) * k), axis=d)
    return _walk(one, state)


def from_rank_states(states, like, layout="zero", dims=None):
    """The global state from every rank's part (``states``, in rank
    order), the inverse of ``to_rank_state``; ``like`` gives the
    structure and the global shapes. For a tuple ``layout``, ``states``
    nests in the same order (``states[i][j]``: rank i of the first layout,
    rank j of the second)."""
    world = len(states)
    if isinstance(layout, tuple):
        if len(layout) == 1:
            return from_rank_states(states, like, layout[0], dims)
        inner = to_rank_state(like, 0, world, layout[0], dims)
        return from_rank_states([from_rank_states(s, inner, layout[1:], dims) for s in states],
                                like, layout[0], dims)

    def one(name, ref, *parts):
        parts = [np.asarray(p) for p in parts]
        if layout == "rows":
            return np.stack(parts)
        d = _layout_dim(name, np.shape(getattr(ref, "_value", ref)), world, layout, dims)
        return parts[0] if d is None else np.concatenate(parts, axis=d)
    return _walk(one, like, *states)
