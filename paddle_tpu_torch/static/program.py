"""Program / Executor (counterpart of paddle_tpu/static/program.py;
reference: fluid/framework.py Program:4301, executor.py Executor:916,
backward.py append_backward).

A Program records the torch calls that user graph-building code makes
inside ``program_guard``, while it runs once on placeholder tensors
(``data``: zeros, a None or -1 dim as 1, as in the reference). The
recorder is a ``torch.overrides.TorchFunctionMode``: the reference
records at its op funnel, but the port's layers call torch directly, so
the mode sees every top-level torch call, a Tensor method, an operator
or a custom op (K1 is recorded as ``paddle_tpu_torch::
flash_attention_fwd`` and replays as one launch). Nested calls are not
recorded: the mode is off while its handler runs. A call is recorded
when one of its tensors is a placeholder or a recorded value, or, with
grad mode on, a ``torch.nn.Parameter``; everything else it reads is a
constant of the program (a dropout mask made from a key, a BatchNorm
buffer, a shape). Build-time calls run under ``no_grad`` and their
values are not kept: an output is known by its ``id`` only while it is
alive (a weak map), and the replay, which runs the calls in recording
order, gives each id the value it had at that point.
``Tensor.as_subclass`` and ``auto_cast``'s casts are recorded as
aliases: the reference records an op's inputs before its auto_cast hook
casts them, so a program replays in the dtypes it was given.

A program's parameters are the Parameters its recorded calls read, in
recording order (``all_parameters``; ``static.save`` names them
``param_{i}`` where a Parameter has no name). ``Executor.run`` replays the
calls that its fetches (and, in training, the loss) need, eagerly: the
feeds and the live parameters go in, the fetched values come out. Under
static mode ``Optimizer.minimize`` attaches ``(optimizer, loss)`` to the
recording program, and a run of that program is one training step:
``torch.autograd.grad`` of ``loss.sum()`` with the trainable parameters
as leaves, the grad clip, the L1 term and ``type(opt)._update`` per
parameter, the new values written into the live parameters in place
(``build_train_step``'s order, distributed/spmd.py). The optimizer state
stays on the program; ``opt.get_lr()`` is read every run. The reference
updates in ``id()`` order, so its global-norm sum has an arbitrary order;
the port's is the recording order.
"""
import contextlib
import functools
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from ..amp.auto_cast import _CASTING
from ..core import place as place_mod
from ..core.dtype import canonicalize_dtype, convert_dtype
from ..core import tensor as tensor_mod
from ..core.tensor import Tensor, wrap

_base = torch.Tensor
_CAST_FNS = {_base.to, _base.type, _base.float, _base.bfloat16, _base.half}
# calls on a tensor's metadata or raw storage, never recorded: a
# Parameter's ``.data`` (as its deepcopy reads it when a layer is cloned)
# is a constant, and ``requires_grad_`` sets a flag
_METADATA_FNS = {_base.requires_grad_, _base.retain_grad, _base.register_hook}
_METADATA_GETTERS = (_base.data, _base.grad)


def _is_metadata(func):
    return func in _METADATA_FNS or getattr(func, "__self__", None) in _METADATA_GETTERS


def _is_inplace(func, args, out):
    name = getattr(func, "__name__", "")
    if name.endswith("_") and not name.endswith("__"):
        return True
    if name.startswith("__i") or name == "__setitem__":
        return True
    return any(o is a for o in pytree.tree_leaves(out) if isinstance(o, _base)
               for a in args if isinstance(a, _base))


class _OpRecord:
    """One recorded call: ``fn`` (None for an alias), the flat leaves of
    its (args, kwargs) with the recorded tensors' slots, the tree spec,
    the output slots and whether it mutates one of its inputs."""

    __slots__ = ("fn", "leaves", "spec", "slots", "outs", "inplace")

    def __init__(self, fn, leaves, spec, slots, outs, inplace):
        self.fn = fn
        self.leaves = leaves
        self.spec = spec
        self.slots = slots  # [(leaf position, kind, id)]
        self.outs = outs  # [(output leaf position, id)]
        self.inplace = inplace


class _Recorder(TorchFunctionMode):
    """The recording mode of one Program (see the module docstring)."""

    def __init__(self, program):
        super().__init__()
        self.program = program
        self.depth = 0  # > 0 while a recorded call runs

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        prog = self.program
        grad_on = torch.is_grad_enabled()
        leaves, spec = pytree.tree_flatten((args, kwargs))
        if not any(isinstance(a, _base) for a in leaves):
            # a factory, or a call on the grad mode itself (no_grad's
            # _set_grad_enabled reaches the mode): run as it is
            return func(*args, **kwargs)
        slots, params, hit = [], [], False
        for i, a in enumerate(leaves):
            if not isinstance(a, _base):
                continue
            kind = prog._kind(a)
            if kind is None:
                continue
            slots.append((i, kind, id(a)))
            if kind == "p":
                params.append(a)
                hit = hit or grad_on
            else:
                hit = True
        self.depth += 1
        try:
            with torch.no_grad():
                out = func(*args, **kwargs)
        finally:
            self.depth -= 1
        if not hit or _is_metadata(func):
            return out
        if _CASTING[0] and func in _CAST_FNS:
            prog._alias(args[0], out)
            return out
        outs = [(j, o) for j, o in enumerate(pytree.tree_leaves(out)) if isinstance(o, _base)]
        inplace = _is_inplace(func, args, out)
        if not outs and not inplace:
            return out  # a shape, a Python number: a build-time constant
        if inplace and not grad_on and args and isinstance(args[0], torch.nn.Parameter):
            return out  # a state update (set_value), which the reference does not record
        for p in params:
            prog._add_param(p)
        for i, _, _ in slots:
            leaves[i] = None
        prog._record(_OpRecord(func, leaves, spec, slots, [(j, id(o)) for j, o in outs],
                               inplace), [o for _, o in outs])
        return out


class Program:
    def __init__(self):
        self.ops = []
        self.placeholders = {}  # name -> Tensor
        self.params = {}  # id -> Parameter, in recording order
        self.train_attach = None  # (optimizer, loss tensor)
        self.random_seed = 0
        self._is_start_up = False
        # id -> live recorded tensor. An id names a value only while its
        # tensor lives; a placeholder ("f") or a Parameter ("p") is read
        # from the run's inputs, a recorded value ("v") from the replay, so
        # a later tensor that takes a dead value's id is told apart
        self._vars = weakref.WeakValueDictionary()
        self._opt_state = None
        self._recorder = None

    # ------------------------------------------------------------ recording
    def _kind(self, t):
        """'f' placeholder, 'v' recorded value, 'p' Parameter, None for a
        constant."""
        if self.placeholders.get(getattr(t, "name", None)) is t:
            return "f"
        if self._vars.get(id(t)) is t:
            return "v"
        if isinstance(t, torch.nn.Parameter):
            return "p"
        return None

    def _add_param(self, p):
        self.params.setdefault(id(p), p)

    def _track(self, t):
        self._vars[id(t)] = t

    def _record(self, op, outs):
        self.ops.append(op)
        for o in outs:
            self._track(o)

    def _alias(self, src, out):
        if not isinstance(out, _base) or out is src or (self._recorder and self._recorder.depth):
            return
        kind = self._kind(src)
        if kind is None:
            return  # a constant's alias is a constant
        if kind == "p":
            self._add_param(src)
        self.ops.append(_OpRecord(None, None, None, [(0, kind, id(src))], [(0, id(out))], False))
        self._track(out)

    # ------------------------------------------------------------ program API
    def global_block(self):
        return self

    def all_parameters(self):
        return list(self.params.values())

    def list_vars(self):
        return list(self.placeholders.values())

    def clone(self, for_test=False):
        """for_test=True strips the optimizer attachment (reference:
        framework.py Program.clone), so Executor.run on the clone is
        inference-only. The calls, parameters and placeholders are
        shared with the original."""
        if not for_test:
            return self
        import copy

        test = copy.copy(self)
        test.train_attach = None
        test._opt_state = None
        return test

    def var(self, name):
        if name in self.placeholders:
            return self.placeholders[name]
        for t in list(self._vars.values()):
            if getattr(t, "name", None) == name:
                return t
        raise KeyError(
            f"no variable named {name!r} in program (placeholders: "
            f"{sorted(self.placeholders)}; recorded tensors are fetchable "
            f"by object, or by name when Tensor.name is set)")

    # ------------------------------------------------------------ replay
    def _live_ops(self, targets):
        """The calls the values ``targets`` ((kind, id) pairs) need, in
        order (every call that mutates an input is kept)."""
        needed = {vid for kind, vid in targets if kind == "v"}
        live = []
        for op in reversed(self.ops):
            out_ids = [oid for _, oid in op.outs]
            if op.inplace or any(o in needed for o in out_ids):
                if not op.inplace:
                    needed.difference_update(out_ids)
                needed.update(vid for _, kind, vid in op.slots if kind == "v")
                live.append(op)
        live.reverse()
        return live

    def _input(self, kind, vid, given):
        """A placeholder's or a Parameter's value in a run: ``given``'s
        (the feeds, the training leaves), else the placeholder's zeros or
        the live Parameter."""
        t = given.get(vid)
        if t is not None:
            return t
        if kind == "p":
            return self.params[vid]
        for ph in self.placeholders.values():
            if id(ph) == vid:
                return ph.as_subclass(_base)
        raise KeyError(f"program value {vid} is not defined")

    def _value(self, ref, env, given):
        kind, vid = ref
        return env[vid] if kind == "v" else self._input(kind, vid, given)

    def _run(self, ops, given):
        """Run ``ops`` with ``given`` (id -> tensor: feeds and parameter
        values) -> the recorded values (id -> tensor)."""
        env = {}
        for op in ops:
            if op.fn is None:
                _, kind, src = op.slots[0]
                env[op.outs[0][1]] = self._value((kind, src), env, given)
                continue
            leaves = list(op.leaves)
            for i, kind, vid in op.slots:
                leaves[i] = env[vid] if kind == "v" else self._input(kind, vid, given)
            args, kwargs = pytree.tree_unflatten(leaves, op.spec)
            out = op.fn(*args, **kwargs)
            if op.outs:
                flat = pytree.tree_leaves(out)
                for j, oid in op.outs:
                    env[oid] = flat[j]
        return env


def _resolve(program, f):
    """A fetch (a tensor or its name) -> (kind, id)."""
    if isinstance(f, str):
        f = program.var(f)
    if not isinstance(f, _base):
        raise TypeError(f"fetch_list entries are tensors or names, got {f!r}")
    kind = program._kind(f)
    if kind is None:
        raise ValueError("fetch_list holds a tensor that the program did not record")
    return kind, id(f)


def _feed_tensor(value, ph):
    if isinstance(value, _base):
        t = value.detach()
    else:
        t = torch.as_tensor(np.asarray(value))
    t = t.as_subclass(_base) if type(t) is not _base else t
    return t.to(device=ph.device, dtype=ph.dtype)


class Executor:
    """reference: executor.py:916. Runs a program's replay (module
    docstring); the calls each (program, feeds, fetches, feed shapes and
    dtypes, train or not, op count) needs are pruned once and cached."""

    def __init__(self, place=None):
        self.place = place
        self._cache = {}

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        program = program or default_main_program()
        if hasattr(program, "_program"):  # CompiledProgram wrapper
            program = program._program
        feed = feed or {}
        fetch_list = fetch_list or []
        if program._is_start_up or not program.ops:
            return []
        feed_names = sorted(n for n in feed if n in program.placeholders)
        feeds = [_feed_tensor(feed[n], program.placeholders[n]) for n in feed_names]
        fetch_ids = tuple(_resolve(program, f) for f in fetch_list)
        train = program.train_attach is not None
        spec = tuple((tuple(t.shape), str(t.dtype)) for t in feeds)
        key = (id(program), tuple(feed_names), fetch_ids, spec, train, len(program.ops))
        ops = self._cache.get(key) if use_program_cache else None
        if ops is None:
            targets = fetch_ids + ((_resolve(program, program.train_attach[1]),)
                                   if train else ())
            ops = program._live_ops(targets)
            self._cache[key] = ops
        given = {id(program.placeholders[n]): t for n, t in zip(feed_names, feeds)}
        if train:
            env = _train_step(program, ops, given)
        else:
            with torch.no_grad():
                env = program._run(ops, given)
        fetches = [program._value(f, env, given).detach() for f in fetch_ids]
        if return_numpy:
            return [Tensor.numpy(wrap(f)) for f in fetches]
        return [wrap(f) for f in fetches]

    def train_from_dataset(self, program=None, dataset=None, scope=None, thread=1,
                           debug=False, fetch_list=None, fetch_info=None, print_period=100):
        raise NotImplementedError(
            "Executor.train_from_dataset needs distributed/fleet/trainer.py MultiTrainer "
            "and the fleet datasets, not ported yet (ROADMAP Queue 1 item 5)")

    def close(self):
        pass


def _train_step(program, ops, given):
    """One step of the attached optimizer (module docstring) -> the
    recorded values."""
    opt, loss_t = program.train_attach
    params = program.all_parameters()
    trainable = [p for p in params if p.requires_grad]
    leaves = [p.detach().requires_grad_(True) for p in trainable]
    given.update((id(p), leaf) for p, leaf in zip(trainable, leaves))
    with torch.enable_grad():
        env = program._run(ops, given)
        loss = program._value(_resolve(program, loss_t), env, given)
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g for leaf, g in zip(leaves, grads)]
    if opt._grad_clip is not None:
        grads = opt._grad_clip.clip_arrays(grads)
    if program._opt_state is None:
        program._opt_state = [opt._init_state(p.detach()) for p in trainable]
    hypers = opt._hypers()
    l1 = type(opt)._take_l1(hypers)
    lr = float(opt.get_lr())
    lr_t = {}
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(trainable, grads)):
            if p.device not in lr_t:
                lr_t[p.device] = torch.full((), lr, dtype=torch.float32, device=p.device)
            new_p, program._opt_state[i] = type(opt)._update_one(
                p.detach(), g.to(p.dtype), lr_t[p.device], program._opt_state[i], hypers, l1)
            p.copy_(new_p)
    return env


_default_main = Program()
_default_startup = Program()
_default_startup._is_start_up = True
_RECORDING = []  # the programs being recorded, innermost last


def default_main_program():
    return _default_main


def default_startup_program():
    return _default_startup


def recording_program():
    """The program ``program_guard`` is recording, or None."""
    return _RECORDING[-1] if _RECORDING else None


def as_one_call(fn):
    """``fn`` (on torch tensors) recorded as one call by a recording
    program, its inner calls not: for a function that is one op of the
    reference's funnel and reads its inputs' shapes when it runs (a
    Viterbi decode, a host callback)."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        prog = recording_program()
        rec = getattr(prog, "_recorder", None)
        if rec is None or rec.depth:
            return fn(*args, **kwargs)
        with torch._C.DisableTorchFunction():
            return rec.__torch_function__(fn, (), args, kwargs)

    return run


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _default_main, _default_startup
    old_main, old_startup = _default_main, _default_startup
    _default_main = main_program
    if startup_program is not None:
        _default_startup = startup_program
    _RECORDING.append(main_program)
    prev_hook = tensor_mod.ALIAS_HOOK[0]
    tensor_mod.ALIAS_HOOK[0] = main_program._alias
    prev_rec = getattr(main_program, "_recorder", None)
    main_program._recorder = _Recorder(main_program)
    try:
        with main_program._recorder:
            yield
    finally:
        main_program._recorder = prev_rec
        tensor_mod.ALIAS_HOOK[0] = prev_hook
        _RECORDING.pop()
        _default_main = old_main
        _default_startup = old_startup


def data(name, shape, dtype="float32", lod_level=0):
    """paddle.static.data — a placeholder: zeros on the current place in
    the reference's dtype (int64 as int32), a None or -1 dim as 1
    (reference: static/input.py data)."""
    shape = [1 if (s is None or s == -1) else int(s) for s in shape]
    dt = canonicalize_dtype(convert_dtype("float32" if dtype == "bfloat16" else dtype))
    with torch.no_grad():
        dummy = torch.zeros(shape, dtype=dt, device=place_mod.current_device())
    dummy = torch.Tensor._make_subclass(Tensor, dummy, False)
    dummy.name = name
    prog = recording_program() or default_main_program()
    prog.placeholders[name] = dummy
    prog._track(dummy)
    return dummy


def append_backward(loss, parameter_list=None, no_grad_set=None, callbacks=None,
                    checkpoints=None):
    """Marks ``loss`` for the replay's gradient pass (reference:
    backward.py:1009)."""
    prog = recording_program() or default_main_program()
    prog._backward_loss = loss
    return []


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    from ..core import tape

    return tape.grad(targets, inputs, target_gradients, allow_unused=True)


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


class _Scope:
    def __init__(self):
        self.vars = {}

    def find_var(self, name):
        return self.vars.get(name)


_global_scope = _Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    yield


def cpu_places(device_count=None):
    return [place_mod.CPUPlace()]


def cuda_places(device_ids=None):
    ids = device_ids or range(1)
    return [place_mod.CUDAPlace(i) for i in ids]


def tpu_places(device_ids=None):
    """The reference's TPU places have no counterpart on this build."""
    raise RuntimeError("tpu_places: this is the PyTorch/CUDA build; use "
                       "paddle.static.cuda_places")


@contextlib.contextmanager
def device_guard(device=None):
    yield


def _named_params(program):
    """name -> Parameter: the Parameter's name where set, else
    ``param_{i}`` by recording position (reference: compat.py
    _named_params)."""
    out = {}
    for i, p in enumerate(program.all_parameters()):
        out[getattr(p, "name", None) or f"param_{i}"] = p
    return out


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor, program=None):
    """reference: static/io.py save_inference_model. The replay of the
    calls the fetches need, over (parameters, feeds), exported with
    ``torch.export`` in jit.save's format (jit/save_load.py), so
    ``load_inference_model``, ``jit.load`` and ``inference.Predictor``
    serve it; the kernels stay custom ops inside the program."""
    from ..jit.save_load import _json_spec, write_artifacts

    program = program or default_main_program()
    if not isinstance(feed_vars, (list, tuple)):
        feed_vars = [feed_vars]
    if not isinstance(fetch_vars, (list, tuple)):
        fetch_vars = [fetch_vars]
    feed_ids = [id(v) for v in feed_vars]
    fetch_ids = [_resolve(program, f) for f in fetch_vars]
    ops = program._live_ops(fetch_ids)
    params = program.all_parameters()
    names, used = [], set()
    for i, p in enumerate(params):
        # a duplicate name (the copies of a deep-copied layer) would
        # collapse in the saved weights: made unique, as the reference does
        name = base = getattr(p, "name", None) or f"param_{i}"
        k = 1
        while name in used:
            name = f"{base}__dup{k}"
            k += 1
        used.add(name)
        names.append(name)
    param_ids = [id(p) for p in params]

    class _Replay(torch.nn.Module):
        def forward(self, p_list, b_list, *feeds):
            given = dict(zip(param_ids, p_list))
            given.update(zip(feed_ids, feeds))
            env = program._run(ops, given)
            return tuple(program._value(f, env, given) for f in fetch_ids)

    example = ([p.detach() for p in params], [],
               *[v.detach().as_subclass(_base) for v in feed_vars])
    with torch.no_grad():
        exported = torch.export.export(_Replay(), example, strict=False)
    exported._example_inputs = None
    write_artifacts(path_prefix, exported, {n: p.detach() for n, p in zip(names, params)}, {},
                    [_json_spec(list(v.shape), v.dtype) for v in feed_vars], False)


def load_inference_model(path_prefix, executor):
    """[program (a callable TranslatedLayer), feed_target_names,
    fetch_targets] (reference: static/io.py load_inference_model)."""
    from ..jit import load as jit_load

    layer = jit_load(path_prefix)
    feed_names = [f"x{i}" for i in range(len(layer._input_specs))]
    return [layer, feed_names, []]


def normalize_program(program, feed_vars, fetch_vars):
    return program
