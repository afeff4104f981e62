"""The static-graph compat surface (counterpart of
paddle_tpu/static/compat.py; reference: python/paddle/static/__init__.py
exports backed by fluid/compiler.py CompiledProgram,
framework/parallel_executor.cc, fluid/io.py save/load,
fluid/layers/nn.py py_func / Print).

``BuildStrategy``/``ExecutionStrategy`` tuned the reference's SSA-graph
executors; the port's Executor replays eagerly on one card, so they are
validated carriers of the settings, and ``CompiledProgram``/
``ParallelExecutor`` are thin aliases over the Executor. ``save``/``load``
write and read the reference's ``.pdparams`` npz (name -> array, the names
of ``program._named_params``), so a file passes between the packages.
The serialization family packs the ``save_inference_model`` artifacts
(a torch.export program, its npz and JSON) into one tagged container.
"""
import os

import numpy as np
import torch

from ..core.tensor import Parameter, Tensor, boundary, plain, wrap
from .program import _named_params, as_one_call, recording_program

__all__ = [
    "BuildStrategy", "ExecutionStrategy", "CompiledProgram",
    "ParallelExecutor", "Print", "Variable", "create_global_var",
    "save", "load", "load_program_state", "set_program_state", "py_func",
]

# a static-graph "Variable" is a recorded Tensor in this design
Variable = Tensor


class BuildStrategy:
    """reference: framework/details/build_strategy.h. Every knob is a
    plain attribute; setting a semantic knob (reduce_strategy,
    gradient_scale_strategy) away from its default warns, since the
    port's one-card replay has no reduction to schedule."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    _SEMANTIC_DEFAULTS = {
        "reduce_strategy": 0,
        "gradient_scale_strategy": 0,
    }

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""
        self.enable_sequential_execution = False
        self.fuse_broadcast_ops = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_all_optimizer_ops = False
        self.fuse_all_reduce_ops = False
        self.memory_optimize = None
        self.enable_inplace = True
        self.build_cuda_graph = False
        self.num_trainers = 1
        self.trainer_id = 0

    def __setattr__(self, name, value):
        default = self._SEMANTIC_DEFAULTS.get(name)
        if default is not None and value != default:
            import warnings

            warnings.warn(
                f"BuildStrategy.{name}={value!r} is a no-op here: the Executor replays "
                "the program on one card; gradient scaling follows the optimizer",
                stacklevel=2)
        object.__setattr__(self, name, value)


class ExecutionStrategy:
    """reference: framework/details/execution_strategy.h."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False


class CompiledProgram:
    """reference: fluid/compiler.py CompiledProgram. Executor.run accepts
    it as it accepts the program; ``with_data_parallel`` records the
    intent."""

    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = None
        self._loss_name = None
        self._is_data_parallel = False

    def with_data_parallel(self, loss_name=None, build_strategy=None, exec_strategy=None,
                           share_vars_from=None, places=None):
        self._loss_name = loss_name
        self._build_strategy = build_strategy or self._build_strategy
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._is_data_parallel = True
        return self


class ParallelExecutor:
    """reference: framework/parallel_executor.cc (legacy API), over one
    Executor on one card."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None, build_strategy=None,
                 num_trainers=1, trainer_id=0, scope=None):
        from .program import Executor, default_main_program

        self._program = main_program or default_main_program()
        self._loss_name = loss_name
        self._executor = Executor()

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        program = self._program
        resolved = [program.var(n) if isinstance(n, str) else n for n in (fetch_list or [])]
        return self._executor.run(program, feed=feed, fetch_list=resolved,
                                  return_numpy=return_numpy)


@torch.library.custom_op("paddle_tpu_torch::print_op", mutates_args=())
def _print_op(x: torch.Tensor, message: str) -> torch.Tensor:
    """The reference's Print op: prints ``message`` and the value when it
    runs (a replay prints again), and passes the value on."""
    print(message, Tensor.numpy(wrap(x.detach())))
    return x.clone()


@_print_op.register_fake
def _(x, message):
    return torch.empty_like(x)


_print_op.register_autograd(lambda ctx, g: (g, None), setup_context=lambda ctx, i, o: None)


def Print(input, first_n=-1, message=None, summarize=20, print_tensor_name=True,
          print_tensor_type=True, print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """reference: fluid/layers/control_flow.py Print — a runtime print
    that a recorded program keeps (a custom op)."""
    out = _print_op(plain(input), str(message or "Print"))
    return wrap(out) if type(input) is Tensor else out


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    """reference: fluid/layers/tensor.py create_global_var — a persistable
    filled variable in the global scope."""
    from ..core import place as place_mod
    from ..core.dtype import convert_dtype
    from .program import global_scope

    t = torch.full(list(shape), value, dtype=convert_dtype(
        "float32" if dtype == "bfloat16" else dtype), device=place_mod.current_device())
    var = Parameter(t, requires_grad=t.is_floating_point(), name=name)
    global_scope().vars[var.name or f"global_var_{id(var)}"] = var
    return var


def _param_state(program):
    return {name: Tensor.numpy(p) for name, p in _named_params(program).items()}


def save(program, model_path, protocol=4, **configs):
    """reference: fluid/io.py static save — the parameters to
    ``model_path + '.pdparams'``, the reference's npz."""
    state = _param_state(program)
    path = model_path + ".pdparams"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **state)
    os.replace(path + ".npz", path)  # numpy appends .npz
    return path


def load(program, model_path, executor=None, var_list=None):
    """reference: fluid/io.py static load."""
    set_program_state(program, load_program_state(model_path, var_list=var_list))


def load_program_state(model_path, var_list=None):
    """reference: fluid/io.py load_program_state — dict name -> ndarray."""
    path = model_path if model_path.endswith(".pdparams") else model_path + ".pdparams"
    with np.load(path) as data:
        state = {k: data[k] for k in data.files}
    if var_list is not None:
        keep = {getattr(v, "name", v) for v in var_list}
        state = {k: v for k, v in state.items() if k in keep}
    return state


def set_program_state(program, state_dict):
    """reference: fluid/io.py set_program_state (values copied into the
    live parameters)."""
    by_name = _named_params(program)
    missing = [name for name in state_dict if name not in by_name]
    if missing:
        raise ValueError(f"state entries not found in program: {missing}")
    for name, arr in state_dict.items():
        by_name[name].set_value(np.asarray(arr))


class _HostFunction(torch.autograd.Function):
    """py_func's host call with the reference's backward contract."""

    @staticmethod
    def forward(ctx, fwd, bwd, keep_x, keep_o, n_in, *xs):
        outs = fwd(*xs)
        ctx.fwd_cfg = (bwd, keep_x, keep_o, n_in)
        ctx.save_for_backward(*xs, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        bwd, keep_x, keep_o, n_in = ctx.fwd_cfg
        saved = ctx.saved_tensors
        xs, outs = saved[:n_in], saved[n_in:]
        grads = bwd(*([xs[i] for i in keep_x] + [outs[i] for i in keep_o] + list(gs)))
        return (None, None, None, None, None) + tuple(grads)


def _host_call(func, like):
    """``func`` on Tensors, run on host values -> torch tensors shaped as
    ``like`` (None for a missing gradient: zeros)."""

    def run(*vals):
        res = func(*[wrap(v.detach().cpu()) for v in vals])
        rs = res if isinstance(res, (list, tuple)) else [res]
        out = []
        for t, r in zip(like, rs):
            if r is None:
                out.append(torch.zeros(t.shape, dtype=t.dtype, device=t.device))
                continue
            a = r if isinstance(r, torch.Tensor) else torch.as_tensor(np.asarray(r))
            out.append(plain(a).detach().to(device=t.device, dtype=t.dtype))
        return out

    return run


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """reference: fluid/layers/nn.py py_func — arbitrary Python in the
    graph, one recorded call. ``out`` gives the result templates and gets
    their values; the returned tensors carry the gradient (a torch tensor
    cannot take another's place on the graph). ``backward_func`` is called
    with (forward inputs..., forward outputs..., output grads...) minus
    ``skip_vars_in_backward_input`` and returns one gradient per input
    (None for none)."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    skip = {id(v) for v in (skip_vars_in_backward_input or [])}
    keep_x = tuple(i for i, v in enumerate(xs) if id(v) not in skip)
    keep_o = tuple(i for i, v in enumerate(outs) if id(v) not in skip)
    px = [plain(v) for v in xs]
    fwd = _host_call(func, [plain(o) for o in outs])
    bwd = None if backward_func is None else _host_call(backward_func, px)

    @as_one_call
    def _py_func(*arrays):
        if bwd is None:
            with torch.no_grad():
                return tuple(fwd(*arrays))
        return _HostFunction.apply(fwd, bwd, keep_x, keep_o, len(arrays), *arrays)

    results = [wrap(r) for r in _py_func(*px)]
    prog = recording_program()
    for o, r in zip(outs, results):
        with torch.no_grad():
            plain(o).copy_(plain(r).detach())
        if prog is not None:
            prog._alias(r, o)
    if isinstance(out, (list, tuple)):
        return type(out)(results)
    return results[0]


# ------------------------------------------------ serialization family
# (reference: static/io.py serialize_program/serialize_persistables/
# deserialize_*/save_to_file/load_from_file). A blob is a length-prefixed
# tagged container of the save_inference_model files: the magic, then per
# file a JSON {"ext", "size"} header line and its bytes. The weights are
# an npz read with allow_pickle=False.
_SER_MAGIC = b"PDTPU1\n"


def _pack(blob):
    import json as _json

    out = [_SER_MAGIC]
    for ext, data in blob.items():
        out.append(_json.dumps({"ext": ext, "size": len(data)}).encode() + b"\n")
        out.append(data)
    return b"".join(out)


def _unpack(data):
    import json as _json

    if not data.startswith(_SER_MAGIC):
        raise ValueError("not a paddle_tpu serialized artifact")
    pos = len(_SER_MAGIC)
    blob = {}
    while pos < len(data):
        nl = data.index(b"\n", pos)
        head = _json.loads(data[pos:nl].decode())
        pos = nl + 1
        blob[head["ext"]] = data[pos:pos + head["size"]]
        pos += head["size"]
    return blob


def _export_artifacts(feed_vars, fetch_vars, program):
    """Every artifact of a save_inference_model, read into memory (not
    cached: the weights change with training)."""
    import shutil
    import tempfile

    from .program import default_main_program, save_inference_model

    program = program or default_main_program()
    d = tempfile.mkdtemp(prefix="pdtpu_ser_")
    try:
        prefix = os.path.join(d, "model")
        save_inference_model(prefix, list(feed_vars), list(fetch_vars), None, program=program)
        blob = {}
        for ext in (".pdmodel", ".pdmeta.json", ".pdiparams"):
            if os.path.exists(prefix + ext):
                with open(prefix + ext, "rb") as f:
                    blob[ext] = f.read()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return blob


def serialize_program(feed_vars, fetch_vars, program=None, **kwargs):
    """The program's bytes (the exported program and its JSON, no
    weights)."""
    blob = _export_artifacts(feed_vars, fetch_vars, program)
    return _pack({k: v for k, v in blob.items() if k != ".pdiparams"})


def serialize_persistables(feed_vars, fetch_vars, executor=None, program=None, **kwargs):
    """The weights' bytes matching serialize_program's program."""
    blob = _export_artifacts(feed_vars, fetch_vars, program)
    return _pack({".pdiparams": blob[".pdiparams"]})


class _DeserializedProgram:
    """A handle over deserialized artifacts; the weights attach through
    deserialize_persistables, which returns the loaded layer."""

    def __init__(self, blob):
        import shutil
        import tempfile
        import weakref

        self._dir = tempfile.mkdtemp(prefix="pdtpu_deser_")
        self._prefix = os.path.join(self._dir, "model")
        weakref.finalize(self, shutil.rmtree, self._dir, ignore_errors=True)
        self._write(blob)
        self.layer = None

    def _write(self, blob):
        for ext, data in blob.items():
            with open(self._prefix + ext, "wb") as f:
                f.write(data)

    def _load(self):
        from ..jit import load as jit_load

        self.layer = jit_load(self._prefix)
        return self.layer

    def __call__(self, *inputs):
        if self.layer is None:
            raise RuntimeError("deserialize_persistables must attach parameters before "
                               "running the program")
        return self.layer(*inputs)


def deserialize_program(data):
    return _DeserializedProgram(_unpack(bytes(data)))


def deserialize_persistables(program, data, executor=None):
    if not isinstance(program, _DeserializedProgram):
        raise TypeError("program must come from deserialize_program")
    program._write(_unpack(bytes(data)))
    return program._load()


def save_to_file(path, content):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """reference: fluid/layers/tensor.py create_parameter."""
    from ..tensor.creation import create_parameter as _create

    init = default_initializer
    if attr is not None:
        name = name or getattr(attr, "name", None)
        init = getattr(attr, "initializer", None) or init
    return _create(shape, dtype, name=name, is_bias=is_bias, default_initializer=init)


@boundary
def accuracy(input, label, k=1, correct=None, total=None):
    """Batch top-k accuracy (reference: fluid/layers/metric_op.py
    accuracy)."""
    topk = torch.argsort(-input, dim=-1, stable=True)[..., :int(k)]
    hit = (topk == label.reshape(-1, 1)).any(dim=-1)
    return hit.float().mean()


@boundary
def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    """The exact batch AUC by the tie-corrected rank statistic (reference:
    fluid/layers/metric_op.py auc; the reference package's form)."""
    p = input[:, 1] if input.dim() == 2 and input.shape[1] == 2 else input.reshape(-1)
    y = label.reshape(-1).float()
    sorted_p = torch.sort(p).values
    lo = torch.searchsorted(sorted_p, p, right=False)
    hi = torch.searchsorted(sorted_p, p, right=True)
    ranks = (lo + hi + 1).float() / 2.0
    n_pos = y.sum()
    n_neg = y.shape[0] - n_pos
    denom = torch.clamp(n_pos * n_neg, min=1.0)
    return (torch.sum(ranks * y) - n_pos * (n_pos + 1) / 2.0) / denom


def xpu_places(device_ids=None):
    raise RuntimeError("xpu_places: not compiled with XPU (this is the PyTorch/CUDA build; "
                       "use paddle.static.cuda_places)")


def save_vars(executor=None, dirname=None, main_program=None, vars=None, predicate=None,
              filename=None):
    """reference: fluid/io.py save_vars — a (filtered) subset of a
    program's parameters under ``dirname``."""
    from .program import default_main_program

    program = main_program or default_main_program()
    named = _named_params(program)
    if vars is not None:
        keep = {getattr(v, "name", v) for v in vars}
        named = {n: p for n, p in named.items() if n in keep}
    elif predicate is not None:
        named = {n: p for n, p in named.items() if predicate(p)}
    os.makedirs(dirname, exist_ok=True)
    target = os.path.join(dirname, filename or "vars.npz")
    np.savez(target, **{n: Tensor.numpy(p) for n, p in named.items()})
    if os.path.splitext(target)[1] != ".npz":  # numpy always appends .npz
        os.replace(target + ".npz", target)
    return target


def load_vars(executor=None, dirname=None, main_program=None, vars=None, predicate=None,
              filename=None):
    """reference: fluid/io.py load_vars."""
    from .program import default_main_program

    program = main_program or default_main_program()
    target = os.path.join(dirname, filename or "vars.npz")
    with np.load(target) as data:
        state = {k: data[k] for k in data.files}
    named = _named_params(program)
    if vars is not None:
        keep = {getattr(v, "name", v) for v in vars}
        state = {k: v for k, v in state.items() if k in keep}
    for n, arr in state.items():
        p = named.get(n)
        if p is None or (predicate is not None and not predicate(p)):
            continue
        p.set_value(arr)
