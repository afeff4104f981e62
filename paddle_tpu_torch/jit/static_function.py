"""StaticFunction — the to_static engine (counterpart of
paddle_tpu/jit/static_function.py; reference: dygraph_to_static/
program_translator.py StaticFunction:233, ConcreteProgram:582,
ProgramCache:689; partial_program.py PartialProgramLayer).

The reference traces the function into one XLA program per input spec.
The port captures it with ``torch.export`` (non-strict) into one program
per key (the reference's key: the arguments' specs, the keyword
arguments', ``training``; the port adds the active ``auto_cast``, which
the capture bakes in), the counterpart of its ``pure_fn``: the function,
after dy2static's AST rewrite, with the layer's parameters and buffers as
explicit inputs (the layer's own tensors swapped out for them by
``torch.func.functional_call``'s reparametrization), then the key table,
then the tensors among the arguments. Each call runs the captured program
on the live parameters, so ``loss.backward()`` flows through it, and
through the kernels' registered autograd (ops/flash_attention.py); a
buffer the program updates in place (BatchNorm's running statistics) is
the layer's own tensor, so the update lands on the layer.

Random ops take their keys from the key table, a runtime input: each call
takes one key from the global stream (as the reference's call does) and
feeds ``fold_in(key, i)`` for the program's i-th random op, the keys the
reference's ``rng_guard`` gives. A construct the capture cannot take
raises, explained by ``dy2static.explain_trace_failure`` where the source
shows a likely cause; nothing runs eagerly unasked.

Under capture the tensors are the tracer's plain torch tensors (the
``paddle.*`` functions run on them; ``Tensor``'s own methods do not
exist there), and the outputs come back as ``Tensor``s when the call was
given ``Tensor``s.
"""
import functools
import inspect
import itertools

import numpy as np
import torch

from ..amp.auto_cast import _AMP_STATE
from ..core import random as random_core
from ..core.tensor import capture_scope, capturing, has_tensor, plain, wrap_all
from ..nn.layer import Layer

# rows of a program's key table at its first capture; a program that
# takes more keys is captured again with as many rows as it took
KEY_ROWS = 64


def _spec_of(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_spec_of(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple(sorted((k, _spec_of(v)) for k, v in x.items())))
    if isinstance(x, np.ndarray):
        return ("np", x.shape, str(x.dtype))
    return ("const", x if isinstance(x, (int, float, bool, str, type(None))) else str(x))


def _amp_key():
    state = _AMP_STATE.get()
    if state is None or not state.enable:
        return None
    return (str(state.dtype), state.level, tuple(sorted(state.white)),
            tuple(sorted(state.black)))


def _flatten_tensors(tree):
    """-> (list of torch tensors, skeleton, rebuild(tensors, skeleton))."""
    tensors = []

    def scan(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return ("T", len(tensors) - 1)
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, [scan(v) for v in x])
        if isinstance(x, dict):
            return ("dict", {k: scan(v) for k, v in x.items()})
        return ("C", x)

    skeleton = scan(tree)

    def rebuild(arrays, node):
        kind = node[0]
        if kind == "T":
            return arrays[node[1]]
        if kind in ("list", "tuple"):
            vals = [rebuild(arrays, v) for v in node[1]]
            return vals if kind == "list" else tuple(vals)
        if kind == "dict":
            return {k: rebuild(arrays, v) for k, v in node[1].items()}
        return node[1]

    return tensors, skeleton, rebuild


class ConcreteProgram:
    """One captured (key-specialised) program (reference:
    program_translator.py:582): ``module`` runs it as
    ``module(params, buffers, key_table, *inputs)``; its key table has
    ``n_keys`` rows, of which the program reads ``keys_used``."""

    def __init__(self, module, param_names, buffer_names, n_keys, keys_used, out_box):
        self.module = module
        self.param_names = param_names
        self.buffer_names = buffer_names
        self.n_keys = n_keys
        self.keys_used = keys_used
        self.out_box = out_box


_SF_COUNTER = itertools.count()

# mutable cell so bound StaticFunctions share the global switch
_TO_STATIC_ENABLED = [True]


def enable_to_static(flag):
    """Globally enable/disable to_static (reference:
    ProgramTranslator.enable / paddle.jit.enable_to_static)."""
    _TO_STATIC_ENABLED[0] = bool(flag)


def layer_state(layer):
    """(parameter names, buffer names) of ``layer``: its named parameters
    (a tied one once) and its named buffers, in order."""
    if layer is None:
        return [], []
    return ([n for n, _ in layer.named_parameters()], [n for n, _ in layer.named_buffers()])


def capture(fn, layer, args, kwargs, key_rows=None, dynamic_shapes=None, params=None,
            upcast_bf16=False):
    """torch.export ``fn(*args, **kwargs)`` with ``layer``'s parameters and
    buffers as inputs -> (ExportedProgram, parameter names, buffer names,
    keys taken, output box). The program is ``(params, buffers, *inputs)``,
    or ``(params, buffers, key_table, *inputs)`` with a key table of
    ``key_rows`` rows. ``fn`` runs under ``capture_scope``;
    ``dynamic_shapes``: one entry per argument tensor, in order, as
    ``torch.export`` takes them; ``params``: the example parameters by name
    (default: the layer's); ``upcast_bf16``: the program takes bfloat16
    parameters and computes with their float32 upcast (bf16w serving)."""
    p_names, b_names = layer_state(layer)
    if params is None:
        params = {n: p.detach() for n, p in layer.named_parameters()} if layer else {}
    buffers = dict(layer.named_buffers()) if layer is not None else {}
    in_tensors, in_skel, rebuild_in = _flatten_tensors((args, kwargs))
    box = {"keys": 0}

    def run(p_list, b_list, inputs):
        a2, kw2 = rebuild_in(list(inputs), in_skel)
        if upcast_bf16:
            p_list = [p.float() if p.dtype == torch.bfloat16 else p for p in p_list]
        if layer is not None:
            state = dict(zip(p_names, p_list))
            state.update(zip(b_names, b_list))
            # the swap torch.func.functional_call makes: the layer's own
            # tensors out, the program's inputs in
            with torch.nn.utils.stateless._reparametrize_module(layer, state, tie_weights=True):
                out = fn(*a2, **kw2)
        else:
            out = fn(*a2, **kw2)
        out_tensors, skel, rebuild = _flatten_tensors(out)
        box["skel"], box["rebuild"] = skel, rebuild
        return tuple(plain(t) for t in out_tensors)

    if key_rows is None:
        class _Program(torch.nn.Module):
            def forward(self, p_list, b_list, *inputs):
                with capture_scope():
                    return run(p_list, b_list, inputs)
        lead = ()
    else:
        class _Program(torch.nn.Module):
            def forward(self, p_list, b_list, keys, *inputs):
                with capture_scope(), random_core.key_table_guard(keys) as used:
                    out = run(p_list, b_list, inputs)
                box["keys"] = used[0]
                return out
        lead = (torch.zeros((key_rows, 2), dtype=torch.int64),)

    example = ([params[n] for n in p_names], [buffers[n] for n in b_names], *lead,
               *[plain(t).detach() for t in in_tensors])
    shapes = None
    if dynamic_shapes is not None:
        # the varargs' shapes as one tuple, as torch.export matches them
        shapes = ([None] * len(p_names), [None] * len(b_names), *([None] * len(lead)),
                  tuple(dynamic_shapes))
    exported = torch.export.export(_Program(), example, dynamic_shapes=shapes, strict=False)
    exported._example_inputs = None
    return exported, p_names, b_names, box["keys"], box


class StaticFunction:
    def __init__(self, function, input_spec=None, build_strategy=None, property_=False):
        self._orig_fn = function
        self._input_spec = input_spec
        self._cache = {}  # ProgramCache analog
        self._layer = getattr(function, "__self__", None)
        self._uid = next(_SF_COUNTER)
        functools.wraps(function)(self)

    def __get__(self, instance, owner):
        if instance is None:
            return self
        bound = StaticFunction(self._orig_fn.__get__(instance, owner), self._input_spec)
        bound._layer = instance
        # cache the bound StaticFunction on the instance
        object.__setattr__(instance, self._orig_fn.__name__, bound)
        return bound

    def concrete_program_specs(self):
        return list(self._cache)

    def _transformed(self):
        from . import dy2static

        fn = self._orig_fn
        # rewrite `if tensor:` / `while tensor:` into torch.cond/while_loop
        # (reference: DygraphToStaticAst in program_translator.py:582)
        if inspect.ismethod(fn):
            return dy2static.ast_transform(fn.__func__).__get__(fn.__self__)
        return dy2static.ast_transform(fn)

    def _build(self, args, kwargs):
        fn = self._transformed()
        rows = KEY_ROWS
        while True:
            exported, p_names, b_names, n_keys, box = capture(fn, self._layer, args, kwargs,
                                                              key_rows=rows)
            if n_keys <= rows:
                break
            rows = n_keys  # the program took more keys than its table had
        return ConcreteProgram(exported.module(), p_names, b_names, rows, n_keys, box)

    def __call__(self, *args, **kwargs):
        if not _TO_STATIC_ENABLED[0]:
            # ProgramTranslator.enable(False): the original dygraph code
            return self._orig_fn(*args, **kwargs)
        if capturing():
            # inside another capture: traced into the enclosing program
            return self._transformed()(*args, **kwargs)
        layer = self._layer
        training = layer.training if layer is not None else True
        key = (_spec_of(args), _spec_of(tuple(sorted(kwargs.items()))), training, _amp_key())
        program = self._cache.get(key)
        if program is None:
            try:
                program = self._build(args, kwargs)
            except Exception as exc:  # noqa: BLE001 - filtered right below
                from . import dy2static

                if not isinstance(exc, dy2static._trace_error_types()):
                    raise
                # the capture rejected the user's Python: attach ranked
                # source-level diagnostics instead of the raw tracer error
                explained = dy2static.explain_trace_failure(self._orig_fn, exc)
                if explained is None:
                    raise
                raise explained from exc
            self._cache[key] = program
        given_tensor = has_tensor(args, kwargs)
        if layer is not None:
            params = dict(layer.named_parameters())
            buffers = dict(layer.named_buffers())
            p_list = [params[n] for n in program.param_names]
            b_list = [buffers[n] for n in program.buffer_names]
        else:
            p_list, b_list = [], []
        # one key from the global stream a call, fold_in(key, i) for the
        # program's i-th random op (the reference's rng_guard order)
        rng = random_core.next_key()
        keys = torch.zeros((program.n_keys, 2), dtype=torch.int64)
        if program.keys_used:
            keys[:program.keys_used] = torch.tensor(
                [random_core.fold_in(rng, i) for i in range(program.keys_used)],
                dtype=torch.int64)
        in_tensors, _, _ = _flatten_tensors((args, kwargs))
        outs = program.module(p_list, b_list, keys, *[plain(t) for t in in_tensors])
        out = program.out_box["rebuild"](list(outs), program.out_box["skel"])
        return wrap_all(out) if given_tensor else out


def to_static(function=None, input_spec=None, build_strategy=None, backend=None, **kwargs):
    """@paddle.jit.to_static (reference: dygraph/jit.py:161 declarative)."""

    def decorate(fn):
        if isinstance(fn, Layer):
            fn.forward = StaticFunction(fn.forward, input_spec)
            return fn
        return StaticFunction(fn, input_spec)

    if function is not None:
        return decorate(function)
    return decorate


declarative = to_static


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    pass
