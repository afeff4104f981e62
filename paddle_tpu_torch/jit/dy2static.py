"""dygraph_to_static: data-dependent Python control flow under to_static
(counterpart of paddle_tpu/jit/dy2static.py; reference:
python/paddle/fluid/dygraph/dygraph_to_static/ ifelse_transformer.py,
loop_transformer.py, convert_operators.py).

The same AST rewrite of ``if``/``while`` statements into
``convert_ifelse``/``convert_while`` calls. The converters keep plain
Python semantics unless the predicate is a tensor inside a program being
captured by ``torch.export`` (``core.tensor.capturing()``): then the
branch lowers to torch's ``cond`` and the loop to its ``while_loop``
operator, with the tensor slots as operands or carry and the tensors the
branch or body reads from its closure as further inputs (each operator
traces its functions in a scope of their own). Python numbers among the slots become tensors there, as the
reference lifts them with ``jnp.asarray``. A branch or loop body whose
output is one of its operands is given a copy (torch's control-flow
operators take no output that aliases an input). Both operators carry
gradients in the torch builds the port runs on, so a captured training
step differentiates through them; a ``maximum_iterations`` loop counts
its steps in the carry.

``explain_trace_failure`` ranks the likely causes of a failed capture
from the function's source (host reads such as ``.item()``,
``.numpy()``, ``float(tensor)``, ``print``), the counterpart of the
reference's tracelint diagnostics, which the port does not carry.
"""
import ast
import functools
import inspect
import textwrap
import types

import numpy as np
import torch

from ..core.tensor import capturing, plain


class UndefinedVar:
    """Placeholder for a name not yet bound before a control-flow block
    (reference: dygraph_to_static/utils.py UndefinedVar)."""

    def __init__(self, name="<var>"):
        self._name = name

    def _raise(self):
        raise NameError(
            f"variable {self._name!r} is not defined on every control-flow "
            f"path before use (dy2static)")

    def __getattr__(self, item):
        self._raise()

    def __call__(self, *a, **k):
        self._raise()

    def __bool__(self):
        self._raise()


def _pred_value(pred):
    """-> ('py', bool) | ('traced', 0-d tensor)."""
    if isinstance(pred, np.ndarray):
        return "py", bool(pred.squeeze())
    if not isinstance(pred, torch.Tensor):
        return "py", bool(pred)
    pred = plain(pred).reshape(())
    if capturing():
        return "traced", pred
    return "py", bool(pred)


def pack_inputs(local_vars, names):
    """Build the control-flow input tuple from a locals() snapshot."""
    return tuple(local_vars.get(n, UndefinedVar(n)) for n in names)


def _to_operand(v, name):
    """Classify one control-flow slot: ('t', tensor) participates in the
    cond/while operands; ('c', obj) is a pass-through Python constant."""
    if isinstance(v, torch.Tensor):
        return "t", plain(v)
    if isinstance(v, np.ndarray):
        return "t", torch.as_tensor(v)
    if isinstance(v, (bool, int, float)):
        return "t", torch.tensor(v)
    return "c", v


def _unaliased(outs, ins):
    """Branch or body outputs, each that is one of the operands copied."""
    ids = {id(a) for a in ins}
    return tuple(o.clone() if id(o) in ids else o for o in outs)


def _lift(fn):
    """The tensors in ``fn``'s closure cells, and ``rebind(tensors)``: a
    copy of ``fn`` whose cells hold the given tensors instead. A branch
    reads the enclosing function's tensors through its closure; the
    control-flow operators trace it in a scope of its own, so each such
    tensor enters as an operand."""
    cells = fn.__closure__ or ()
    idx, vals = [], []
    for i, c in enumerate(cells):
        try:
            v = c.cell_contents
        except ValueError:  # not bound yet
            continue
        if isinstance(v, torch.Tensor):
            idx.append(i)
            vals.append(plain(v))

    def rebind(tensors):
        new = list(cells)
        for i, t in zip(idx, tensors):
            new[i] = types.CellType(t)
        g = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__, fn.__defaults__,
                               tuple(new))
        g.__kwdefaults__ = fn.__kwdefaults__
        return g

    return vals, rebind


def _unique(*groups):
    """One operand list for several tensor groups (a tensor passed twice
    would give the traced graph two inputs of one name) -> (operands, the
    groups as index lists into it)."""
    ops, pos, out = [], {}, []
    for g in groups:
        idx = []
        for t in g:
            if id(t) not in pos:
                pos[id(t)] = len(ops)
                ops.append(t)
            idx.append(pos[id(t)])
        out.append(idx)
    return tuple(ops), out


def _hop(name):
    """torch's control-flow operator itself (``cond_op``,
    ``while_loop_op``), traced by the export's own tracer: the public
    wrappers hand their branches to dynamo, which refuses the Python
    bookkeeping a branch does here."""
    import sys

    import torch._higher_order_ops  # noqa: F401

    mod, op = name.split(".")
    return getattr(sys.modules[f"torch._higher_order_ops.{mod}"], op)


def convert_ifelse(pred, true_fn, false_fn, vals):
    """reference: convert_operators.py convert_ifelse. Branch fns take
    ``vals`` (the names both branches may rebind) and return the same
    tuple. A Python predicate (or a tensor outside a capture) runs one
    branch; a traced one lowers to torch's ``cond`` over the tensor slots
    and the tensors the branches read from their closures (both branches
    traced)."""
    kind, p = _pred_value(pred)
    if kind == "py":
        return true_fn(*vals) if p else false_fn(*vals)

    kinds_vals = [_to_operand(v, i) for i, v in enumerate(vals)]
    slots = tuple(a for k, a in kinds_vals if k == "t")
    t_free, t_rebind = _lift(true_fn)
    f_free, f_rebind = _lift(false_fn)
    operands, (i_s, i_t, i_f) = _unique(slots, t_free, f_free)
    meta_box = {}

    def branch(rebind, free_idx, tag):
        def g(*ops):
            fn = rebind([ops[i] for i in free_idx])
            it = iter([ops[i] for i in i_s])
            full = tuple(next(it) if k == "t" else v for (k, v) in kinds_vals)
            outs = fn(*full)
            if not isinstance(outs, tuple):
                outs = (outs,)
            flat, meta = [], []
            for i, o in enumerate(outs):
                if isinstance(o, UndefinedVar):
                    meta.append(("u", o))
                    continue
                k, a = _to_operand(o, i)
                if k == "t":
                    meta.append(("t", None))
                    flat.append(a)
                else:
                    meta.append(("c", o))
            meta_box[tag] = meta
            return _unaliased(flat, ops)

        return g

    out_flat = _hop("cond.cond_op")(p.to(torch.bool), branch(t_rebind, i_t, "t"),
                                    branch(f_rebind, i_f, "f"), operands)
    meta_t, meta_f = meta_box["t"], meta_box["f"]
    if [m[0] for m in meta_t] != [m[0] for m in meta_f]:
        raise TypeError(
            "dy2static ifelse: the two branches produce different variable "
            f"kinds per slot: {[m[0] for m in meta_t]} vs "
            f"{[m[0] for m in meta_f]} — every rebound name must be a tensor "
            "(or equal constant) on both paths")
    outs, ti = [], 0
    for (kt, vt), (kf, vf) in zip(meta_t, meta_f):
        if kt == "t":
            outs.append(out_flat[ti])
            ti += 1
        elif kt == "c":
            try:
                same = bool(vt == vf)
            except Exception:  # noqa: BLE001
                same = vt is vf
            if not same:
                raise TypeError(
                    f"dy2static ifelse: non-tensor variable differs between "
                    f"branches ({vt!r} vs {vf!r}) under a traced predicate")
            outs.append(vt)
        else:
            outs.append(vt)
    return tuple(outs)


def convert_while(cond_fn, body_fn, vals, maximum_iterations=None):
    """reference: convert_operators.py convert_while_loop. A Python
    predicate (or a tensor outside a capture) runs a plain while, so
    autograd records every iteration; a traced one lowers to torch's
    ``while_loop`` with the tensor slots as carry (shapes and dtypes must
    be loop-invariant, as in the reference's while_op) and the tensors the
    functions read from their closures as its further inputs."""
    kind, p = _pred_value(cond_fn(*vals))
    if kind == "py":
        iters = 0
        while p:
            if maximum_iterations is not None and iters >= int(maximum_iterations):
                break  # honor the bound on the eager path too
            vals = body_fn(*vals)
            iters += 1
            if not isinstance(vals, tuple):
                vals = (vals,)
            kind, p = _pred_value(cond_fn(*vals))
            if kind != "py":
                return _traced_while(cond_fn, body_fn, vals, maximum_iterations)
        return vals
    return _traced_while(cond_fn, body_fn, vals, maximum_iterations)


def _traced_while(cond_fn, body_fn, vals, maximum_iterations=None):
    """``while_loop`` over the tensor slots; with ``maximum_iterations``
    the carry also counts the steps and the loop stops at the bound."""
    kinds_vals = [_to_operand(v, i) for i, v in enumerate(vals)]
    for (k, _), v in zip(kinds_vals, vals):
        if isinstance(v, UndefinedVar):
            v._raise()
    n_t = sum(1 for k, _ in kinds_vals if k == "t")
    c_free, c_rebind = _lift(cond_fn)
    b_free, b_rebind = _lift(body_fn)
    extra_ops, (i_c, i_b) = _unique(c_free, b_free)
    bounded = maximum_iterations is not None
    lead = 1 if bounded else 0

    def rebuild(carry):
        it = iter(carry)
        return tuple(next(it) if k == "t" else v for (k, v) in kinds_vals)

    def cond_w(*args):
        carry, extra = args[lead:lead + n_t], args[lead + n_t:]
        kind, p = _pred_value(c_rebind([extra[i] for i in i_c])(*rebuild(carry)))
        if kind == "py":
            # a condition independent of the carry: lift the Python bool
            p = torch.tensor(bool(p))
        p = p.to(torch.bool)
        if bounded:
            p = (args[0] < int(maximum_iterations)) & p
        return p

    def body_w(*args):
        carry, extra = args[lead:lead + n_t], args[lead + n_t:]
        outs = b_rebind([extra[i] for i in i_b])(*rebuild(carry))
        if not isinstance(outs, tuple):
            outs = (outs,)
        flat = []
        for i, o in enumerate(outs):
            k, a = _to_operand(o, i)
            if k == "t":
                flat.append(a)
        if len(flat) != n_t:
            raise TypeError(
                "dy2static while: loop body changed which variables are "
                "tensors; the traced carry must be shape/dtype stable")
        flat = _unaliased(flat, args)
        return ((args[0] + 1,) + flat) if bounded else flat

    carry0 = tuple(a for k, a in kinds_vals if k == "t")
    if bounded:
        carry0 = (torch.tensor(0),) + carry0
    carry = _hop("while_loop.while_loop_op")(cond_w, body_w, carry0, extra_ops)
    return rebuild(tuple(carry)[lead:])


# --------------------------------------------------------------- AST rewrite


class _AssignedNames(ast.NodeVisitor):
    """Names (re)bound inside a statement list, excluding nested function
    scopes (their locals don't escape)."""

    def __init__(self):
        self.names = set()

    def visit_FunctionDef(self, node):
        self.names.add(node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def visit_Name(self, node):
        # Del unbinds rather than binds — a deleted name must not appear in
        # the synthesized return tuple
        if isinstance(node.ctx, ast.Store):
            self.names.add(node.id)

    def visit_ClassDef(self, node):
        self.names.add(node.name)


def _assigned(stmts):
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    # generated helper names from already-transformed nested blocks are
    # internal, not user control-flow outputs
    return {n for n in v.names if not n.startswith("__jst_")}


class _HasEscape(ast.NodeVisitor):
    """Detects return (anywhere in this scope) or break/continue that would
    escape the block (loop depth 0) — such blocks keep Python semantics."""

    def __init__(self):
        self.escape = False
        self._loop_depth = 0

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def visit_Return(self, node):
        self.escape = True

    def visit_Delete(self, node):
        # `del` unbinds a local mid-block; the synthesized return tuple
        # could reference it — keep Python semantics for such blocks
        self.escape = True

    def _loop(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _loop
    visit_While = _loop

    def visit_Break(self, node):
        if self._loop_depth == 0:
            self.escape = True

    visit_Continue = visit_Break


def _escapes(stmts):
    v = _HasEscape()
    for s in stmts:
        v.visit(s)
    return v.escape


def _fn_def(name, args, body):
    fd = ast.FunctionDef(name=name, args=args, body=body, decorator_list=[],
                         returns=None)
    if "type_params" in ast.FunctionDef._fields:  # py3.12+
        fd.type_params = []
    return fd


class Dy2StaticTransformer(ast.NodeTransformer):
    """Rewrites If/While statements into convert_ifelse/convert_while calls
    (reference: ifelse_transformer.py IfElseTransformer +
    loop_transformer.py LoopTransformer)."""

    def __init__(self):
        self._n = 0

    def _uid(self):
        self._n += 1
        return self._n

    def visit_If(self, node):
        self.generic_visit(node)
        if _escapes(node.body) or _escapes(node.orelse):
            return node
        names = sorted(_assigned(node.body) | _assigned(node.orelse))
        uid = self._uid()
        tname, fname = f"__jst_true_{uid}", f"__jst_false_{uid}"
        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in names],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in names],
            ctx=ast.Load()))
        true_def = _fn_def(tname, args, list(node.body) + [ret])
        false_def = _fn_def(
            fname, args, (list(node.orelse) or [ast.Pass()]) + [ret])
        call = ast.Call(
            func=_jst_attr("convert_ifelse"),
            args=[node.test,
                  ast.Name(id=tname, ctx=ast.Load()),
                  ast.Name(id=fname, ctx=ast.Load()),
                  _pack_call(names)],
            keywords=[])
        if names:
            assign = ast.Assign(
                targets=[ast.Tuple(
                    elts=[ast.Name(id=n, ctx=ast.Store()) for n in names],
                    ctx=ast.Store())],
                value=call)
        else:
            assign = ast.Expr(value=call)
        return [true_def, false_def, assign]

    def visit_While(self, node):
        self.generic_visit(node)
        if _escapes(node.body) or node.orelse:
            return node
        names = sorted(_assigned(node.body))
        if not names:
            return node
        uid = self._uid()
        cname, bname = f"__jst_cond_{uid}", f"__jst_body_{uid}"
        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in names],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        cond_def = _fn_def(cname, args, [ast.Return(value=node.test)])
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in names],
            ctx=ast.Load()))
        body_def = _fn_def(bname, args, list(node.body) + [ret])
        call = ast.Call(
            func=_jst_attr("convert_while"),
            args=[ast.Name(id=cname, ctx=ast.Load()),
                  ast.Name(id=bname, ctx=ast.Load()),
                  _pack_call(names)],
            keywords=[])
        assign = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in names],
                ctx=ast.Store())],
            value=call)
        return [cond_def, body_def, assign]


def _jst_attr(name):
    return ast.Attribute(value=ast.Name(id="__paddle_tpu_jst__",
                                        ctx=ast.Load()),
                         attr=name, ctx=ast.Load())


def _pack_call(names):
    return ast.Call(
        func=_jst_attr("pack_inputs"),
        args=[ast.Call(func=ast.Name(id="locals", ctx=ast.Load()), args=[],
                       keywords=[]),
              ast.List(elts=[ast.Constant(value=n) for n in names],
                       ctx=ast.Load())],
        keywords=[])


_THIS = __import__("sys").modules[__name__]


# ------------------------------------------------- trace-failure diagnostics


class TraceSafetyError(RuntimeError):
    """A to_static capture failed; ``.diagnostics`` carries the ranked
    findings for the user function (the reference's actionable dy2static
    error, with its tracelint findings)."""

    def __init__(self, message, diagnostics=()):
        super().__init__(message)
        self.diagnostics = list(diagnostics)


def _trace_error_types():
    """torch errors that mean "the user's Python is not capture-safe" (a
    host read of a traced value, a branch on one), as against a shape or
    dtype bug inside an op: only these get the diagnostics."""
    from torch._subclasses import fake_tensor
    from torch.fx.experimental import symbolic_shapes

    names = ((symbolic_shapes, "GuardOnDataDependentSymNode"),
             (fake_tensor, "DataDependentOutputException"),
             (fake_tensor, "DynamicOutputShapeException"),
             (fake_tensor, "UnsupportedOperatorException"))
    found = [getattr(m, n, None) for m, n in names]
    try:
        from torch._dynamo import exc as dynamo_exc

        found.append(getattr(dynamo_exc, "UserError", None))
    except ImportError:
        pass
    return tuple(t for t in found if t is not None)


class Finding:
    """One ranked cause: ``code``, ``filename``, ``line``, ``message``,
    ``hint``."""

    def __init__(self, code, filename, line, message, hint=""):
        self.code, self.filename, self.line = code, filename, line
        self.message, self.hint = message, hint


# attribute calls and builtins that read a tensor's value on the host
_HOST_METHODS = {"item": "host-read", "numpy": "host-read", "tolist": "host-read", "cpu": "host-read"}
_HOST_BUILTINS = {"float": "host-value", "int": "host-value", "bool": "host-value", "print": "host-print"}
_HINTS = {
    "host-read": "keep the value on the device (paddle.* ops) or return it from the function",
    "host-value": "a Python number of a traced tensor needs its value: compute with tensors",
    "host-print": "print runs once at capture; return the value instead",
    "TPU001": "dy2static rewrites this if into torch.cond",
    "TPU002": "dy2static rewrites this while into while_loop",
}


def lint_function(fn):
    """The findings in ``fn``'s source: host reads (``.item()``,
    ``.numpy()``, ``.tolist()``, ``.cpu()``), ``float``/``int``/``bool`` of
    a value, ``print``, and the ``if``/``while`` statements dy2static
    rewrites (TPU001/TPU002)."""
    src = textwrap.dedent(inspect.getsource(fn))
    filename = inspect.getsourcefile(fn) or "<unknown>"
    first = inspect.getsourcelines(fn)[1] - 1
    out = []
    for node in ast.walk(ast.parse(src)):
        line = first + getattr(node, "lineno", 0)
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS:
                code = _HOST_METHODS[f.attr]
                out.append(Finding(code, filename, line, f".{f.attr}() reads a tensor "
                                   "on the host", _HINTS[code]))
            elif isinstance(f, ast.Name) and f.id in _HOST_BUILTINS and node.args:
                code = _HOST_BUILTINS[f.id]
                out.append(Finding(code, filename, line, f"{f.id}(...) of a value",
                                   _HINTS[code]))
        elif isinstance(node, ast.If):
            out.append(Finding("TPU001", filename, line, "if on a value", _HINTS["TPU001"]))
        elif isinstance(node, ast.While):
            out.append(Finding("TPU002", filename, line, "while on a value",
                               _HINTS["TPU002"]))
    return sorted(out, key=lambda d: (d.line, d.code))


def explain_trace_failure(fn, exc):
    """A TraceSafetyError whose message ranks the likely causes in ``fn``'s
    source next to the raw capture error, or None when ``fn`` has no
    findings (the caller re-raises the original error)."""
    target = inspect.unwrap(getattr(fn, "__func__", fn))
    try:
        diags = lint_function(target)
    except Exception:  # noqa: BLE001 - diagnostics must never mask the error
        return None
    if not diags:
        return None
    # if/while are rewritten by ast_transform, so usually NOT the cause:
    # rank genuine capture-breakers (host reads, side effects) first
    auto_rewritten = ("TPU001", "TPU002")
    diags = sorted(diags, key=lambda d: (d.code in auto_rewritten, d.line, d.code))
    name = getattr(target, "__qualname__", repr(target))
    lines = [f"to_static failed while tracing {name!r}: {exc}", "",
             f"found {len(diags)} likely cause(s) in the function source, ranked:"]
    for i, d in enumerate(diags, start=1):
        note = (" (dy2static auto-rewrites this construct; likely benign)"
                if d.code in auto_rewritten else "")
        lines.append(f"  {i}. {d.filename}:{d.line} [{d.code}] {d.message}{note}")
        if d.hint:
            lines.append(f"     hint: {d.hint}")
    return TraceSafetyError("\n".join(lines), diagnostics=diags)


@functools.lru_cache(maxsize=256)
def _transform_code(fn):
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    fdef.decorator_list = []  # the decorator re-applying would recurse
    new = Dy2StaticTransformer().visit(tree)
    ast.fix_missing_locations(new)
    return compile(new, filename=f"<dy2static {fn.__qualname__}>", mode="exec")


def ast_transform(fn):
    """Return fn with If/While over tensor predicates rewritten to
    torch.cond / while_loop converters; on any failure (no source, exotic
    constructs) returns fn unchanged — the trace path still handles all
    non-data-dependent control flow."""
    try:
        code = _transform_code(fn)
    except (OSError, TypeError, SyntaxError, ValueError, IndexError):
        return fn
    glb = dict(fn.__globals__)
    glb["__paddle_tpu_jst__"] = _THIS
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                # the closure value must shadow any same-named module global,
                # matching the original function's scoping
                glb[name] = cell.cell_contents
            except ValueError:
                pass
    loc = {}
    exec(code, glb, loc)  # noqa: S102 — compiling the user's own function
    new_fn = loc.get(fn.__name__)
    if new_fn is None:  # a lambda: nothing to rewrite
        return fn
    if fn.__defaults__:
        new_fn.__defaults__ = fn.__defaults__
    if fn.__kwdefaults__:
        new_fn.__kwdefaults__ = dict(fn.__kwdefaults__)
    return functools.wraps(fn)(new_fn)
