"""ONNX export (counterpart of paddle_tpu/onnx/export.py; reference:
python/paddle/onnx/export.py, which shells out to paddle2onnx).

The reference traces the layer to a jaxpr and lowers its primitives one
to many. The port captures the eval-mode layer with ``torch.export``
(jit's ``capture``, the layer's weights as inputs), decomposes it to the
core ATen op set (``run_decompositions``) and lowers each ATen node to
ONNX nodes, serialized by wire.py. It emits only ops that the reference's
numpy runner evaluates (``runner._OPS``), at opset 11 or 12, so either
package's runner reads either package's file.

What is known without the inputs folds into initializers: the weights,
the buffers and the program's constants, and every node computed from
them alone (a transposed weight, the fused QKV weight, a causal mask, an
``arange``), as the reference's trace bakes its constants. A node whose
value depends only on its input's shape (``zeros_like``) folds too.

The port's custom ops lower to plain ONNX: K1 (``paddle_tpu_torch::
flash_attention_fwd``) to the attention chain MatMul, scale, the
bottom-right causal mask, the softmax as the reference emits it
(ReduceMax, Sub, Exp, ReduceSum, Div) and MatMul; ``ieee_convolution`` to
Conv; ``wq_matmul`` to its dequantize-then-MatMul, as the reference's
``Int8Linear`` exports. A node with no lowering raises ``UnsupportedOp``
(train-mode dropout, K1's dropout and length forms, transposed
convolutions, as in the reference). Exporting on the card copies the
initializers to the host.
"""
import operator

import numpy as np
import torch

from . import wire


def export(layer, path, input_spec=None, opset_version=12, **configs):
    """Export ``layer`` to ``path + '.onnx'`` (reference signature:
    python/paddle/onnx/export.py:20). Opsets 11 and 12: the emitted
    Clip/Pad/Slice forms need >= 11, GreaterOrEqual/LessOrEqual >= 12, and
    ReduceSum's axes attribute <= 12."""
    if input_spec is None:
        raise ValueError(
            "input_spec is required: pass a list of InputSpec / Tensor / ndarray examples "
            "describing forward()'s inputs")
    model_bytes = export_bytes(layer, input_spec, opset_version, **configs)
    out_path = path if path.endswith(".onnx") else path + ".onnx"
    with open(out_path, "wb") as f:
        f.write(model_bytes)
    return out_path


def export_bytes(layer, input_spec, opset_version=12, **configs):
    if opset_version not in (11, 12):
        raise ValueError(
            f"opset_version {opset_version} unsupported: this exporter emits opset 11/12 op "
            "forms (Clip/Pad/Slice inputs >=11, ReduceSum axes-attribute <=12)")
    arrs = _example_arrays(input_spec)
    exported, p_names, b_names, state = _trace(layer, [a for _, a in arrs])
    cv = _Converter(opset_version)
    user = [n for n in exported.graph.nodes if n.op == "placeholder"]
    specs = exported.graph_signature.input_specs
    n_p, n_b = len(p_names), len(b_names)
    k = 0
    for node, spec in zip(user, specs):
        if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT:
            if k < n_p:
                cv.known(node, state[0][k], p_names[k])
            elif k < n_p + n_b:
                cv.known(node, state[1][k - n_p], b_names[k - n_p])
            else:
                iname, _ = arrs[k - n_p - n_b]
                cv.bind(node, iname)
            k += 1
        else:  # a lifted constant or buffer of the program
            src = (exported.constants.get(spec.target) if spec.target in exported.constants
                   else exported.state_dict[spec.target])
            cv.known(node, src, None)
    outputs = []
    for node in exported.graph.nodes:
        if node.op == "call_function":
            cv.convert(node)
        elif node.op == "output":
            for i, o in enumerate(node.args[0]):
                oname = f"output_{i}"
                cv.add_node("Identity", [cv.name_of(o)], [oname])
                val = _meta(o)
                outputs.append((oname, wire.onnx_dtype(_np_name(val.dtype)), list(val.shape)))
    inputs = [(iname, wire.onnx_dtype(arr.dtype.name), list(arr.shape)) for iname, arr in arrs]
    graph = wire.graph_proto("paddle_tpu_graph", cv.nodes, cv.initializers, inputs, outputs)
    return wire.model_proto(graph, opset_version)


def _example_arrays(input_spec):
    from ..static.input_spec import InputSpec

    arrs = []
    for i, spec in enumerate(input_spec):
        if isinstance(spec, InputSpec):
            if any(d is None or int(d) < 0 for d in spec.shape):
                raise ValueError(
                    f"input_spec[{i}] has dynamic dims {spec.shape}: ONNX export traces a "
                    "static-shape graph; export one model per concrete shape instead")
            arrs.append((spec.name or f"x{i}",
                         np.zeros([int(d) for d in spec.shape], np.dtype(spec.dtype))))
        elif isinstance(spec, torch.Tensor):
            arrs.append((getattr(spec, "name", None) or f"x{i}",
                         np.asarray(spec.detach().cpu().numpy())))
        else:
            arrs.append((f"x{i}", np.asarray(spec)))
    return arrs


def _trace(layer, xs):
    """-> (ExportedProgram in core ATen, parameter names, buffer names,
    (parameter tensors, buffer tensors))."""
    from ..jit.static_function import capture, layer_state

    layer.eval()
    params = {n: p.detach() for n, p in layer.named_parameters()}
    p_names, b_names = layer_state(layer)
    buffers = dict(layer.named_buffers())
    device = (next(iter(params.values())).device if params
              else next(iter(buffers.values())).device if buffers else torch.device("cpu"))
    example = tuple(torch.from_numpy(np.array(x)).to(device) for x in xs)
    with torch.no_grad():
        exported = capture(layer.forward, layer, example, {}, key_rows=None)[0]
        exported = exported.run_decompositions()
    state = ([params[n] for n in p_names], [buffers[n].detach() for n in b_names])
    return exported, p_names, b_names, state


class UnsupportedOp(NotImplementedError):
    pass


def _meta(node):
    return node.meta["val"]


def _np_name(dtype):
    name = str(dtype).replace("torch.", "")
    if name == "bfloat16":
        raise UnsupportedOp("bfloat16 values: export a float32 model")
    return name


_SHAPE_ONLY = {"aten.zeros_like.default", "aten.ones_like.default", "aten.full_like.default",
               "aten.empty_like.default", "aten.new_zeros.default", "aten.new_ones.default",
               "aten.new_full.default", "aten.new_empty.default",
               "aten.empty_strided.default", "aten.sym_size.int"}


# checks that torch.export leaves in the graph; they compute nothing
_NO_VALUE = {"aten._assert_tensor_metadata.default", "aten._assert_async.msg",
             "aten._assert_scalar.default", "aten.sym_constrain_range_for_size.default"}


class _Converter:
    def __init__(self, opset=12):
        self.opset = opset
        self.nodes = []  # serialized NodeProto bytes, in order
        self.initializers = {}  # name -> ndarray
        self._names = {}  # fx node -> onnx value name (a list for several outputs)
        self._vals = {}  # fx node -> known torch value (a tuple for several)
        self._init_names = {}  # fx node -> the weight's name
        self._n = 0

    # -------------------------------------------------------- name plumbing
    def fresh(self, hint="v"):
        self._n += 1
        return f"{hint}_{self._n}"

    def bind(self, node, name):
        self._names[node] = name

    def known(self, node, value, name):
        """``node``'s value is ``value``: an initializer (under ``name``)
        once a node reads it."""
        self._vals[node] = value
        if name is not None:
            self._init_names[node] = name

    def add_init(self, arr, name=None):
        name = name or self.fresh("const")
        self.initializers[name] = arr
        return name

    def i64(self, values):
        return self.add_init(np.asarray(values, dtype=np.int64))

    def scalar(self, v, dtype):
        return self.add_init(np.asarray(v, dtype=np.dtype(_np_name(dtype))))

    def name_of(self, node):
        if node not in self._names:
            if node not in self._vals:
                raise UnsupportedOp(f"value of {node} is neither computed nor known")
            self._names[node] = self.add_init(_host(self._vals[node]),
                                              self._init_names.get(node))
        return self._names[node]

    def add_node(self, op_type, inputs, outputs=None, attrs=None):
        outputs = outputs or [self.fresh(op_type.lower())]
        self.nodes.append(wire.node_proto(op_type, inputs, outputs, name=self.fresh(op_type),
                                          attrs=attrs))
        return outputs

    def one(self, op_type, inputs, attrs=None):
        return self.add_node(op_type, inputs, attrs=attrs)[0]

    def cast(self, name, src_dtype, dtype):
        if src_dtype == dtype:
            return name
        return self.one("Cast", [name], {"to": wire.onnx_dtype(_np_name(dtype))})

    def operand(self, a, dtype):
        """An argument (a node or a Python number) as a value of ``dtype``."""
        if isinstance(a, torch.fx.Node):
            return self.cast(self.name_of(a), _meta(a).dtype, dtype)
        return self.scalar(a, dtype)

    # ------------------------------------------------------------- dispatch
    def convert(self, node):
        target = node.target
        args = node.args
        if target is operator.getitem:
            src, i = args
            if src in self._vals:
                self._vals[node] = self._vals[src][i]
            else:
                names = self._names[src]
                if names[i] is None:
                    raise UnsupportedOp(f"output {i} of {src.target} has no lowering")
                self._names[node] = names[i]
            return
        key = str(target)
        if key in _NO_VALUE:
            return
        tensors = [a for a in _flat(args, node.kwargs) if isinstance(a, torch.fx.Node)]
        if all(a in self._vals for a in tensors) or key in _SHAPE_ONLY:
            self._vals[node] = self._evaluate(node)
            return
        handler = _HANDLERS.get(key)
        if handler is None:
            raise UnsupportedOp(
                f"ATen op '{key}' has no ONNX lowering (shapes "
                f"{[tuple(_meta(a).shape) for a in tensors]}); export supports eval-mode "
                "inference graphs only")
        out = handler(self, node, *args, **node.kwargs)
        self._names[node] = out

    def _evaluate(self, node):
        def real(a):
            if isinstance(a, torch.fx.Node):
                if a in self._vals:
                    return self._vals[a]
                m = _meta(a)
                return torch.zeros(m.shape, dtype=m.dtype, device=m.device)
            if isinstance(a, (list, tuple)):
                return type(a)(real(v) for v in a)
            return a

        with torch.no_grad():
            return node.target(*real(node.args), **{k: real(v) for k, v in node.kwargs.items()})


def _flat(args, kwargs):
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


def _host(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            raise UnsupportedOp("bfloat16 values: export a float32 model")
        return t.detach().cpu().numpy().copy()
    return np.asarray(t)


# ------------------------------------------------------------------ handlers


def _elementwise(op_type):
    def h(cv, node, *args, **kw):
        dt = _meta(node).dtype
        return cv.one(op_type, [cv.operand(a, dt) for a in args[:2]])
    return h


def _compare(op_type, negate=False):
    def h(cv, node, a, b, **kw):
        ta = _meta(a).dtype if isinstance(a, torch.fx.Node) else None
        tb = _meta(b).dtype if isinstance(b, torch.fx.Node) else None
        dt = (torch.promote_types(ta, tb) if ta is not None and tb is not None
              else ta or tb)
        out = cv.one(op_type, [cv.operand(a, dt), cv.operand(b, dt)])
        return cv.one("Not", [out]) if negate else out
    return h


def _ge_le(op_type):
    comp = _compare(op_type)

    def h(cv, node, a, b, **kw):
        if cv.opset < 12:
            raise UnsupportedOp(f"{op_type} requires opset >= 12 (export with "
                                "opset_version=12)")
        return comp(cv, node, a, b)
    return h


def _unary(op_type):
    def h(cv, node, x, *rest, **kw):
        return cv.one(op_type, [cv.operand(x, _meta(node).dtype)])
    return h


def _h_add(cv, node, a, b, alpha=1):
    dt = _meta(node).dtype
    bn = cv.operand(b, dt)
    if alpha != 1:
        bn = cv.one("Mul", [bn, cv.scalar(alpha, dt)])
    return cv.one("Add", [cv.operand(a, dt), bn])


def _h_sub(cv, node, a, b, alpha=1):
    dt = _meta(node).dtype
    bn = cv.operand(b, dt)
    if alpha != 1:
        bn = cv.one("Mul", [bn, cv.scalar(alpha, dt)])
    return cv.one("Sub", [cv.operand(a, dt), bn])


def _h_div_mode(cv, node, a, b, rounding_mode=None):
    dt = _meta(node).dtype
    out = cv.one("Div", [cv.operand(a, dt), cv.operand(b, dt)])
    if rounding_mode == "floor" and dt.is_floating_point:
        out = cv.one("Floor", [out])
    elif rounding_mode is not None and not dt.is_floating_point:
        raise UnsupportedOp(f"integer div with rounding_mode={rounding_mode!r}")
    return out


def _h_rsqrt(cv, node, x):
    return cv.one("Reciprocal", [cv.one("Sqrt", [cv.name_of(x)])])


def _h_relu(cv, node, x):
    return cv.one("Max", [cv.name_of(x), cv.scalar(0, _meta(node).dtype)])


def _h_pow(cv, node, x, e):
    dt = _meta(node).dtype
    return cv.one("Pow", [cv.operand(x, dt), cv.operand(e, dt)])


def _h_gelu(cv, node, x, approximate="none"):
    dt = _meta(node).dtype
    xn = cv.name_of(x)
    if approximate == "tanh":
        cube = cv.one("Mul", [cv.one("Mul", [xn, xn]), xn])
        inner = cv.one("Add", [xn, cv.one("Mul", [cube, cv.scalar(0.044715, dt)])])
        t = cv.one("Tanh", [cv.one("Mul", [inner, cv.scalar(np.sqrt(2.0 / np.pi), dt)])])
        half = cv.one("Mul", [xn, cv.scalar(0.5, dt)])
        return cv.one("Mul", [half, cv.one("Add", [t, cv.scalar(1.0, dt)])])
    e = cv.one("Erf", [cv.one("Div", [xn, cv.scalar(np.sqrt(2.0), dt)])])
    half = cv.one("Mul", [xn, cv.scalar(0.5, dt)])
    return cv.one("Mul", [half, cv.one("Add", [e, cv.scalar(1.0, dt)])])


def _h_clamp(cv, node, x, min=None, max=None):
    dt = _meta(node).dtype
    lo = -np.inf if min is None else min
    hi = np.inf if max is None else max
    if not dt.is_floating_point:
        info = torch.iinfo(dt)
        lo = info.min if min is None else min
        hi = info.max if max is None else max
    return cv.one("Clip", [cv.operand(x, dt), cv.operand(lo, dt), cv.operand(hi, dt)])


def _h_where(cv, node, c, a, b):
    dt = _meta(node).dtype
    return cv.one("Where", [cv.operand(c, torch.bool), cv.operand(a, dt), cv.operand(b, dt)])


def _h_masked_fill(cv, node, x, mask, value):
    dt = _meta(node).dtype
    return cv.one("Where", [cv.operand(mask, torch.bool), cv.operand(value, dt),
                            cv.operand(x, dt)])


def _h_to_copy(cv, node, x, **kw):
    return cv.cast(cv.name_of(x), _meta(x).dtype, _meta(node).dtype)


def _h_identity(cv, node, x, *rest, **kw):
    return cv.one("Identity", [cv.name_of(x)])


def _h_reshape(cv, node, x, *rest, **kw):
    return cv.one("Reshape", [cv.name_of(x), cv.i64(list(_meta(node).shape))])


def _h_expand(cv, node, x, *rest, **kw):
    return cv.one("Expand", [cv.name_of(x), cv.i64(list(_meta(node).shape))])


def _h_permute(cv, node, x, dims):
    nd = _meta(x).dim()
    return cv.one("Transpose", [cv.name_of(x)], {"perm": [int(d) % nd for d in dims]})


def _h_t(cv, node, x):
    if _meta(x).dim() < 2:
        return cv.one("Identity", [cv.name_of(x)])
    return cv.one("Transpose", [cv.name_of(x)], {"perm": [1, 0]})


def _h_transpose(cv, node, x, d0, d1):
    nd = _meta(x).dim()
    perm = list(range(nd))
    perm[d0 % nd], perm[d1 % nd] = perm[d1 % nd], perm[d0 % nd]
    return cv.one("Transpose", [cv.name_of(x)], {"perm": perm})


def _h_slice(cv, node, x, dim=0, start=None, end=None, step=1):
    size = _meta(x).shape[dim]
    start = 0 if start is None else start
    end = size if end is None else end
    start = max(0, min(size, start + size if start < 0 else start))
    end = max(0, min(size, end + size if end < 0 else end))
    nd = _meta(x).dim()
    return cv.one("Slice", [cv.name_of(x), cv.i64([start]), cv.i64([end]),
                            cv.i64([dim % nd]), cv.i64([step])])


def _h_select(cv, node, x, dim, index):
    size = _meta(x).shape[dim]
    i = index % size
    nd = _meta(x).dim()
    part = cv.one("Slice", [cv.name_of(x), cv.i64([i]), cv.i64([i + 1]), cv.i64([dim % nd]),
                            cv.i64([1])])
    return cv.one("Reshape", [part, cv.i64(list(_meta(node).shape))])


def _h_cat(cv, node, tensors, dim=0):
    dt = _meta(node).dtype
    nd = _meta(node).dim()
    return cv.one("Concat", [cv.operand(t, dt) for t in tensors], {"axis": dim % nd})


def _split_outputs(cv, x, sizes, dim):
    nd = _meta(x).dim()
    outs = cv.add_node("Split", [cv.name_of(x)], outputs=[cv.fresh("split") for _ in sizes],
                       attrs={"axis": dim % nd, "split": [int(s) for s in sizes]})
    return list(outs)


def _h_split_with_sizes(cv, node, x, sizes, dim=0):
    return _split_outputs(cv, x, sizes, dim)


def _h_split(cv, node, x, size, dim=0):
    total = _meta(x).shape[dim]
    sizes = [min(size, total - i) for i in range(0, total, size)]
    return _split_outputs(cv, x, sizes, dim)


def _gather(cv, table, idx, axis):
    return cv.one("Gather", [cv.name_of(table), cv.name_of(idx)], {"axis": axis})


def _h_index_select(cv, node, x, dim, index):
    return _gather(cv, x, index, dim % _meta(x).dim())


def _h_embedding(cv, node, weight, indices, *rest):
    return _gather(cv, weight, indices, 0)


def _h_index(cv, node, x, indices):
    live = [(i, t) for i, t in enumerate(indices) if t is not None]
    if len(live) != 1:
        raise UnsupportedOp(f"aten.index with {len(live)} index tensors (one only)")
    axis, idx = live[0]
    return _gather(cv, x, idx, axis)


def _h_mm(cv, node, a, b):
    return cv.one("MatMul", [cv.name_of(a), cv.name_of(b)])


def _h_addmm(cv, node, bias, a, b, beta=1, alpha=1):
    dt = _meta(node).dtype
    mm = cv.one("MatMul", [cv.name_of(a), cv.name_of(b)])
    if alpha != 1:
        mm = cv.one("Mul", [mm, cv.scalar(alpha, dt)])
    bn = cv.name_of(bias)
    if beta != 1:
        bn = cv.one("Mul", [bn, cv.scalar(beta, dt)])
    return cv.one("Add", [mm, bn])


def _conv(cv, x, w, bias, stride, padding, dilation, transposed, groups):
    if transposed:
        raise UnsupportedOp("transposed conv (lhs_dilation>1)")
    nsp = _meta(x).dim() - 2
    padding = list(padding) * (nsp if len(padding) == 1 else 1)
    attrs = {"strides": [int(s) for s in stride] * (nsp if len(stride) == 1 else 1),
             "pads": [int(p) for p in padding] * 2,
             "dilations": [int(d) for d in dilation] * (nsp if len(dilation) == 1 else 1),
             "group": int(groups)}
    ins = [cv.name_of(x), cv.name_of(w)] + ([cv.name_of(bias)] if bias is not None else [])
    return cv.one("Conv", ins, attrs)


def _h_convolution(cv, node, x, w, b, stride, padding, dilation, transposed, output_padding,
                   groups):
    return _conv(cv, x, w, b, stride, padding, dilation, transposed, groups)


def _h_ieee_convolution(cv, node, x, w, stride, padding, dilation, transposed, output_padding,
                        groups):
    return _conv(cv, x, w, None, stride, padding, dilation, transposed, groups)


def _pool_attrs(x, kernel, stride, padding, dilation=1, ceil_mode=False):
    nsp = _meta(x).dim() - 2

    def per_axis(v):
        v = [int(v)] if isinstance(v, int) else [int(a) for a in v]
        return v * nsp if len(v) == 1 else v

    k = per_axis(kernel)
    s = per_axis(stride) if stride else k
    p = per_axis(padding)
    if ceil_mode:
        raise UnsupportedOp("ceil_mode pooling")
    if any(d != 1 for d in per_axis(dilation)):
        raise UnsupportedOp("dilated pooling")
    return {"kernel_shape": k, "strides": s, "pads": p + p}


def _h_maxpool(cv, node, x, kernel, stride=(), padding=0, dilation=1, ceil_mode=False):
    attrs = _pool_attrs(x, kernel, stride, padding, dilation, ceil_mode)
    return [cv.one("MaxPool", [cv.name_of(x)], attrs), None]


def _h_avgpool(cv, node, x, kernel, stride=(), padding=0, ceil_mode=False,
               count_include_pad=True, divisor_override=None):
    attrs = _pool_attrs(x, kernel, stride, padding, 1, ceil_mode)
    if divisor_override is not None or (not count_include_pad and any(attrs["pads"])):
        raise UnsupportedOp("avg_pool without count_include_pad over padding, or with a divisor")
    attrs["count_include_pad"] = 1
    return cv.one("AveragePool", [cv.name_of(x)], attrs)


def _h_adaptive_avgpool(cv, node, x, output_size):
    ins = list(_meta(x).shape[2:])
    outs = [int(o) for o in output_size]
    if any(i % o for i, o in zip(ins, outs)):
        raise UnsupportedOp(f"adaptive avg pool {ins} -> {outs} (only even divisions)")
    k = [i // o for i, o in zip(ins, outs)]
    return cv.one("AveragePool", [cv.name_of(x)],
                  {"kernel_shape": k, "strides": k, "pads": [0] * (2 * len(k)),
                   "count_include_pad": 1})


def _axes(x, dims):
    nd = _meta(x).dim()
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        return list(range(nd))
    dims = [dims] if isinstance(dims, int) else dims
    return [int(d) % nd for d in dims]


def _reduce(op_type):
    def h(cv, node, x, dims=None, keepdim=False, **kw):
        return cv.one(op_type, [cv.cast(cv.name_of(x), _meta(x).dtype, _meta(node).dtype)],
                      {"axes": _axes(x, dims), "keepdims": int(bool(keepdim))})
    return h


def _h_mean(cv, node, x, dims=None, keepdim=False, dtype=None):
    dt = _meta(node).dtype
    axes = _axes(x, dims)
    s = cv.one("ReduceSum", [cv.cast(cv.name_of(x), _meta(x).dtype, dt)],
               {"axes": axes, "keepdims": int(bool(keepdim))})
    count = int(np.prod([_meta(x).shape[a] for a in axes]))
    return cv.one("Div", [s, cv.scalar(count, dt)])


def _h_argminmax(op_type):
    def h(cv, node, x, dim=None, keepdim=False):
        if dim is None:
            raise UnsupportedOp(f"{op_type} over all axes")
        res = cv.one(op_type, [cv.name_of(x)],
                     {"axis": int(dim) % _meta(x).dim(), "keepdims": int(bool(keepdim))})
        return cv.cast(res, torch.int64, _meta(node).dtype)
    return h


def _softmax_chain(cv, xn, shape, dim, dtype):
    """The softmax as the reference's trace emits it: ReduceMax, its
    broadcast, Sub, Exp, ReduceSum, its broadcast, Div. -> (probs, max
    name, sum name)."""
    keep = list(shape)
    keep[dim] = 1
    m = cv.one("ReduceMax", [xn], {"axes": [dim], "keepdims": 0})
    mb = cv.one("Reshape", [m, cv.i64(keep)])
    e = cv.one("Exp", [cv.one("Sub", [xn, mb])])
    s = cv.one("ReduceSum", [e], {"axes": [dim], "keepdims": 0})
    sb = cv.one("Reshape", [s, cv.i64(keep)])
    return cv.one("Div", [e, sb]), mb, sb


def _h_softmax(cv, node, x, dim, half_to_float=False):
    dt = _meta(node).dtype
    nd = _meta(x).dim()
    xn = cv.cast(cv.name_of(x), _meta(x).dtype, dt)
    return _softmax_chain(cv, xn, _meta(x).shape, dim % nd, dt)[0]


def _h_log_softmax(cv, node, x, dim, half_to_float=False):
    dt = _meta(node).dtype
    nd = _meta(x).dim()
    xn = cv.cast(cv.name_of(x), _meta(x).dtype, dt)
    _, mb, sb = _softmax_chain(cv, xn, _meta(x).shape, dim % nd, dt)
    return cv.one("Sub", [cv.one("Sub", [xn, mb]), cv.one("Log", [sb])])


def _h_layer_norm(cv, node, x, normalized_shape, weight, bias, eps):
    dt = _meta(x).dtype
    nd = _meta(x).dim()
    axes = list(range(nd - len(normalized_shape), nd))
    keep = list(_meta(x).shape)
    for a in axes:
        keep[a] = 1
    count = int(np.prod([_meta(x).shape[a] for a in axes]))
    xn = cv.name_of(x)

    def mean(v):
        s = cv.one("ReduceSum", [v], {"axes": axes, "keepdims": 0})
        return cv.one("Reshape", [cv.one("Div", [s, cv.scalar(count, dt)]), cv.i64(keep)])

    mu = mean(xn)
    d = cv.one("Sub", [xn, mu])
    var = mean(cv.one("Mul", [d, d]))
    rstd = cv.one("Reciprocal", [cv.one("Sqrt", [cv.one("Add", [var, cv.scalar(eps, dt)])])])
    out = cv.one("Mul", [d, rstd])
    if weight is not None:
        out = cv.one("Mul", [out, cv.name_of(weight)])
    if bias is not None:
        out = cv.one("Add", [out, cv.name_of(bias)])
    return [out, mu, rstd]


def _h_batch_norm_eval(cv, node, x, weight, bias, mean, var, momentum, eps):
    c = _meta(x).shape[1]
    view = [1, c] + [1] * (_meta(x).dim() - 2)
    known = all(t is None or t in cv._vals for t in (weight, bias, mean, var))
    if known:  # fold into one scale and shift, as the reference's trace does
        rv = cv._vals[var]
        scale = torch.rsqrt(rv + eps)
        if weight is not None:
            scale = scale * cv._vals[weight]
        shift = -cv._vals[mean] * scale
        if bias is not None:
            shift = shift + cv._vals[bias]
        out = cv.one("Mul", [cv.name_of(x), cv.add_init(_host(scale.reshape(view)))])
        out = cv.one("Add", [out, cv.add_init(_host(shift.reshape(view)))])
        return [out, None, None]
    raise UnsupportedOp("batch norm with statistics computed in the graph")


def _h_flash_attention(cv, node, q, k, v, seed, scale, causal, dropout_p, k_len=None,
                       heads=1):
    """K1 as the plain attention chain (module docstring)."""
    if dropout_p > 0.0:
        raise UnsupportedOp("K1 with dropout (train mode): export an eval-mode layer")
    if k_len is not None:
        raise UnsupportedOp("K1's length form (k_len)")
    dt = _meta(q).dtype
    bh, sq, _ = _meta(q).shape
    sk = _meta(k).shape[1]
    kt = cv.one("Transpose", [cv.name_of(k)], {"perm": [0, 2, 1]})
    s = cv.one("Mul", [cv.one("MatMul", [cv.name_of(q), kt]), cv.scalar(scale, dt)])
    if causal:
        keep = np.tril(np.ones((sq, sk), bool), sk - sq)
        s = cv.one("Where", [cv.add_init(keep), s, cv.scalar(np.finfo(np.float32).min, dt)])
    p, mb, sb = _softmax_chain(cv, s, [bh, sq, sk], 2, dt)
    o = cv.one("MatMul", [p, cv.name_of(v)])
    if not any(u.target is operator.getitem and u.args[1] == 1 for u in node.users):
        return [o, None]  # the LSE is read only by the training step
    return [o, cv.one("Add", [mb, cv.one("Log", [sb])])]


def _h_wq_matmul(cv, node, x, w, scale):
    """wq_matmul as the reference's Int8Linear exports: the weight to
    float32, times its per-column scale, then MatMul."""
    wd = cv.cast(cv.name_of(w), _meta(w).dtype, torch.float32)
    if scale is not None:
        wd = cv.one("Mul", [wd, cv.name_of(scale)])
    return cv.one("MatMul", [cv.name_of(x), wd])


_HANDLERS = {
    "aten.add.Tensor": _h_add, "aten.add.Scalar": _h_add,
    "aten.sub.Tensor": _h_sub, "aten.sub.Scalar": _h_sub,
    "aten.mul.Tensor": _elementwise("Mul"), "aten.mul.Scalar": _elementwise("Mul"),
    "aten.div.Tensor": _elementwise("Div"), "aten.div.Scalar": _elementwise("Div"),
    "aten.div.Tensor_mode": _h_div_mode,
    "aten.maximum.default": _elementwise("Max"), "aten.minimum.default": _elementwise("Min"),
    "aten.pow.Tensor_Scalar": _h_pow, "aten.pow.Tensor_Tensor": _h_pow,
    "aten.fmod.Tensor": lambda cv, node, a, b: cv.add_node(
        "Mod", [cv.operand(a, _meta(node).dtype), cv.operand(b, _meta(node).dtype)],
        attrs={"fmod": 1})[0],
    "aten.neg.default": _unary("Neg"), "aten.exp.default": _unary("Exp"),
    "aten.log.default": _unary("Log"), "aten.tanh.default": _unary("Tanh"),
    "aten.sigmoid.default": _unary("Sigmoid"), "aten.sqrt.default": _unary("Sqrt"),
    "aten.abs.default": _unary("Abs"), "aten.sign.default": _unary("Sign"),
    "aten.floor.default": _unary("Floor"), "aten.ceil.default": _unary("Ceil"),
    "aten.round.default": _unary("Round"), "aten.erf.default": _unary("Erf"),
    "aten.reciprocal.default": _unary("Reciprocal"), "aten.rsqrt.default": _h_rsqrt,
    "aten.logical_not.default": _unary("Not"), "aten.bitwise_not.default": _unary("Not"),
    "aten.relu.default": _h_relu, "aten.gelu.default": _h_gelu,
    "aten.clamp.default": _h_clamp,
    "aten.hardtanh.default": lambda cv, node, x, lo=-1.0, hi=1.0: _h_clamp(cv, node, x, lo, hi),
    "aten.eq.Tensor": _compare("Equal"), "aten.eq.Scalar": _compare("Equal"),
    "aten.ne.Tensor": _compare("Equal", True), "aten.ne.Scalar": _compare("Equal", True),
    "aten.gt.Tensor": _compare("Greater"), "aten.gt.Scalar": _compare("Greater"),
    "aten.lt.Tensor": _compare("Less"), "aten.lt.Scalar": _compare("Less"),
    "aten.ge.Tensor": _ge_le("GreaterOrEqual"), "aten.ge.Scalar": _ge_le("GreaterOrEqual"),
    "aten.le.Tensor": _ge_le("LessOrEqual"), "aten.le.Scalar": _ge_le("LessOrEqual"),
    "aten.logical_and.default": _compare("And"), "aten.logical_or.default": _compare("Or"),
    "aten.logical_xor.default": _compare("Xor"),
    "aten.bitwise_and.Tensor": _compare("And"), "aten.bitwise_or.Tensor": _compare("Or"),
    "aten.where.self": _h_where, "aten.masked_fill.Scalar": _h_masked_fill,
    "aten.masked_fill.Tensor": _h_masked_fill,
    "aten._to_copy.default": _h_to_copy, "aten.clone.default": _h_identity,
    "aten.alias.default": _h_identity, "aten.detach.default": _h_identity,
    "aten.lift_fresh_copy.default": _h_identity, "aten.contiguous.default": _h_identity,
    "aten.view.default": _h_reshape, "aten._unsafe_view.default": _h_reshape,
    "aten.reshape.default": _h_reshape, "aten.squeeze.dim": _h_reshape,
    "aten.squeeze.dims": _h_reshape, "aten.squeeze.default": _h_reshape,
    "aten.unsqueeze.default": _h_reshape, "aten.flatten.using_ints": _h_reshape,
    "aten.expand.default": _h_expand, "aten.permute.default": _h_permute,
    "aten.t.default": _h_t, "aten.transpose.int": _h_transpose,
    "aten.slice.Tensor": _h_slice, "aten.select.int": _h_select,
    "aten.cat.default": _h_cat, "aten.split_with_sizes.default": _h_split_with_sizes,
    "aten.split.Tensor": _h_split, "aten.index_select.default": _h_index_select,
    "aten.embedding.default": _h_embedding, "aten.index.Tensor": _h_index,
    "aten.mm.default": _h_mm, "aten.bmm.default": _h_mm, "aten.matmul.default": _h_mm,
    "aten.addmm.default": _h_addmm,
    "aten.convolution.default": _h_convolution,
    "paddle_tpu_torch.ieee_convolution.default": _h_ieee_convolution,
    "aten.max_pool2d_with_indices.default": _h_maxpool,
    "aten.avg_pool2d.default": _h_avgpool,
    "aten._adaptive_avg_pool2d.default": _h_adaptive_avgpool,
    "aten.sum.dim_IntList": _reduce("ReduceSum"), "aten.sum.default": _reduce("ReduceSum"),
    "aten.amax.default": _reduce("ReduceMax"), "aten.amin.default": _reduce("ReduceMin"),
    "aten.prod.dim_int": _reduce("ReduceProd"),
    "aten.mean.dim": _h_mean, "aten.mean.default": _h_mean,
    "aten.argmax.default": _h_argminmax("ArgMax"), "aten.argmin.default": _h_argminmax("ArgMin"),
    "aten._softmax.default": _h_softmax, "aten._log_softmax.default": _h_log_softmax,
    "aten.native_layer_norm.default": _h_layer_norm,
    "aten._native_batch_norm_legit_no_training.default": _h_batch_norm_eval,
    "paddle_tpu_torch.flash_attention_fwd.default": _h_flash_attention,
    "paddle_tpu_torch.wq_matmul.default": _h_wq_matmul,
}
