"""Minimal numpy evaluator for models produced by the ONNX exporters (a
copy of paddle_tpu/onnx/runner.py), a host-side checker.

Serves two purposes: (1) closes the loop in tests — export → parse the
serialized bytes → execute with numpy → compare against the live model,
proving both the wire encoding and the op semantics; (2) gives users a
dependency-free way to sanity-check an exported model when onnxruntime
isn't installed. Covers exactly the op set the exporter emits.
"""
import math

import numpy as np

from . import wire

_erf = np.vectorize(math.erf, otypes=[np.float64])


def load(path_or_bytes):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return wire.parse_model(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return wire.parse_model(f.read())


def run(model, feeds):
    """Execute a parsed model dict; feeds: {input_name: ndarray}.
    Returns the list of graph outputs."""
    g = model["graph"] if "graph" in model else model
    values = dict(g["initializers"])
    for inp in g["inputs"]:
        if inp["name"] not in feeds:
            raise KeyError(f"missing feed '{inp['name']}'")
        values[inp["name"]] = np.asarray(feeds[inp["name"]])
    for node in g["nodes"]:
        op = node["op_type"]
        fn = _OPS.get(op)
        if fn is None:
            raise NotImplementedError(f"numpy runner: ONNX op {op}")
        ins = [values[n] for n in node["input"]]
        outs = fn(ins, node["attrs"])
        if not isinstance(outs, (tuple, list)):
            outs = [outs]
        for name, arr in zip(node["output"], outs):
            values[name] = np.asarray(arr)
    return [values[o["name"]] for o in g["outputs"]]


def _unary(fn):
    return lambda ins, attrs: fn(ins[0])


def _binary(fn):
    return lambda ins, attrs: fn(ins[0], ins[1])


def _reduce(fn):
    def h(ins, attrs):
        axes = tuple(int(a) for a in attrs.get("axes", []))
        keep = bool(attrs.get("keepdims", 1))
        return fn(ins[0], axis=axes or None, keepdims=keep)
    return h


def _argreduce(fn):
    def h(ins, attrs):
        axis = int(attrs.get("axis", 0))
        res = fn(ins[0], axis=axis).astype(np.int64)
        if attrs.get("keepdims", 1):
            res = np.expand_dims(res, axis)
        return res
    return h


def _matmul(ins, attrs):
    a, b = ins
    return np.matmul(a, b)


def _conv(ins, attrs):
    x, w = ins[0], ins[1]
    bias = ins[2] if len(ins) > 2 else None
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1])]
    group = int(attrs.get("group", 1))
    pads = [int(p) for p in attrs.get("pads", [0] * 4)]
    nsp = x.ndim - 2
    pad_width = [(0, 0), (0, 0)] + [(pads[i], pads[i + nsp])
                                    for i in range(nsp)]
    xp = np.pad(x, pad_width)
    n, cin = x.shape[:2]
    cout = w.shape[0]
    ksp = w.shape[2:]
    osp = [(xp.shape[2 + i] - (ksp[i] - 1) * dil[i] - 1) // strides[i] + 1
           for i in range(nsp)]
    out = np.zeros([n, cout] + osp, dtype=np.result_type(x, w))
    cin_g, cout_g = cin // group, cout // group
    for g in range(group):
        xg = xp[:, g * cin_g:(g + 1) * cin_g]
        wg = w[g * cout_g:(g + 1) * cout_g]
        for idx in np.ndindex(*osp):
            sl = tuple(
                slice(idx[i] * strides[i],
                      idx[i] * strides[i] + (ksp[i] - 1) * dil[i] + 1,
                      dil[i]) for i in range(nsp))
            patch = xg[(slice(None), slice(None)) + sl]  # [N,Cg,*k]
            out[(slice(None), slice(g * cout_g, (g + 1) * cout_g)) + idx] = \
                np.einsum("nck,ock->no",
                          patch.reshape(patch.shape[0], patch.shape[1], -1),
                          wg.reshape(wg.shape[0], wg.shape[1], -1))
    if bias is not None:
        out += bias.reshape([1, cout] + [1] * nsp)
    return out


def _pool(reducer, init):
    def h(ins, attrs):
        x = ins[0]
        k = [int(v) for v in attrs["kernel_shape"]]
        strides = [int(v) for v in attrs.get("strides", [1] * len(k))]
        pads = [int(p) for p in attrs.get("pads", [0] * (2 * len(k)))]
        nsp = len(k)
        pad_width = [(0, 0), (0, 0)] + [(pads[i], pads[i + nsp])
                                        for i in range(nsp)]
        xp = np.pad(x, pad_width, constant_values=init)
        osp = [(xp.shape[2 + i] - k[i]) // strides[i] + 1
               for i in range(nsp)]
        out = np.zeros(list(x.shape[:2]) + osp, dtype=x.dtype)
        for idx in np.ndindex(*osp):
            sl = tuple(slice(idx[i] * strides[i],
                             idx[i] * strides[i] + k[i])
                       for i in range(nsp))
            patch = xp[(slice(None), slice(None)) + sl]
            out[(slice(None), slice(None)) + idx] = reducer(
                patch.reshape(patch.shape[0], patch.shape[1], -1), -1)
        return out
    return h


def _avgpool(ins, attrs):
    # count_include_pad=1 average (what the exporter emits)
    summed = _pool(np.sum, 0.0)(ins, attrs)
    return summed / float(np.prod([int(v) for v in attrs["kernel_shape"]]))


def _slice(ins, attrs):
    x, starts, ends, axes, steps = (list(ins) + [None, None])[:5]
    starts = [int(v) for v in starts]
    ends = [int(v) for v in ends]
    axes = [int(v) for v in axes] if axes is not None \
        else list(range(len(starts)))
    steps = [int(v) for v in steps] if steps is not None \
        else [1] * len(starts)
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        lo = None if (sp < 0 and en < -x.shape[ax]) else en
        sl[ax] = slice(st, lo, sp)
    return x[tuple(sl)]


def _pad(ins, attrs):
    x, pads = ins[0], [int(p) for p in ins[1]]
    value = ins[2] if len(ins) > 2 else 0.0
    n = x.ndim
    pad_width = [(pads[i], pads[i + n]) for i in range(n)]
    return np.pad(x, pad_width, constant_values=np.asarray(value).item())


def _cast(ins, attrs):
    return ins[0].astype(wire.np_dtype(int(attrs["to"])))


def _expand(ins, attrs):
    shape = [int(s) for s in ins[1]]
    return np.broadcast_to(ins[0],
                           np.broadcast_shapes(ins[0].shape, tuple(shape)))


def _erf_like(x):
    return _erf(x).astype(x.dtype if x.dtype.kind == "f" else np.float32)


_OPS = {
    "Identity": _unary(lambda x: x),
    "Neg": _unary(np.negative), "Exp": _unary(np.exp), "Log": _unary(np.log),
    "Tanh": _unary(np.tanh),
    "Sigmoid": _unary(lambda x: 1.0 / (1.0 + np.exp(-x))),
    "Sqrt": _unary(np.sqrt), "Abs": _unary(np.abs), "Sign": _unary(np.sign),
    "Floor": _unary(np.floor), "Ceil": _unary(np.ceil),
    "Round": _unary(np.round), "Erf": _unary(_erf_like),
    "Reciprocal": _unary(np.reciprocal), "Not": _unary(np.logical_not),
    "Add": _binary(np.add), "Sub": _binary(np.subtract),
    # integer Div truncates toward zero (C semantics, as the ONNX spec
    # says) — numpy // floors instead
    "Mul": _binary(np.multiply), "Div": _binary(
        lambda a, b: (np.trunc(np.divide(a, b)).astype(a.dtype)
                      if a.dtype.kind in "iu" else a / b)),
    "Max": _binary(np.maximum), "Min": _binary(np.minimum),
    "Pow": _binary(np.power),
    "Mod": lambda ins, attrs: (np.fmod if attrs.get("fmod") else np.mod)(
        ins[0], ins[1]),
    "Greater": _binary(np.greater), "Less": _binary(np.less),
    "GreaterOrEqual": _binary(np.greater_equal),
    "LessOrEqual": _binary(np.less_equal), "Equal": _binary(np.equal),
    "And": _binary(np.logical_and), "Or": _binary(np.logical_or),
    "Xor": _binary(np.logical_xor),
    "ReduceSum": _reduce(np.sum), "ReduceMax": _reduce(np.max),
    "ReduceMin": _reduce(np.min), "ReduceProd": _reduce(np.prod),
    "ArgMax": _argreduce(np.argmax), "ArgMin": _argreduce(np.argmin),
    "MatMul": _matmul, "Conv": _conv,
    "MaxPool": _pool(np.max, -np.inf), "AveragePool": _avgpool,
    "Transpose": lambda ins, attrs: np.transpose(
        ins[0], [int(p) for p in attrs["perm"]]),
    "Reshape": lambda ins, attrs: ins[0].reshape(
        [int(s) for s in ins[1]]),
    "Expand": _expand,
    "Concat": lambda ins, attrs: np.concatenate(
        ins, axis=int(attrs["axis"])),
    "Slice": _slice, "Pad": _pad, "Cast": _cast,
    "Split": lambda ins, attrs: np.split(
        ins[0], np.cumsum([int(s) for s in attrs["split"]])[:-1],
        axis=int(attrs.get("axis", 0))),
    "Where": lambda ins, attrs: np.where(ins[0], ins[1], ins[2]),
    "Gather": lambda ins, attrs: np.take(
        ins[0], ins[1].astype(np.int64), axis=int(attrs.get("axis", 0))),
    "Clip": lambda ins, attrs: np.clip(ins[0], ins[1], ins[2]),
}
