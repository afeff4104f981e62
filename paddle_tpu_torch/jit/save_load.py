"""jit.save / jit.load (counterpart of paddle_tpu/jit/save_load.py;
reference: dygraph/jit.py save, dygraph/io.py TranslatedLayer).

The format: ``<prefix>.pdmodel``, a serialized ``torch.export`` program
(serialize/export.py; the reference writes StableHLO), ``.pdiparams``, the
reference's npz of the weights array for array (``p:raw:<name>``,
``b:raw:<name>``, bfloat16 as ``p:bf16:<name>`` uint16 words, never
pickle), and ``.pdmeta.json`` with the reference's keys and ``format:
"torch.export"``. The program is ``infer_fn(param_list, buffer_list,
*inputs)``: the weights are runtime inputs, never baked in, so its bytes
(and the fingerprint over them) do not depend on their values.

``None``/-1 dims export as ``torch.export.Dim``s (dim 0 shared across the
inputs first, then independent), captured at size 2 (torch specialises
sizes 0 and 1); if no symbolic export succeeds they are pinned to 1, and
if that fails too the save is ``format: "params-only"`` and ``load``
raises. ``load`` puts the program and the weights on the current place
(``move_to_device_pass``), so a save made on the CPU runs on the card. A
save of the JAX package (``format: "stablehlo"``) is refused by name.

``TranslatedLayer`` runs a batch-polymorphic program in slabs of
``slab_rows`` rows (the last padded with zero rows, sliced off after),
so every call of the program has one row count: cuBLAS picks its GEMM
per M, and a row served in any batch then keeps the bits of its direct
call (inference/batching.py).

``save(mesh=)`` records a serving mesh (inference/sharding.py) and leaves
the program alone. The engines serve a mesh through
:class:`ShardedTranslatedLayer`: the weights cut into blocks once, at
load, and the program rewritten once (:func:`shard_program`) so that its
products run per shard.
"""
import io as _io
import json
import os

import numpy as np
import torch

from ..core import place as place_mod
from ..core.dtype import _torch_dtype, dtype_name
from ..core.tensor import Parameter
from ..nn.layer import Layer
from ..serialize.export import deserialize_exported, model_fingerprint, serialize_exported
from .static_function import StaticFunction, capture

FORMAT = "torch.export"
#: rows of a symbolic dim when it is captured (torch specialises 0 and 1)
CAPTURE_ROWS = 2
#: the row count every batch-polymorphic program runs at, unless the
#: loader, ``Config.set_slab_rows`` or ``serve_model(slab_rows=)`` says
#: otherwise: the cheaper of 2 and the serving batch of 8 on an H100
#: (chip_smoke.py phase 18 measures both)
DEFAULT_SLAB_ROWS = 8


def _spec_entries(input_spec):
    """[(dims with None for symbolic, torch dtype)] of the InputSpecs and
    tensors of ``input_spec``."""
    from ..static import InputSpec

    entries = []
    for s in input_spec:
        if isinstance(s, InputSpec):
            dims = [None if d is None or d < 0 else int(d) for d in s.shape]
            entries.append((dims, _torch_dtype(s.dtype)))
        elif isinstance(s, torch.Tensor):
            entries.append((list(s.shape), s.dtype))
        else:
            raise TypeError(f"bad input_spec entry {s!r}")
    return entries


def _attempts(entries):
    """The export attempts in order: (example dims, dynamic_shapes or None,
    polymorphic). Symbolic dims shared at dim 0 first (the batching
    contract), then independent (several inputs only), then pinned to 1."""
    n_none = sum(d is None for dims, _ in entries for d in dims)
    if n_none == 0:
        return [([list(d) for d, _ in entries], None, False)]

    def symbolic(share_dim0):
        dims_by_name = {}
        shapes = []
        for i, (dims, _) in enumerate(entries):
            spec = {}
            for j, d in enumerate(dims):
                if d is None:
                    name = "b" if share_dim0 and j == 0 else f"d{i}_{j}"
                    if name not in dims_by_name:
                        dims_by_name[name] = torch.export.Dim(name, min=1)
                    spec[j] = dims_by_name[name]
            shapes.append(spec or None)
        example = [[CAPTURE_ROWS if d is None else d for d in dims] for dims, _ in entries]
        return example, shapes, True

    out = [symbolic(True)]
    if sum(1 for dims, _ in entries if dims and dims[0] is None) > 1:
        out.append(symbolic(False))
    out.append(([[1 if d is None else d for d in dims] for dims, _ in entries], None, False))
    return out


def _json_spec(dims, dtype):
    return [[None if d is None else int(d) for d in dims], dtype_name(dtype)]


def save(layer, path, input_spec=None, quant=None, quant_calib=None, mesh=None, **configs):
    """paddle.jit.save: export ``layer.forward`` at ``input_spec`` (see the
    module docstring). ``quant`` ("w8", "w8a8", "bf16w") quantizes the
    layer in place first (``quantization.serving.quantize_for_serving``)
    and is recorded and folded into the fingerprint; bf16w stores the
    float32 parameters as bfloat16 and the program upcasts them. ``mesh``
    records the serving mesh the save is meant for (its canonical
    descriptor, inference/sharding.py; a bad one raises ValueError here):
    the program does not change (the engines split the weights at load),
    and ``serve_model`` refuses a save whose recorded mesh contradicts the
    declared one, at load and at every reload."""
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (list of InputSpec or Tensors)")
    if mesh is not None:
        from ..inference.sharding import ServingMesh

        mesh = ServingMesh.parse(mesh).descriptor
    from ..quantization.serving import quantize_for_serving

    layer, quant_meta = quantize_for_serving(layer, quant, calib=quant_calib)
    quant = quant_meta["mode"] if quant_meta else None
    entries = _spec_entries(input_spec)
    layer.eval()
    params = dict(layer.named_parameters())
    buffers = dict(layer.named_buffers())
    if quant == "bf16w":
        params = {n: p.detach().to(torch.bfloat16) if p.dtype == torch.float32 else p.detach()
                  for n, p in params.items()}
    else:
        params = {n: p.detach() for n, p in params.items()}
    fwd = layer.forward
    if isinstance(fwd, StaticFunction):
        fwd = fwd._orig_fn
    device = next(iter(params.values())).device if params else place_mod.resolve_device(None)

    last_err, exported, spec_json, poly = None, None, None, False
    for example_dims, shapes, symbolic in _attempts(entries):
        example = [torch.zeros(dims, dtype=dt, device=device)
                   for dims, (_, dt) in zip(example_dims, entries)]
        try:
            with torch.no_grad():
                exported = capture(fwd, layer, tuple(example), {}, key_rows=None,
                                   dynamic_shapes=shapes, params=params,
                                   upcast_bf16=quant == "bf16w")[0]
        except Exception as e:  # noqa: BLE001 - the next attempt, or params-only
            last_err = e
            continue
        poly = symbolic
        spec_json = [_json_spec([None if (symbolic and d is None) else ed
                                 for d, ed in zip(dims, exd)], dt)
                     for (dims, dt), exd in zip(entries, example_dims)]
        last_err = None
        break
    write_artifacts(path, exported, params, {n: b.detach() for n, b in buffers.items()},
                    spec_json if exported is not None else
                    [_json_spec(dims, dt) for dims, dt in entries],
                    poly, quant=quant, quant_meta=quant_meta, mesh=mesh,
                    export_error=None if last_err is None else repr(last_err))


def _host(t):
    """A tensor as the npz stores it: (key encoding, ndarray)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return "bf16", t.view(torch.int16).numpy().view(np.uint16)
    return "raw", t.numpy()


def write_artifacts(path, exported, params, buffers, input_specs, polymorphic, quant=None,
                    quant_meta=None, mesh=None, export_error=None):
    """Write ``<path>.pdmodel`` (when ``exported`` is a program),
    ``.pdiparams`` and ``.pdmeta.json`` (the reference's keys)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    from ..framework import op_version

    fingerprint = None
    fmt = "params-only"
    if exported is not None:
        blob = serialize_exported(exported)
        with open(path + ".pdmodel", "wb") as f:
            f.write(blob)
        fmt = FORMAT
        fingerprint = model_fingerprint(blob, quant=quant)
    arrays = {}
    for prefix, d in (("p", params), ("b", buffers)):
        for n, t in d.items():
            enc, a = _host(t)
            arrays[f"{prefix}:{enc}:{n}"] = a
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    with open(path + ".pdiparams", "wb") as f:
        f.write(buf.getvalue())
    with open(path + ".pdmeta.json", "w") as f:
        json.dump({"format": fmt,
                   "input_specs": input_specs,
                   "polymorphic": bool(polymorphic) if exported is not None else False,
                   "fingerprint": fingerprint,
                   "op_versions": op_version.all_op_versions(),
                   "quant": quant,
                   "quant_meta": quant_meta,
                   "mesh": mesh,
                   "export_error": export_error}, f)


def _program_device(exported):
    """The device the program's first tensor input was captured on."""
    for node in exported.graph.nodes:
        val = node.meta.get("val") if node.op == "placeholder" else None
        if isinstance(val, torch.Tensor):
            return val.device
    return torch.device("cpu")


def _on_device(exported, device):
    if _program_device(exported) == device:
        return exported
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(exported, str(device))


class TranslatedLayer(Layer):
    """A loaded program (reference: dygraph/io.py TranslatedLayer): its
    weights as parameters ``p_<i>`` (``param_name`` the saved name) and
    buffers, ``_input_specs``, ``_polymorphic``, ``_model_fingerprint``,
    ``_quant_mode``, ``_serving_mesh``; ``forward`` runs the program on
    them (in slabs, module docstring)."""

    def __init__(self, exported, params, buffers, input_specs=None, polymorphic=False,
                 fingerprint=None, quant=None, mesh=None, slab_rows=None):
        super().__init__()
        self._exported = exported
        self._program = exported.module()
        self._loaded_buffers = dict(buffers)
        self._input_specs = input_specs or []
        self._polymorphic = bool(polymorphic)
        self._model_fingerprint = fingerprint
        self._quant_mode = quant
        self._serving_mesh = mesh
        self._slab_rows = int(slab_rows or DEFAULT_SLAB_ROWS)
        for i, (n, a) in enumerate(params.items()):
            self.add_parameter(f"p_{i}", Parameter(a, requires_grad=False, name=n))

    @property
    def device(self):
        for p in self._parameters.values():
            return p.device
        return _program_device(self._exported)

    def set_slab_rows(self, rows):
        """Run the program at ``rows`` rows a call from now on."""
        if int(rows) < 1:
            raise ValueError(f"slab_rows must be >= 1, got {rows}")
        self._slab_rows = int(rows)

    def to_device(self, device):
        """Put the weights, the buffers and the program on ``device`` once,
        so a run never moves them."""
        device = torch.device(device)
        for p in self._parameters.values():
            p.data = p.data.to(device)
        self._loaded_buffers = {n: b.to(device) for n, b in self._loaded_buffers.items()}
        self._exported = _on_device(self._exported, device)
        self._program = self._exported.module()

    def _call(self, inputs):
        params = list(self._parameters.values())
        with torch.no_grad():
            out = self._program(params, list(self._loaded_buffers.values()), *inputs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def run_slabs(self, inputs):
        """The program over ``inputs`` (torch tensors on the layer's device
        sharing dim 0), in slabs of ``slab_rows`` rows when it is batch
        polymorphic -> a tuple of outputs, each keeping dim 0."""
        if not self._polymorphic or not inputs:
            return self._call(inputs)
        rows, s = int(inputs[0].shape[0]), self._slab_rows
        parts = []
        for lo in range(0, rows, s):
            slab = [t[lo:lo + s] for t in inputs]
            n = int(slab[0].shape[0])
            if n < s:
                slab = [torch.cat([t, t.new_zeros((s - n,) + tuple(t.shape[1:]))]) for t in slab]
            outs = self._call(slab)
            for o in outs:
                if o.dim() == 0 or o.shape[0] != s:
                    raise ValueError(f"output of shape {tuple(o.shape)} does not keep the "
                                     f"{s}-row batch dim: a batch-polymorphic program's "
                                     "outputs must")
            parts.append([o[:n] for o in outs])
        if len(parts) == 1:
            return tuple(parts[0])
        return tuple(torch.cat([p[j] for p in parts]) for j in range(len(parts[0])))

    def forward(self, *inputs):
        dev = self.device
        tensors = [(i if isinstance(i, torch.Tensor) else torch.from_numpy(np.array(i))).to(dev)
                   for i in inputs]
        outs = self.run_slabs(tensors)
        return outs[0] if len(outs) == 1 else outs

    def program_graph(self):
        """The torch.fx graph one call runs (the compile ledger's ops)."""
        return self._exported.graph

    def sharded(self, placement):
        """This program over a serving mesh's ``placement``
        (inference/sharding.py): a :class:`ShardedTranslatedLayer`."""
        return ShardedTranslatedLayer(self, placement)


# the targets the sharding pass gives a rewritten node (module level: the
# generated code of a graph module calls them by name)
def sharded_matmul(x, w):
    """``x @ w``, per shard for a serving mesh's ShardedWeight."""
    from ..ops.quant_matmul import wmatmul

    return wmatmul(x, w)


def sharded_rows(w, idx):
    """``w[idx]``, gathered from the blocks of a ShardedWeight."""
    return w.rows(idx)


def joined_weight(w):
    """The whole weight of a ShardedWeight, for any other consumer."""
    return w.joined()


_ATEN = torch.ops.aten
_PRODUCTS = (_ATEN.matmul.default, _ATEN.mm.default)


def _last_dim(node, dim):
    rank = node.meta["val"].dim() if "val" in node.meta else 2
    return dim % rank == rank - 1


def shard_program(exported, sharded):
    """A copy of ``exported``'s flat graph module (inputs: the params,
    the buffers, the program's inputs) in which the params at positions
    ``sharded`` are serving-mesh ``ShardedWeight``s. Run once, at load:

    - ``aten.matmul``/``aten.mm`` with such a weight as the right operand
      becomes ``sharded_matmul`` (the products per shard);
    - a product over ``aten.cat`` of weights along their last dim (a fused
      QKV) becomes the cat of each weight's ``sharded_matmul``;
    - ``aten.index.Tensor`` of such a weight by one index tensor (an
      embedding lookup) becomes ``sharded_rows``;
    - every other consumer reads ``joined_weight`` of it, once a call."""
    import copy

    gm = copy.deepcopy(exported.graph_module)
    g = gm.graph
    placeholders = [n for n in g.nodes if n.op == "placeholder"]
    weights = {placeholders[i] for i in sharded}
    for node in list(g.nodes):
        if node.op != "call_function" or node.target not in _PRODUCTS:
            continue
        x, w = node.args[:2]
        if w in weights:
            node.target = sharded_matmul
        elif (isinstance(w, torch.fx.Node) and w.target is _ATEN.cat.default
              and any(a in weights for a in w.args[0])
              and all(isinstance(a, torch.fx.Node) and a.op == "placeholder" for a in w.args[0])
              and _last_dim(w, w.args[1] if len(w.args) > 1 else 0)):
            with g.inserting_before(node):
                parts = [g.call_function(sharded_matmul, (x, a)) for a in w.args[0]]
                joined = g.call_function(_ATEN.cat.default, (parts, -1))
            node.replace_all_uses_with(joined)
            g.erase_node(node)
            if not w.users:
                g.erase_node(w)
    for node in list(g.nodes):
        if (node.op == "call_function" and node.target is _ATEN.index.Tensor
                and node.args[0] in weights and len(node.args[1]) == 1
                and node.args[1][0] is not None):
            node.target = sharded_rows
            node.args = (node.args[0], node.args[1][0])
    # in placeholder order: under the rank backing a join is a collective,
    # and every rank must meet them in one order
    for p in [n for n in placeholders if n in weights]:
        others = [u for u in p.users
                  if not (u.target is sharded_matmul and u.args[1] is p)
                  and not (u.target is sharded_rows and u.args[0] is p)]
        if others:
            with g.inserting_before(next(n for n in g.nodes if n.op != "placeholder")):
                whole = g.call_function(joined_weight, (p,))
            for u in others:
                u.replace_input_with(p, whole)
    g.lint()
    gm.recompile()
    return gm


class ShardedTranslatedLayer(TranslatedLayer):
    """A loaded program over a serving mesh (the engines' sharded form):
    the weights as the ``placement`` holds them (``ShardedWeight``s and
    whole tensors on its first device; the source layer's parameters are
    not kept), the buffers on the first device, and the program rewritten
    once by :func:`shard_program`. It runs as a ``TranslatedLayer`` does,
    in slabs; K1 sees the joined q/k/v."""

    def __init__(self, layer, placement):
        Layer.__init__(self)
        first = placement.first
        self._placement = placement
        self._exported = _on_device(layer._exported, first)
        self._loaded_buffers = {n: b.to(first) for n, b in layer._loaded_buffers.items()}
        self._input_specs = layer._input_specs
        self._polymorphic = layer._polymorphic
        self._model_fingerprint = layer._model_fingerprint
        self._quant_mode = layer._quant_mode
        self._serving_mesh = layer._serving_mesh
        self._slab_rows = layer._slab_rows
        self._weights = [placement.shard(p.detach()) for p in layer._parameters.values()]
        self._program = shard_program(
            self._exported, [i for i, w in enumerate(self._weights)
                             if not isinstance(w, torch.Tensor)])
        self._out_spec = self._exported.call_spec.out_spec

    @property
    def device(self):
        return self._placement.first

    def to_device(self, device):
        raise NotImplementedError("a sharded program stays on its mesh's devices")

    def program_graph(self):
        return self._program.graph

    def _call(self, inputs):
        from torch.utils import _pytree

        with torch.no_grad():
            flat = self._program(*self._weights, *self._loaded_buffers.values(), *inputs)
        out = _pytree.tree_unflatten(list(flat), self._out_spec)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _split_arrays(npz, device):
    params, buffers = {}, {}
    for key in npz.files:
        prefix, enc, name = key.split(":", 2)
        arr = npz[key]
        # a writable C-contiguous copy where needed (ascontiguousarray would
        # make a 0-d array, a scalar buffer, 1-d)
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = arr.copy(order="C")
        if enc == "bf16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        (params if prefix == "p" else buffers)[name] = t.to(device)
    return params, buffers


def load(path, device=None, slab_rows=None, **configs):
    """paddle.jit.load: a TranslatedLayer of the saved program on
    ``device`` (default: the current place). ``slab_rows``: its slab (see
    the module docstring)."""
    with open(path + ".pdmeta.json") as f:
        payload = json.load(f)
    fmt = payload.get("format")
    if fmt == "stablehlo":
        raise RuntimeError(f"model at {path} is a 'stablehlo' save (the JAX package's "
                           "jax.export program): the port loads 'torch.export' saves only; "
                           "re-save it with paddle_tpu_torch.jit.save")
    if fmt != FORMAT or not os.path.exists(path + ".pdmodel"):
        raise RuntimeError(f"model at {path} was saved without a serialized program "
                           f"({payload.get('export_error')}); re-save with a supported spec")
    device = place_mod.resolve_device(device)
    from ..framework import op_version

    op_version.check_compat(payload.get("op_versions"), where=path)
    # allow_pickle stays False (np.load's default): params may be untrusted
    with np.load(path + ".pdiparams") as npz:
        params, buffers = _split_arrays(npz, device)
    with open(path + ".pdmodel", "rb") as f:
        blob = f.read()
    exported = _on_device(deserialize_exported(blob), device)
    quant = payload.get("quant")
    return TranslatedLayer(exported, params, buffers,
                           input_specs=payload.get("input_specs", []),
                           polymorphic=payload.get("polymorphic", False),
                           fingerprint=model_fingerprint(blob, quant=quant), quant=quant,
                           mesh=payload.get("mesh"), slab_rows=slab_rows)
