"""Quantized serving modes (counterpart of
paddle_tpu/quantization/serving.py)::

    mode    weights                          activations    accumulate
    w8      int8 + per-channel f32 scales    f32            f32
    w8a8    as w8                            quantize-      f32
                                             dequantized at
                                             the calibrated
                                             abs-max
    bf16w   bf16                             f32            f32

The stored and streamed weights are the reduced arrays; the computation
stays float32. The reference dequantizes into f32 and lets XLA fuse that
into each product's read of the weights; the port's Llama decode runs its
products through the hand-written dequantizing kernel
(ops/quant_matmul.py ``wq_matmul``) instead, so no f32 copy of a weight
is ever written. A generic ``DecodeModel`` (a flat param list) holds the
reference's reduced flat list, and its functions are wrapped. On the CPU
the wrapper is the reference's: the params dequantized to f32 on every
call. On the card it hands the functions each quantized matrix as a
``QuantWeight``, which ``x @ w``, ``torch.matmul`` and ``w[idx]`` run
through ``wq_matmul`` and a gather of the rows, and which any other use
refuses (a TypeError): the card never writes an f32 copy of a weight.

``ACCURACY_BOUNDS`` are the reference's documented per-mode bounds on
``max|logits - logits_f32| / max|logits_f32|``. Greedy decode under a mode
is not bitwise the f32 model's; the quantized contract is f32's: a
sequence decoded in a batch emits exactly its own solo tokens, per mode.

Not ported: the export half of ``quantize_for_serving`` (``jit.save``,
the ``.pdmeta.json`` sidecar); its in-place half is here and returns the
sidecar's meta.
"""
import torch

from ..ops.quant_matmul import QuantWeight

QUANT_MODES = ("w8", "w8a8", "bf16w")

#: the reference's per-mode relative-error bounds of the accuracy contract
ACCURACY_BOUNDS = {"w8": 5e-2, "w8a8": 1e-1, "bf16w": 5e-2}


def check_mode(quant):
    """A quant mode's canonical form: None for f32 (``None`` or "f32"), the
    mode for one of ``QUANT_MODES``; anything else raises ValueError."""
    if quant in (None, "f32"):
        return None
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}; expected one of {QUANT_MODES} "
                         "(or 'f32'/None)")
    return quant


def detect_mode(layer):
    """The quant mode already baked into a module tree (an ``Int8Linear``
    with an activation scale is w8a8, without one w8), or None."""
    from .post_training import Int8Linear

    mode = None
    for _, sub in layer.named_modules():
        if isinstance(sub, Int8Linear):
            if sub.act_scale is not None:
                return "w8a8"
            mode = "w8"
    return mode


def quantize_for_serving(layer, quant, calib=None):
    """Apply a serving quant mode to a module IN PLACE -> (layer, meta),
    ``meta`` the JSON-able record the reference's sidecar stores (None for
    f32). w8: every Linear becomes an Int8Linear; w8a8: also calibrates
    activation scales over ``calib`` (a sample generator) and bakes them
    in; bf16w: no layer surgery (the reference casts at export). A tree
    already carrying a mode keeps it (``quant`` None or the same), and a
    different mode raises."""
    quant = check_mode(quant)
    baked = detect_mode(layer)
    if baked is not None:
        if quant not in (None, baked):
            raise ValueError(f"layer already carries {baked!r}-quantized sublayers; it cannot "
                             f"be re-saved as {quant!r} — re-instantiate the float model to "
                             "change modes")
        return layer, {"mode": baked, "detected": True}
    if quant is None:
        return layer, None
    meta = {"mode": quant}
    if quant == "bf16w":
        return layer, meta
    from .post_training import PostTrainingQuantization

    if quant == "w8a8":
        if calib is None:
            raise ValueError("quant='w8a8' needs calibration data: pass quant_calib=<sample "
                             "generator> (a callable yielding input batches)")
        ptq = PostTrainingQuantization(layer, sample_generator=calib)
        ptq.quantize(act_quant=True)
        meta["act_scales"] = {k: float(v) for k, v in ptq.activation_scales.items()}
    else:
        ptq = PostTrainingQuantization(layer)
        ptq.quantize()
    meta["weight_scale_layers"] = sorted(ptq.weight_scales)
    return layer, meta


def _w8_plan(params):
    """Per-param plan for a flat param list: ``("w8", q_int8, scale)`` for
    a float32 tensor of 2 or more dims (scales per channel of the last
    axis, the out axis of every [in, out] matrix, the embedding's
    [vocab, hidden] too), ``("raw", tensor)`` for everything else."""
    from .post_training import _quantize_array

    plan = []
    for p in params:
        t = torch.as_tensor(p)
        if t.dtype == torch.float32 and t.dim() >= 2:
            q, s = _quantize_array(t, channel_axis=t.dim() - 1)
            plan.append(("w8", q, s))
        else:
            plan.append(("raw", t))
    return plan


def _flat_params(params, quant):
    """A flat param list in ``quant`` -> (the reduced list, its ``unpack``
    back to f32, its ``weights`` form), the reference's: bf16w casts every
    float32 param to bf16; w8 replaces each float32 matrix by two entries,
    int8 and scales. ``weights`` gives the list the functions see on the
    card: each reduced matrix a ``QuantWeight``, a bf16w vector upcast to
    f32 (as ``unpack``), everything else as it is."""
    if quant == "bf16w":
        reduced = [torch.as_tensor(p).to(torch.bfloat16)
                   if torch.as_tensor(p).dtype == torch.float32 else p for p in params]

        def unpack(param_list):
            return [p.float() if p.dtype == torch.bfloat16 else p for p in param_list]

        def weights(param_list):
            return [QuantWeight(p) if p.dtype == torch.bfloat16 and p.dim() >= 2
                    else p.float() if p.dtype == torch.bfloat16 else p for p in param_list]

        return reduced, unpack, weights
    reduced, layout = [], []  # "w8" takes two flat entries, "raw" one
    for entry in _w8_plan(params):
        reduced.extend(entry[1:])
        layout.append(entry[0])

    def regroup(param_list, matrix):
        out, i = [], 0
        for kind in layout:
            if kind == "w8":
                out.append(matrix(param_list[i], param_list[i + 1]))
                i += 2
            else:
                out.append(param_list[i])
                i += 1
        return out

    def unpack(param_list):
        return regroup(param_list, lambda q, s: q.float() * s)

    def weights(param_list):
        return regroup(param_list, QuantWeight)

    return reduced, unpack, weights


def quantize_decode_model(model, quant):
    """A NEW ``DecodeModel`` serving ``model``'s computation under a quant
    mode ("w8" or "bf16w"; None/"f32" returns ``model``), carrying
    ``quant``. A model already quantized, and w8a8 (an export-time mode),
    raise ValueError. The draft is not carried over (the engine quantizes
    it beside the target).

    Llama's weights (``llama_decode_model``'s ``_LlamaWeights``) become the
    same weights in the mode, under the same fill and step functions,
    whose products then run the dequantizing kernel. A flat param list is
    the reference's: w8 makes each float32 matrix an (int8, f32 scale)
    pair of entries, bf16w casts every float32 param to bf16. Its
    functions are wrapped: on the CPU they get the params dequantized to
    f32 per call (the reference's plain path); on the card they get each
    reduced matrix as a ``QuantWeight`` (the module docstring), and params
    off the card raise RuntimeError."""
    from ..inference.decode import DecodeModel

    quant = check_mode(quant)
    if quant is None:
        return model
    if getattr(model, "quant", None) is not None:
        raise ValueError(f"model is already quantized (mode {model.quant!r})")
    if quant == "w8a8":
        raise ValueError("decode serving supports quant='w8' | 'bf16w'; w8a8 activation "
                         "calibration is a jit.save-time mode")
    if hasattr(model.params, "quantized"):  # Llama's weights: the same functions
        new_params = model.params.quantized(quant)
        fill_fn, step_fn = model.fill_fn, model.step_fn
    else:
        new_params, unpack, weights = _flat_params(model.params, quant)
        on_card = torch.device(model.device).type == "cuda"
        view = weights if on_card else unpack

        def wrap(fn):
            def quantized_fn(param_list, *args):
                if on_card and not all(p.is_cuda for p in param_list):
                    raise RuntimeError(f"a {quant} flat-list model on {model.device} was given "
                                       "params off the card")
                return fn(view(param_list), *args)

            quantized_fn.__qualname__ = f"{quant}({getattr(fn, '__qualname__', 'fn')})"
            return quantized_fn

        fill_fn, step_fn = wrap(model.fill_fn), wrap(model.step_fn)
    return DecodeModel(new_params, fill_fn, step_fn, kv_spec=model.kv_spec,
                       vocab_size=model.vocab_size, feature_spec=model.feature_spec,
                       eos_token_id=model.eos_token_id, kv_seq_axis=model.kv_seq_axis,
                       device=model.device, max_slots=model.max_slots,
                       max_seq_len=model.max_seq_len, quant=quant)


def weight_bytes(params):
    """Total bytes of a model's params (a flat list, or an object with
    ``named_tensors()``, as ``DecodeModel.params``): what every decode step
    streams once."""
    from ..inference.decode import _named_params

    return int(sum(t.numel() * t.element_size() for _, t in _named_params(params)))
