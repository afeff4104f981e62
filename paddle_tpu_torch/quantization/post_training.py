"""Post-training quantization (counterpart of
paddle_tpu/quantization/post_training.py).

``quantize_weights`` freezes every ``nn.Linear`` of a model in place to an
``Int8Linear`` and every ``nn.Conv2D`` to an ``Int8Conv2D``: int8 weights
with a per-output-channel f32 scale, and, where a calibrated activation
scale is given, the w8a8 activation rounding. ``PostTrainingQuantization``
calibrates those activation scales with forward pre-hooks over a sample
generator. ``Int8Linear`` multiplies through ``ops/quant_matmul.py``
``wq_matmul``: the hand-written dequantizing kernel on the card (never an
f32 copy of the weight), its plain version (dequantize, then matmul) on
the CPU. ``Int8Conv2D`` dequantizes its OIHW weight and calls
``F.conv2d``, as the reference does (post_training.py:55-77); the
reference's convolution was XLA's, with no kernel of its own.

``_quantize_array`` is bitwise the reference's numpy: the abs-max and the
scale ``max(amax, 1e-9) / 127`` in float32, IEEE division, and
``torch.round`` rounding half to even as ``np.round`` does. It runs where
the weight lies, so a model on the card is quantized on the card.

``quantize_weights`` leaves the QAT wrappers of ``imperative.py`` alone
(by class name, as the reference skips its ``_QuantedBase``) and refuses
torch's own convolution modules, which are not the port's layers.
``save_quantized_model`` needs ``jit.save`` and raises
NotImplementedError.
"""
import numpy as np
import torch

from .. import nn
from ..nn import functional as F
from ..ops.quant_matmul import wq_matmul
from ..nn.layer import Layer

# the shapes wq_matmul's kernel takes for an int8 weight [K, N]
_KERNEL_K, _KERNEL_N = 4, 16
# the QAT wrappers (quantization/imperative.py): they own their inner
# layer's quantization, so the walk leaves them alone
_QAT_WRAPPERS = ("QuantedLinear", "QuantedConv2D")


def _quant_act(x, scale):
    """Quantize-dequantize an activation onto the int8 grid at a fixed
    calibrated ``scale`` (the w8a8 serving semantics), in float32."""
    s = torch.clamp_min(torch.as_tensor(scale, dtype=torch.float32, device=x.device),
                        1e-9) / 127.0
    return torch.clamp(torch.round(x / s), -127.0, 127.0) * s


class Int8Linear(Layer):
    """Weight-only int8 linear: buffers ``qweight`` int8 [in, out] and
    ``w_scale`` f32 [out] (``act_scale``, a scalar, or None), and the
    layer's ``bias``. ``forward`` runs ``wq_matmul``; with ``act_scale`` the
    input is first quantize-dequantized onto the int8 grid (w8a8). On the
    card a weight whose K or N the kernel does not take (K % 4, N % 16) is
    padded with zero rows and columns for the call and the output sliced
    back (a LeNet's or a ResNet classifier's 1000 columns)."""

    def __init__(self, qweight, scale, bias, act_scale=None):
        super().__init__()
        self.register_buffer("qweight", torch.as_tensor(qweight, dtype=torch.int8))
        self.register_buffer("w_scale", torch.as_tensor(scale, dtype=torch.float32,
                                                        device=self.qweight.device))
        if act_scale is not None:
            self.register_buffer("act_scale", torch.as_tensor(
                act_scale, dtype=torch.float32, device=self.qweight.device))
        else:
            self.act_scale = None
        self.bias = bias

    def forward(self, x):
        if self.act_scale is not None:
            x = _quant_act(x, self.act_scale)
        k, n = self.qweight.shape
        pad_k, pad_n = -k % _KERNEL_K, -n % _KERNEL_N
        if x.is_cuda and (pad_k or pad_n):
            # the kernel takes K % 4 and N % 16: zero rows and columns, sliced off
            w = torch.nn.functional.pad(self.qweight, (0, pad_n, 0, pad_k))
            scale = torch.nn.functional.pad(self.w_scale, (0, pad_n), value=1.0)
            y = wq_matmul(torch.nn.functional.pad(x, (0, pad_k)), w, scale)[..., :n]
        else:
            y = wq_matmul(x, self.qweight, self.w_scale)
        return y if self.bias is None else y + self.bias


class Int8Conv2D(Layer):
    """Weight-only int8 2-D convolution: buffers ``qweight`` int8 OIHW and
    ``w_scale`` f32 [O] (``act_scale``, a scalar, or None), the layer's
    ``bias`` and its stride, padding, dilation and groups. ``forward``
    dequantizes the weight (``qweight * w_scale`` per output channel) and
    runs ``F.conv2d``; with ``act_scale`` the input is first
    quantize-dequantized onto the int8 grid (w8a8)."""

    def __init__(self, qweight, scale, bias, stride, padding, dilation, groups,
                 act_scale=None):
        super().__init__()
        self.register_buffer("qweight", torch.as_tensor(qweight, dtype=torch.int8))
        self.register_buffer("w_scale", torch.as_tensor(scale, dtype=torch.float32,
                                                        device=self.qweight.device))
        if act_scale is not None:
            self.register_buffer("act_scale", torch.as_tensor(
                act_scale, dtype=torch.float32, device=self.qweight.device))
        else:
            self.act_scale = None
        self.bias = bias
        self._conv_args = (stride, padding, dilation, groups)

    def forward(self, x):
        if self.act_scale is not None:
            x = _quant_act(x, self.act_scale)
        w = self.qweight.to(torch.float32) * self.w_scale[:, None, None, None]
        return F.conv2d(x, w, self.bias, *self._conv_args)


def _quantize_array(w, channel_axis):
    """Symmetric int8 quantization of the float32 tensor ``w`` -> (int8 q,
    f32 scale) on ``w``'s device: one abs-max scale per slice along
    ``channel_axis`` (the out axis: the last for a Linear's [in, out]), or
    one per tensor (a 0-d scale) for ``channel_axis=None``. Bitwise the
    reference's numpy."""
    w = torch.as_tensor(w)
    if channel_axis is None:
        amax = w.abs().amax()
    else:
        axes = tuple(i for i in range(w.dim()) if i != channel_axis)
        amax = w.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp_min(amax, 1e-9) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    if channel_axis is not None:
        scale = scale.reshape(-1)
    return q, scale.to(torch.float32)


def quantize_weights(model, act_scales=None):
    """In-place weight-only int8 conversion of every ``nn.Linear`` (an
    ``Int8Linear``, scales on the out axis 1) and ``nn.Conv2D`` (an
    ``Int8Conv2D``, scales on the O axis 0): -> (model, {dotted name:
    scale}). ``act_scales``: calibrated input abs-max values by dotted
    layer name (``PostTrainingQuantization.activation_scales``); a layer
    with one becomes w8a8. torch's own convolution modules raise
    NotImplementedError."""
    stats = {}
    act_scales = act_scales or {}

    def _walk(layer, prefix=""):
        for name, sub in list(layer.named_children()):
            full = f"{prefix}{name}"
            kind = type(sub).__name__
            if kind in _QAT_WRAPPERS:
                continue
            if isinstance(sub, nn.Linear):
                q, s = _quantize_array(sub.weight.detach(), channel_axis=1)
                setattr(layer, name, Int8Linear(q, s, sub.bias, act_scale=act_scales.get(full)))
                stats[full] = s
            elif isinstance(sub, nn.Conv2D):
                q, s = _quantize_array(sub.weight.detach(), channel_axis=0)
                setattr(layer, name, Int8Conv2D(q, s, sub.bias, sub._stride, sub._padding,
                                                sub._dilation, sub._groups,
                                                act_scale=act_scales.get(full)))
                stats[full] = s
            elif isinstance(sub, torch.nn.modules.conv._ConvNd):
                raise NotImplementedError(
                    f"quantize_weights: {full} is torch's {kind}, not one of the port's "
                    "layers; build the model from paddle_tpu_torch.nn (nn.Conv2D)")
            else:
                _walk(sub, full + ".")

    _walk(model)
    return model, stats


class PostTrainingQuantization:
    """The reference's ``PostTrainingQuantization``::

        ptq = PostTrainingQuantization(model, sample_generator)
        qmodel = ptq.quantize()          # calibrate + freeze int8 weights

    Calibration runs up to ``batch_nums`` batches of ``sample_generator()``
    through the model in eval mode, recording each ``nn.Linear``'s and
    ``nn.Conv2D``'s input
    abs-max (``algo`` "abs_max": the maximum over batches; "avg": their
    mean) with forward pre-hooks."""

    def __init__(self, model, sample_generator=None, batch_nums=8, algo="abs_max"):
        self._model = model
        self._samples = sample_generator
        self._batch_nums = batch_nums
        if algo not in ("abs_max", "avg"):
            raise ValueError(f"unsupported calibration algo {algo!r}")
        self._algo = algo
        self._act_scales = {}
        self._quantized = None

    def _calibrate(self):
        handles = []
        scales = self._act_scales

        def make_hook(name):
            def hook(layer, inputs):
                cur = float(inputs[0].detach().abs().max())
                if self._algo == "abs_max":
                    scales[name] = max(scales.get(name, 0.0), cur)
                else:
                    prev, n = scales.get(name, (0.0, 0))
                    scales[name] = ((prev * n + cur) / (n + 1), n + 1)

            return hook

        device = next(iter(self._model.parameters())).device
        for name, sub in self._model.named_modules():
            if name and isinstance(sub, (nn.Linear, nn.Conv2D)):
                handles.append(sub.register_forward_pre_hook(make_hook(name)))
        try:
            self._model.eval()
            with torch.no_grad():
                for i, batch in enumerate(self._samples()):
                    if i >= self._batch_nums:
                        break
                    x = batch[0] if isinstance(batch, (tuple, list)) else batch
                    if not isinstance(x, torch.Tensor):
                        x = torch.from_numpy(np.asarray(x))
                    self._model(x.to(device))
        finally:
            for h in handles:
                h.remove()
        if self._algo == "avg":
            self._act_scales = {k: v[0] for k, v in scales.items()}

    def quantize(self, act_quant=False):
        """Calibrate (when a sample generator was given) and freeze int8
        weights; ``act_quant=True`` also bakes the calibrated activation
        scales in (w8a8), which needs a sample generator."""
        if self._samples is not None:
            self._calibrate()
        elif act_quant:
            raise ValueError("act_quant needs calibrated activation scales: construct "
                             "PostTrainingQuantization with a sample_generator")
        self._quantized, self._weight_scales = quantize_weights(
            self._model, act_scales=self._act_scales if act_quant else None)
        return self._quantized

    @property
    def activation_scales(self):
        return dict(self._act_scales)

    @property
    def weight_scales(self):
        return dict(getattr(self, "_weight_scales", {}))

    def save_quantized_model(self, path, input_spec=None):
        raise NotImplementedError("save_quantized_model needs jit.save, which is not ported "
                                  "yet (ROADMAP Queue 1, item 3)")
