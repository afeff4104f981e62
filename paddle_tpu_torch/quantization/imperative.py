"""Imperative (dygraph) quantization-aware training (counterpart of
paddle_tpu/quantization/imperative.py).

``fake_quant`` quantizes onto the symmetric int8 grid and back, forward
only: its gradient is the identity (the straight-through estimator), a
``torch.autograd.Function`` whose backward hands the incoming gradient to
``x`` and none to the scale. The forward computes the reference's
``x + (q - x)`` in float32 (the promotion of the input with the float32
scale), rounded as the reference's compiled op rounds it (the scale times
the reciprocal of qmax, the product and the difference in one fused
multiply-add), so its bits are the reference's.

``ImperativeQuantAware.quantize(model)`` swaps every ``nn.Linear`` and
``nn.Conv2D`` in place for a ``QuantedLinear`` / ``QuantedConv2D`` that
holds the layer as ``inner``: the parameter names become
``<name>.inner.weight``, and each wrapper owns a float32 scalar buffer
``act_scale``, the moving-average abs-max of its input. In train mode the
forward writes ``act_scale`` in place (so ``build_train_step``, which hands
the forward copies of the layer's buffers, threads it as it threads
BatchNorm's); in eval mode it is frozen, and an uncalibrated (zero) scale
falls back to the live abs-max. Weights take per-output-channel abs-max
scales: axis 1 of a Linear's [in, out], axis 0 of a conv's OIHW.

``save_quantized_model`` writes the model with ``jit.save`` in eval mode.
"""
import torch

from .. import nn
from ..core.tensor import boundary
from ..nn import functional as F
from ..nn.layer import Layer
from ..ops.torch_ops import divide_by_scalar


class _FakeQuant(torch.autograd.Function):
    """quantize -> dequantize forward, identity backward."""

    @staticmethod
    def forward(ctx, x, scale, bits, per_channel_axis):
        ctx.in_dtype = x.dtype
        dt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dt)
        qmax = float(2 ** (bits - 1) - 1)
        s = divide_by_scalar(torch.clamp_min(scale.to(dt), 1e-9), qmax)
        if per_channel_axis is not None:
            shape = [1] * xf.dim()
            shape[per_channel_axis] = -1
            s = s.reshape(shape)
        c = torch.clamp(torch.round(xf / s), -qmax, qmax)
        # XLA contracts the reference's (c * s) - x into one fused
        # multiply-add; in float64 the product and the difference are exact
        # (or all but), so one rounding to float32 gives its bits
        return xf + (c.double() * s.double() - xf.double()).to(dt)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.in_dtype), None, None, None


@boundary
def fake_quant(x, scale, bits=8, per_channel_axis=None):
    """Simulated quantize -> dequantize with the straight-through gradient
    (the reference's fake_quantize_dequantize_moving_average_abs_max)."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return _FakeQuant.apply(x, scale.detach(), bits, per_channel_axis)


def _abs_max(t, keep_axis=None):
    t = t.detach().abs()
    if keep_axis is None:
        return t.amax()
    return t.amax(dim=tuple(i for i in range(t.dim()) if i != keep_axis))


class _QuantedBase(Layer):
    """Per-channel abs-max weight fake-quant and a moving-average
    activation scale (updated in train mode, frozen in eval)."""

    def __init__(self, inner, weight_bits=8, activation_bits=8, moving_rate=0.9,
                 weight_channel_axis=None):
        super().__init__()
        self.inner = inner
        self._wbits = weight_bits
        self._abits = activation_bits
        self._rate = moving_rate
        self._w_axis = weight_channel_axis
        self.register_buffer("act_scale", torch.zeros((), dtype=torch.float32,
                                                      device=inner.weight.device))

    def _quant_inputs(self, x):
        cur = _abs_max(x).to(torch.float32)
        if self.training:
            prev = self.act_scale
            with torch.no_grad():
                new = torch.where(prev > 0, self._rate * prev + (1 - self._rate) * cur, cur)
                self.act_scale.copy_(new)
            scale = torch.maximum(self.act_scale, cur)
        else:
            scale = torch.where(self.act_scale > 0, self.act_scale, cur)
        return fake_quant(x, scale, bits=self._abits)

    def _quant_weight(self, w):
        return fake_quant(w, _abs_max(w, self._w_axis), bits=self._wbits,
                          per_channel_axis=self._w_axis)


class QuantedLinear(_QuantedBase):
    """The reference's QuantizedLinear: weight [in, out], per-channel
    scales on the out axis (1)."""

    def __init__(self, inner, **kw):
        super().__init__(inner, weight_channel_axis=1, **kw)

    def forward(self, x):
        return F.linear(self._quant_inputs(x), self._quant_weight(self.inner.weight),
                        self.inner.bias)


class QuantedConv2D(_QuantedBase):
    """The reference's QuantizedConv2D: weight [O, I, kh, kw], per-channel
    scales on the O axis (0)."""

    def __init__(self, inner, **kw):
        super().__init__(inner, weight_channel_axis=0, **kw)

    def forward(self, x):
        c = self.inner
        return F.conv2d(self._quant_inputs(x), self._quant_weight(c.weight), c.bias,
                        c._stride, c._padding, c._dilation, c._groups, c._data_format)


_QUANTABLE = {nn.Linear: QuantedLinear, nn.Conv2D: QuantedConv2D}


class ImperativeQuantAware:
    """The reference's ImperativeQuantAware: ``quantize(model)`` swaps the
    quantizable sublayers in place and returns the model."""

    def __init__(self, weight_bits=8, activation_bits=8, moving_rate=0.9,
                 quantizable_layer_type=("Linear", "Conv2D")):
        self._kw = dict(weight_bits=weight_bits, activation_bits=activation_bits,
                        moving_rate=moving_rate)
        self._types = tuple(t for t in _QUANTABLE if t.__name__ in set(quantizable_layer_type))

    def quantize(self, model):
        for name, sub in list(model.named_children()):
            if isinstance(sub, _QuantedBase):
                continue
            if isinstance(sub, self._types):
                wrapper = next(q for t, q in _QUANTABLE.items() if isinstance(sub, t))
                setattr(model, name, wrapper(sub, **self._kw))
            else:
                self.quantize(sub)
        return model

    def save_quantized_model(self, model, path, input_spec=None):
        """``jit.save`` the model in eval mode (reference: imperative.py:136)."""
        from .. import jit

        model.eval()
        jit.save(model, path, input_spec=input_spec)
