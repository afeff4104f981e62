"""paddle_tpu_torch.quantization (counterpart of paddle_tpu.quantization):
quantization-aware training (``ImperativeQuantAware``, ``QuantedLinear``,
``QuantedConv2D``, ``fake_quant``), post-training int8 weight quantization
(``Int8Linear``, ``Int8Conv2D``, ``quantize_weights``,
``PostTrainingQuantization``) and the quantized serving modes."""
from .imperative import ImperativeQuantAware, QuantedConv2D, QuantedLinear, fake_quant
from .post_training import Int8Conv2D, Int8Linear, PostTrainingQuantization, quantize_weights
from .serving import ACCURACY_BOUNDS, QUANT_MODES, quantize_decode_model, quantize_for_serving

__all__ = [
    "ImperativeQuantAware", "QuantedLinear", "QuantedConv2D", "fake_quant",
    "PostTrainingQuantization", "quantize_weights", "Int8Linear", "Int8Conv2D",
    "QUANT_MODES", "ACCURACY_BOUNDS", "quantize_for_serving", "quantize_decode_model",
]
