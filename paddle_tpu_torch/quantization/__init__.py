"""paddle_tpu_torch.quantization (counterpart of paddle_tpu.quantization):
post-training int8 weight quantization and the quantized serving modes.
The QAT half of the reference (``ImperativeQuantAware``, ``QuantedLinear``,
``QuantedConv2D``, ``fake_quant``) and ``Int8Conv2D`` are not ported yet
(ROADMAP Queue 1)."""
from .post_training import Int8Linear, PostTrainingQuantization, quantize_weights
from .serving import ACCURACY_BOUNDS, QUANT_MODES, quantize_decode_model, quantize_for_serving

__all__ = [
    "PostTrainingQuantization", "quantize_weights", "Int8Linear",
    "QUANT_MODES", "ACCURACY_BOUNDS", "quantize_for_serving", "quantize_decode_model",
]
