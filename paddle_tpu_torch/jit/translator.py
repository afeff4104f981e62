"""ProgramTranslator + TracedLayer compat (counterpart of
paddle_tpu/jit/translator.py; reference: dygraph_to_static/
program_translator.py:756 ProgramTranslator singleton; fluid/dygraph/
jit.py TracedLayer)."""
from .static_function import _TO_STATIC_ENABLED, enable_to_static

__all__ = ["ProgramTranslator", "TracedLayer"]


class ProgramTranslator:
    """Singleton controlling dygraph->static translation (reference:
    program_translator.py:756). ``enable(False)`` makes every to_static
    function run its original dygraph code."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @classmethod
    def get_instance(cls):
        return cls()

    @property
    def enable_to_static(self):
        return _TO_STATIC_ENABLED[0]

    def enable(self, enable_to_static_flag):
        enable_to_static(enable_to_static_flag)


class TracedLayer:
    """reference: fluid/dygraph/jit.py TracedLayer: a dygraph Layer traced
    with example inputs into a static callable that can be saved as an
    inference model. Tracing is a to_static of its forward; saving is
    ``paddle.jit.save``'s format."""

    def __init__(self, layer, static_fn, example_inputs):
        self._layer = layer
        self._fn = static_fn
        self._example_inputs = example_inputs

    @staticmethod
    def trace(layer, inputs):
        from .static_function import to_static

        inputs = list(inputs)
        fn = to_static(layer.forward)
        out = fn(*inputs)
        return out, TracedLayer(layer, fn, inputs)

    def __call__(self, *inputs):
        return self._fn(*inputs)

    def save_inference_model(self, path, feed=None, fetch=None, **kwargs):
        from ..static import InputSpec
        from .save_load import save as jit_save

        specs = [InputSpec.from_tensor(t) for t in self._example_inputs]
        jit_save(self._layer, path, input_spec=specs)
        return path
