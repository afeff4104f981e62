"""The port binds at its top level what the JAX package binds
(paddle_tpu/__init__.py), less an explicit list: what later slices bring,
and the reference's own JAX internals and non-CUDA places."""
import paddle_tpu as jp
import paddle_tpu_torch as tp

# names later slices bring (ROADMAP Queue 1)
LATER = {
    "jit", "static", "enable_static", "disable_static", "enable_dygraph", "disable_dygraph",
    "onnx", "fluid", "incubate", "utils", "distribution", "hub", "serialize", "analysis",
    "DataParallel",
}
# the reference's JAX internals and its places for other devices
NEVER = {"jax", "jnp", "native", "apply_op", "dispatch", "in_trace", "TPUPlace", "XPUPlace",
         "NPUPlace"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_top_level_names_match_the_reference():
    missing = _public(jp) - _public(tp)
    assert missing == LATER | NEVER, sorted(missing ^ (LATER | NEVER))


def test_the_new_names_are_the_ports_own():
    assert tp.Model is tp.hapi.Model and tp.summary is tp.hapi.summary
    assert tp.save is tp.framework.save and tp.load is tp.framework.load
    assert tp.callbacks is tp.hapi.callbacks and tp.flops is tp.hapi.flops
    for name in ("io", "metric", "hapi", "dataset", "quantization", "text", "regularizer",
                 "inference", "obs", "resilience", "distributed"):
        assert getattr(tp, name).__name__ == f"paddle_tpu_torch.{name}"
    assert tp.in_dygraph_mode() and tp.in_dynamic_mode()
    assert tp.VarBase is tp.Tensor and tp.is_compiled_with_npu() is False
