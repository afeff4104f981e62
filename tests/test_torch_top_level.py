"""The port binds at its top level what the JAX package binds
(paddle_tpu/__init__.py), less an explicit list: what later slices bring,
and the reference's own JAX internals and non-CUDA places."""
import types

import paddle_tpu as jp
import paddle_tpu_torch as tp

# names later slices bring (ROADMAP Queue 1)
LATER = {
    "analysis",
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
                 "inference", "obs", "resilience", "distributed", "jit", "static", "serialize",
                 "fluid", "onnx", "incubate", "utils", "distribution", "hub"):
        assert getattr(tp, name).__name__ == f"paddle_tpu_torch.{name}"
    assert tp.in_dygraph_mode() and tp.in_dynamic_mode()
    assert tp.VarBase is tp.Tensor and tp.is_compiled_with_npu() is False


def test_static_mode_is_one_flag_as_in_the_reference():
    """paddle.in_dynamic_mode, paddle.jit.in_dynamic_mode and
    framework.in_dygraph_mode read one flag, which enable_static,
    disable_static, enable_dygraph and disable_dygraph set, in both
    packages alike at every point of the sequence."""

    def state(p):
        return (p.in_dynamic_mode(), p.jit.in_dynamic_mode(), p.framework.in_dygraph_mode(),
                p.in_dygraph_mode())

    try:
        for step in ("enable_static", "disable_static", "disable_dygraph", "enable_dygraph",
                     "enable_static", "enable_static", "enable_dygraph", "disable_static"):
            getattr(jp, step)()
            getattr(tp, step)()
            want = state(jp)
            assert state(tp) == want, step
            assert len(set(want)) == 1
            assert want[0] == (step in ("disable_static", "enable_dygraph"))
    finally:
        jp.disable_static()
        tp.disable_static()


# paddle.distributed's and fleet's names later slices bring: the parameter
# server's datasets, entries and data generators
DIST_LATER = {"CountFilterEntry", "InMemoryDataset", "ProbabilityEntry", "QueueDataset"}
FLEET_LATER = {"DatasetBase", "InMemoryDataset", "MultiSlotDataGenerator",
               "MultiSlotStringDataGenerator", "QueueDataset"}
# the submodules the reference's __init__ imports that later slices bring
MODULES_LATER = {"paddle_tpu.distributed": {"entry_attr"},
                 "paddle_tpu.distributed.fleet": {"data_generator", "dataset"}}


def _names(mod):
    """Public names that are not submodules (which other imports add)."""
    return {n for n in _public(mod) if not isinstance(getattr(mod, n), types.ModuleType)}


def test_distributed_and_fleet_names_match_the_reference():
    for jm, tm, later in ((jp.distributed, tp.distributed, DIST_LATER),
                          (jp.distributed.fleet, tp.distributed.fleet, FLEET_LATER),
                          (jp.distributed.fleet.utils, tp.distributed.fleet.utils, set())):
        assert _names(jm) - _names(tm) == later, sorted((_names(jm) - _names(tm)) ^ later)
        assert _names(tm) <= _names(jm), sorted(_names(tm) - _names(jm))
        for sub in MODULES_LATER.get(jm.__name__, ()):
            assert hasattr(jm, sub) and not hasattr(tm, sub), sub
    for sub in ("topology", "collective", "parallel", "spmd", "fleet", "launch", "sharding",
                "comm_opt", "meta_parallel"):
        assert getattr(tp.distributed, sub).__name__ == f"paddle_tpu_torch.distributed.{sub}"
    assert tp.DataParallel is tp.distributed.DataParallel
    assert tp.distributed.fleet.distributed_model.__module__.startswith("paddle_tpu_torch.")
