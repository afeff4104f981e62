"""paddle.static, the static-graph facade (counterpart of
paddle_tpu/static; reference: python/paddle/static/, fluid/framework.py
Program:4301, executor.py Executor:916).

A Program is the list of torch calls that graph-building code makes on
placeholder tensors inside ``program_guard`` (program.py), and
``Executor.run`` replays the calls its fetches need, eagerly, as one
training step when ``optimizer.minimize`` attached an optimizer under
static mode. ``static.nn`` holds the LayerHelper-style builders
(``fc``, ``conv2d``, ``batch_norm``, nn_extra.py), the sequence ops
(text/ragged.py) and the control flow (nn_control_flow.py), and falls
back to ``paddle.nn`` for every other name.
"""
from .program import (  # noqa: F401
    Program, program_guard, default_main_program, default_startup_program,
    Executor, data, append_backward, gradients, name_scope, global_scope,
    scope_guard, cpu_places, cuda_places, tpu_places, device_guard,
    save_inference_model, load_inference_model, normalize_program,
)
from .input_spec import InputSpec  # noqa: F401
from .compat import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy, ParallelExecutor,
    Print, Variable, accuracy, auc, create_global_var, create_parameter,
    deserialize_persistables, deserialize_program, load, load_from_file,
    load_program_state, py_func, save, save_to_file, serialize_persistables,
    load_vars, save_vars, serialize_program, set_program_state, xpu_places,
)
from .program import _Scope as Scope  # noqa: F401
from .. import amp  # noqa: F401 (paddle.static.amp)
from ..framework.param_attr import WeightNormParamAttr  # noqa: F401
from .. import nn as _nn_module


class _StaticNN:
    """paddle.static.nn (reference: python/paddle/static/nn): the
    program-building helpers, and ``paddle.nn`` for every other name."""

    def __getattr__(self, name):
        return getattr(_nn_module, name)

    @staticmethod
    def fc(x, size, num_flatten_dims=1, activation=None, name=None, **kw):
        from .. import tensor as pt
        from ..nn import functional as F
        from ..tensor import creation

        in_dim = 1
        for d in x.shape[num_flatten_dims:]:
            in_dim *= d
        # the leading (batch) dim stays -1: the program replays at the
        # feeds' shapes, so the placeholder's dim is not baked
        lead = [-1] + list(x.shape[1:num_flatten_dims])
        flat = pt.reshape(x, lead + [in_dim])
        w = creation.create_parameter([in_dim, size], "float32")
        b = creation.create_parameter([size], "float32", is_bias=True)
        out = F.linear(flat, w, b)
        if activation:
            out = getattr(F, activation)(out)
        return out

    @staticmethod
    def batch_norm(x, **kw):
        from ..nn.layers.norm import BatchNorm

        return BatchNorm(x.shape[1])(x)

    @staticmethod
    def conv2d(x, num_filters, filter_size, stride=1, padding=0, **kw):
        from ..nn.layers.conv import Conv2D

        return Conv2D(x.shape[1], num_filters, filter_size, stride, padding)(x)


nn = _StaticNN()

from . import nn_extra as _nn_extra  # noqa: E402

for _name in ("embedding", "sparse_embedding", "conv2d_transpose", "conv3d",
              "conv3d_transpose", "layer_norm", "group_norm", "instance_norm", "prelu",
              "bilinear_tensor_product", "data_norm", "row_conv", "crf_decoding",
              "deform_conv2d", "multi_box_head", "nce", "spectral_norm"):
    setattr(_StaticNN, _name, staticmethod(getattr(_nn_extra, _name)))
# the sequence ops ride the ragged module (LoD -> padding + lengths)
from ..text import ragged as _ragged  # noqa: E402

for _name in ("sequence_softmax", "sequence_reverse", "sequence_pad", "sequence_unpad",
              "sequence_expand", "sequence_concat"):
    setattr(_StaticNN, _name, staticmethod(getattr(_ragged, _name)))
setattr(_StaticNN, "py_func", staticmethod(py_func))
setattr(_StaticNN, "create_parameter", staticmethod(create_parameter))

nn_compat = nn  # the reference's alias

from . import nn_control_flow  # noqa: E402
from .nn_control_flow import case, cond, switch_case, while_loop  # noqa: F401,E402

for _cf_name, _cf in (("cond", cond), ("while_loop", while_loop), ("case", case),
                      ("switch_case", switch_case)):
    setattr(_StaticNN, _cf_name, staticmethod(_cf))
