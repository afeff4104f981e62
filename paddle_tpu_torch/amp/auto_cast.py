"""auto_cast context (counterpart of paddle_tpu/amp/auto_cast.py).

The reference casts the inputs of every op it dispatches by the op's name:
white-listed ops take the low-precision dtype, black-listed ops take
float32, and under O2 every other op takes the low-precision dtype too.
The port applies the same lists in its own functional ops (each calls
``cast_inputs(name, ...)`` before computing), so a training step under
``auto_cast`` has the reference's dtype at every op of the path.
``torch.autocast`` is not used: its op lists differ from the reference's
and it does not see the port's own ops (the flash-attention Function).

Master weights stay float32: the casts are ordinary differentiable
``Tensor.to`` calls, so gradients come back float32.
"""
import contextlib
import contextvars

import torch

# bf16/fp16-safe ops (matrix-unit bound): inputs cast down
AMP_WHITE_LIST = {
    "matmul", "bmm", "mm", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "conv1d_transpose", "einsum", "fused_lstm", "fused_gru",
    "fused_rnn", "sdpa", "flash_attention", "addmm",
}

# numerically sensitive ops: inputs forced to float32
AMP_BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "bce", "bce_logits",
    "kl_div", "mse_loss", "l1_loss", "smooth_l1_loss", "sum", "mean", "logsumexp",
    "cumsum", "layer_norm", "batch_norm_train", "batch_norm_infer", "group_norm",
    "instance_norm", "p_norm", "softmax_with_cross_entropy", "sigmoid_focal_loss",
}

_AMP_STATE = contextvars.ContextVar("amp_state", default=None)

#: above 0 while ``cast_inputs`` casts: a Program being recorded takes
#: these casts as aliases (static/program.py), as the reference records an
#: op's inputs before its auto_cast hook casts them
_CASTING = [0]


class _AmpState:
    def __init__(self, enable, dtype, level, custom_white, custom_black):
        self.enable = enable
        self.dtype = torch.bfloat16 if dtype in ("bfloat16", "bf16") else torch.float16
        self.level = level
        self.white = (AMP_WHITE_LIST | set(custom_white or ())) - set(custom_black or ())
        self.black = (AMP_BLACK_LIST | set(custom_black or ())) - set(custom_white or ())


def target_dtype(name):
    """The dtype op ``name`` computes in under the active auto_cast, or
    None where its inputs keep their own dtypes."""
    state = _AMP_STATE.get()
    if state is None or not state.enable:
        return None
    if name in state.white:
        return state.dtype
    if name in state.black:
        return torch.float32
    if state.level == "O2":
        return state.dtype
    return None


def cast_inputs(name, *tensors):
    """The inputs of op ``name`` as the active auto_cast casts them:
    floating tensors go to the op's target dtype, everything else
    (integer ids, None) passes through. Returns a tuple."""
    tgt = target_dtype(name)
    if tgt is None:
        return tensors
    _CASTING[0] += 1
    try:
        return tuple(t.to(tgt) if isinstance(t, torch.Tensor) and t.is_floating_point()
                     and t.dtype != tgt else t for t in tensors)
    finally:
        _CASTING[0] -= 1


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    state = _AmpState(enable, dtype, level, custom_white_list, custom_black_list)
    token = _AMP_STATE.set(state)
    try:
        yield
    finally:
        _AMP_STATE.reset(token)
