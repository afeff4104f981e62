"""Model FLOPs counter (counterpart of paddle_tpu/hapi/flops.py; Paddle's
hapi/dynamic_flops.py ``paddle.flops``): forward hooks on the leaf layers
record input and output shapes, and per-type formulas sum the
multiply-accumulates of one forward at ``input_size`` on the current
place."""
import numpy as np

from ..core.tensor import to_tensor

__all__ = ["flops"]


def _shape(t):
    return tuple(getattr(t, "shape", ()) or ())


def _count(layer, inputs, output):
    name = type(layer).__name__
    in_shape = _shape(inputs[0]) if inputs else ()
    out_shape = _shape(output if not isinstance(output, (tuple, list))
                       else output[0])
    if name == "Linear":
        n = int(np.prod(out_shape[:-1])) if out_shape else 1
        macs = n * layer.weight.shape[0] * layer.weight.shape[1]
        return macs + (n * layer.weight.shape[1]
                       if getattr(layer, "bias", None) is not None else 0)
    if name in ("Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
                "Conv2DTranspose", "Conv3DTranspose"):
        w = layer.weight
        # taps per output element: cin/g * prod(k). Forward weights are
        # [out, in/g, *k]; transposed weights are [in, out/g, *k], where
        # the contraction runs over dim0 instead.
        if "Transpose" in name:
            kernel_macs = int(w.shape[0]) * int(np.prod(w.shape[2:]))
        else:
            kernel_macs = int(np.prod(w.shape[1:]))
        out_positions = int(np.prod(out_shape[2:])) * out_shape[1] \
            * out_shape[0]
        bias_ops = (out_positions
                    if getattr(layer, "bias", None) is not None else 0)
        return out_positions * kernel_macs + bias_ops
    if name in ("BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
                "LayerNorm", "InstanceNorm2D", "GroupNorm", "SyncBatchNorm"):
        return 2 * int(np.prod(out_shape))
    if name in ("ReLU", "GELU", "Sigmoid", "Tanh", "LeakyReLU", "Softmax",
                "SiLU", "Hardswish"):
        return int(np.prod(out_shape))
    if "Pool" in name:
        return int(np.prod(out_shape))
    return 0


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Total FLOPs (2x MACs for mul+add convention matches the reference
    counter) of one forward at ``input_size``."""
    custom_ops = custom_ops or {}
    records = []
    handles = []

    def hook(lyr, inputs, output):
        fn = custom_ops.get(type(lyr))
        n = fn(lyr, inputs, output) if fn else _count(lyr, inputs, output)
        records.append((type(lyr).__name__, n))
        return output

    seen = set()  # a weight-tied layer appears once per reference; hook once
    for _, sub in net.named_sublayers(include_self=True):
        if id(sub) in seen or list(sub.sublayers()):
            continue
        seen.add(id(sub))
        handles.append(sub.register_forward_post_hook(hook))
    was_training = net.training
    net.eval()
    try:
        x = to_tensor(np.zeros(input_size, np.float32))
        net(x)
    finally:
        for h in handles:
            h.remove()
        if was_training:
            net.train()
    total = sum(n for _, n in records)
    if print_detail:
        for name, n in records:
            print(f"  {name}: {n:,} MACs")
        print(f"Total Flops: {2 * total:,}  (MACs: {total:,})")
    return 2 * total
