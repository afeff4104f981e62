"""Model summary (counterpart of paddle_tpu/hapi/model_summary.py): every
parameter's name, shape and count, printed, and the totals returned."""
import numpy as np

from ..core.tensor import to_tensor


def summary(net, input_size=None, dtypes=None, input=None):
    rows = []
    total_params = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total_params += n
        if not p.stop_gradient:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    if input_size is not None or input is not None:
        try:
            if input is None:
                shape = input_size if isinstance(input_size, (list, tuple)) else (input_size,)
                if isinstance(shape[0], (list, tuple)):
                    inputs = [to_tensor(np.zeros(s, np.float32)) for s in shape]
                else:
                    inputs = [to_tensor(np.zeros(shape, np.float32))]
            else:
                inputs = [input]
            net.eval()
            net(*inputs)
        except Exception:  # noqa: BLE001 - the reference's summary never fails the program
            pass
    width = max((len(r[0]) for r in rows), default=20) + 2
    print("-" * (width + 40))
    print(f"{'Layer (param)':<{width}}{'Shape':<24}{'Param #':<12}")
    print("=" * (width + 40))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<24}{n:<12}")
    print("=" * (width + 40))
    print(f"Total params: {total_params}")
    print(f"Trainable params: {trainable}")
    print(f"Non-trainable params: {total_params - trainable}")
    return {"total_params": total_params, "trainable_params": trainable}
