"""run_check (counterpart of paddle_tpu/utils/install_check.py;
reference: python/paddle/utils/install_check.py): train a tiny model to
show the install works, on the current place (the card unless the caller
chose the CPU): an eager step, then the compiled-step path
(``distributed.spmd.build_train_step``). The port's training step runs on
one device, so there is no multi-device part."""
import numpy as np

__all__ = ["run_check"]


def run_check():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.distributed import spmd

    dev = place.current_device()
    print(f"Running verify PaddlePaddle(PyTorch/CUDA port) program on {dev} ...")
    paddle.seed(0)
    rng = np.random.RandomState(0)
    x = rng.rand(16, 8).astype(np.float32)
    w = rng.rand(8, 1).astype(np.float32)
    y = (x @ w).astype(np.float32)

    net = nn.Linear(8, 1)
    opt = optimizer.SGD(0.1, parameters=net.parameters())
    first = last = None
    for _ in range(10):
        loss = nn.functional.mse_loss(net(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        last = float(loss.numpy())
        first = last if first is None else first
    assert last < first, "eager training loss did not decrease"

    net2 = nn.Linear(8, 1)
    opt2 = optimizer.SGD(0.1, parameters=net2.parameters())
    step, init = spmd.build_train_step(net2, lambda o, t: ((o - t) ** 2).mean(), opt2)
    params, state = init()
    xb, yb = (paddle.to_tensor(a) for a in (x, y))
    loss0 = None
    for _ in range(5):
        loss, params, state = step(params, state, xb, yb)
        loss0 = float(loss) if loss0 is None else loss0
    assert float(loss) < loss0, "compiled-step loss did not decrease"
    print("PaddlePaddle(PyTorch/CUDA port) is installed successfully! Let's start deep "
          "learning with PaddlePaddle(PyTorch/CUDA port) now.")
