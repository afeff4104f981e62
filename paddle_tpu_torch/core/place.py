"""Device places (counterpart of paddle_tpu/core/place.py).

The port runs on the CUDA card unless the caller asks for the CPU:
``resolve_device()`` defaults to ``"cuda"`` and raises when no card is
present. It never moves to the CPU on its own.
"""
import torch


class Place:
    _kind = "unknown"

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self._kind}:{self.device_id})"

    def torch_device(self):
        return resolve_device(f"{self._kind}:{self.device_id}")


class CPUPlace(Place):
    _kind = "cpu"

    def __init__(self):
        super().__init__(0)

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    _kind = "cuda"


def resolve_device(device="cuda"):
    """A ``torch.device`` from a Paddle or torch spelling ("gpu", "gpu:1",
    "cuda", "cpu", a Place or a torch.device). Raises RuntimeError for a
    CUDA device when no card is present, ValueError for anything else."""
    if isinstance(device, Place):
        return device.torch_device()
    if isinstance(device, str):
        name = device.lower()
        if name == "gpu" or name.startswith("gpu:"):
            name = "cuda" + name[3:]
        device = name
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: the port runs on "
                         "'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA card is "
                           "present; pass device='cpu' to run on the CPU")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise ValueError(f"{device!r}: only {torch.cuda.device_count()} "
                         "CUDA device(s) present")
    return dev
