"""Device places (counterpart of paddle_tpu/core/place.py).

The port runs on the CUDA card unless the caller asks for the CPU:
``resolve_device()`` defaults to ``"cuda"`` and raises when no card is
present, and the current place of ``set_device``/``get_device`` (what
``to_tensor``, the creation ops and ``Layer.create_parameter`` use) is
``gpu:0`` until ``set_device`` says otherwise. It never moves to the CPU
on its own.
"""
import torch


class Place:
    _kind = "unknown"

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def get_device_id(self):
        return self.device_id

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((self._kind, self.device_id))

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
    _kind = "gpu"


class CUDAPinnedPlace(CPUPlace):
    pass


def resolve_device(device="cuda"):
    """A ``torch.device`` from a Paddle or torch spelling ("gpu", "gpu:1",
    "cuda", "cpu", a Place or a torch.device); None is the current place
    (``set_device``'s). Raises RuntimeError for a CUDA device when no card
    is present, ValueError for anything else."""
    if device is None:
        return current_device()
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


def place_of(device):
    """The Place of a torch.device."""
    if device.type == "cpu":
        return CPUPlace()
    return CUDAPlace(device.index or 0)


_CURRENT = CUDAPlace(0)


def set_device(device):
    """paddle.set_device("gpu") / "gpu:1" / "cpu" / a Place. A CUDA place
    raises without a card."""
    global _CURRENT
    if isinstance(device, Place):
        place = device
    else:
        name = str(device).lower()
        idx = 0
        if ":" in name:
            name, idx_s = name.split(":")
            idx = int(idx_s)
        if name == "cpu":
            place = CPUPlace()
        elif name in ("gpu", "cuda"):
            place = CUDAPlace(idx)
        else:
            raise ValueError(f"unknown device {device!r}: the port runs on 'gpu' or 'cpu'")
    place.torch_device()  # raises for a card that is not there
    _CURRENT = place
    return place


def current_place():
    return _CURRENT


def current_device():
    """The torch.device of the current place (raises for the card when no
    card is present)."""
    return _CURRENT.torch_device()


def get_device():
    p = _CURRENT
    return "cpu" if isinstance(p, CPUPlace) else f"gpu:{p.device_id}"


def is_compiled_with_cuda():
    return torch.version.cuda is not None


def is_compiled_with_xpu():
    return False


def is_compiled_with_tpu():
    return False


def device_count():
    """CUDA cards present (the reference counts the current platform's
    devices)."""
    return torch.cuda.device_count()
