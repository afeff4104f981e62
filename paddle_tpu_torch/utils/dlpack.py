"""DLPack interop (counterpart of paddle_tpu/utils/dlpack.py; reference:
paddle/fluid/framework/dlpack_tensor.cc, python paddle.utils.dlpack) over
``torch.utils.dlpack``: a zero-copy exchange, on the CPU and on the card
alike (a CUDA tensor's capsule keeps its device and its memory)."""
import torch.utils.dlpack as _dlpack

from ..core.tensor import plain, wrap

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(tensor):
    """Tensor -> DLPack capsule (dlpack_tensor.cc ToDLPack)."""
    return _dlpack.to_dlpack(plain(tensor).detach())


def from_dlpack(capsule_or_ext):
    """A DLPack capsule, or an object with ``__dlpack__``, -> Tensor over
    the same memory."""
    return wrap(_dlpack.from_dlpack(capsule_or_ext))
