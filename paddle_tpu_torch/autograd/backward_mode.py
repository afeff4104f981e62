"""paddle.autograd.backward_mode (counterpart of
paddle_tpu/autograd/backward_mode.py): the reverse-mode entry point
``backward`` as its own submodule."""
from ..core.tape import backward  # noqa: F401

__all__ = ["backward"]
