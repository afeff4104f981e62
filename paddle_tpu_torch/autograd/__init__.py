"""paddle.autograd (counterpart of paddle_tpu/autograd): ``backward``,
``grad``, ``no_grad``, ``PyLayer``, ``PyLayerContext`` and the
``backward_mode`` submodule."""
from ..core.dispatch import no_grad  # noqa: F401
from ..core.tape import backward, grad  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401
from . import backward_mode  # noqa: F401,E402
