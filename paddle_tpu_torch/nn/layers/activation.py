"""Activation layers (counterpart of paddle_tpu/nn/layers/activation.py)."""
from .. import functional as F
from .. import initializer as I
from ..layer import Layer


def _act_layer(name, fn_name):
    class _Act(Layer):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return getattr(F, fn_name)(x)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", "relu")
ReLU6 = _act_layer("ReLU6", "relu6")
Sigmoid = _act_layer("Sigmoid", "sigmoid")
Tanh = _act_layer("Tanh", "tanh")
Silu = _act_layer("Silu", "silu")
Swish = _act_layer("Swish", "silu")
Mish = _act_layer("Mish", "mish")
Hardswish = _act_layer("Hardswish", "hardswish")
Hardsigmoid = _act_layer("Hardsigmoid", "hardsigmoid")
Softsign = _act_layer("Softsign", "softsign")
Tanhshrink = _act_layer("Tanhshrink", "tanhshrink")
LogSigmoid = _act_layer("LogSigmoid", "log_sigmoid")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
        super().__init__()
        self._scale = scale
        self._alpha = alpha

    def forward(self, x):
        return F.selu(x, self._scale, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter([num_parameters], attr=weight_attr,
                                            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Softplus(Layer):
    def __init__(self, beta=1, threshold=20, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold)
