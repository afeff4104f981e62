"""Conv layers (counterpart of paddle_tpu/nn/layers/conv.py). The weight is
[out, in / groups, *k] ([in, out / groups, *k] for the transposes), its
default KaimingUniform(fan_in, negative_slope=sqrt(5), "leaky_relu")."""
import numpy as np

from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride, padding, dilation,
                 groups, padding_mode, weight_attr, bias_attr, data_format, nd,
                 transposed=False, output_padding=0):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * nd
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = tuple(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._transposed = transposed
        self._output_padding = output_padding
        if transposed:
            shape = [in_channels, out_channels // groups] + list(self._kernel_size)
        else:
            shape = [out_channels, in_channels // groups] + list(self._kernel_size)
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        self.weight = self.create_parameter(
            shape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in, negative_slope=np.sqrt(5.0),
                                                 nonlinearity="leaky_relu"))
        self.bias = self.create_parameter([out_channels], attr=bias_attr, is_bias=True)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, kernel_size={self._kernel_size}, "
                f"stride={self._stride}, padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format, nd=1)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format, nd=2)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format, nd=3)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class _ConvTransposeNd(_ConvNd):
    _fn = None

    def forward(self, x, output_size=None):
        return type(self)._fn(x, self.weight, self.bias, self._stride, self._padding,
                              self._output_padding, groups=self._groups,
                              dilation=self._dilation, data_format=self._data_format,
                              output_size=output_size)


class Conv1DTranspose(_ConvTransposeNd):
    _fn = F.conv1d_transpose

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, "zeros", weight_attr, bias_attr, data_format, nd=1,
                         transposed=True, output_padding=output_padding)


class Conv2DTranspose(_ConvTransposeNd):
    _fn = F.conv2d_transpose

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None, bias_attr=None,
                 data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, "zeros", weight_attr, bias_attr, data_format, nd=2,
                         transposed=True, output_padding=output_padding)


class Conv3DTranspose(_ConvTransposeNd):
    _fn = F.conv3d_transpose

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None, bias_attr=None,
                 data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, "zeros", weight_attr, bias_attr, data_format, nd=3,
                         transposed=True, output_padding=output_padding)
