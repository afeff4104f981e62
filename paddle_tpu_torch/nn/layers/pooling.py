"""Pooling layers (counterpart of paddle_tpu/nn/layers/pooling.py)."""
from .. import functional as F
from ..layer import Layer


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, return_mask, ceil_mode)

    def forward(self, x):
        return F.max_pool1d(x, *self.args)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, exclusive, ceil_mode)

    def forward(self, x):
        return F.avg_pool1d(x, *self.args)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, return_mask, ceil_mode, data_format)

    def forward(self, x):
        return F.max_pool2d(x, *self.args)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive, divisor_override,
                     data_format)

    def forward(self, x):
        return F.avg_pool2d(x, *self.args)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, return_mask, ceil_mode, data_format)

    def forward(self, x):
        return F.max_pool3d(x, *self.args)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive, divisor_override,
                     data_format)

    def forward(self, x):
        return F.avg_pool3d(x, *self.args)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)
