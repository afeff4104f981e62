"""Common layers (counterpart of paddle_tpu/nn/layers/common.py).

Every layer that owns parameters builds them with
``Layer.create_parameter``, on the current place unless ``device`` says
otherwise; ``generator`` (a seeded ``torch.Generator``) draws them where
two runs must agree without carrying weights across."""
import torch

from ...amp.auto_cast import cast_inputs
from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class Linear(Layer):
    """y = x W + b, with ``weight`` [in, out] as in Paddle. With
    ``bias_attr=False`` there is no bias parameter at all."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter([in_features, out_features], attr=weight_attr,
                                            default_initializer=I.XavierNormal(), **kw)
        self.bias = self.create_parameter([out_features], attr=bias_attr, is_bias=True, **kw)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self._in_features}, out={self._out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = self.create_parameter([num_embeddings, embedding_dim], attr=weight_attr,
                                            default_initializer=I.Normal(0.0, 1.0),
                                            device=device, generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx, sparse=self._sparse)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training, mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training, data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training, data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        if x.dim() == 0:
            return x.reshape(1)
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL", name=None):
        super().__init__()
        self._pad = padding
        self._mode = mode
        self._value = value
        self._data_format = data_format

    def forward(self, x):
        return F.pad(x, self._pad, self._mode, self._value, self._data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format, name)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format, name)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest", align_corners=False,
                 align_mode=0, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode, self.align_corners,
                             self.align_mode, self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class Bilinear(Layer):
    """out = x1 W x2 + b, W [out, in1, in2], b [1, out] (an einsum, as
    auto_cast casts one)."""

    def __init__(self, in1_features, in2_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter([out_features, in1_features, in2_features],
                                            attr=weight_attr)
        self.bias = self.create_parameter([1, out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        x1, w, x2 = cast_inputs("einsum", x1, self.weight, x2)
        out = torch.einsum("bi,oij,bj->bo", x1, w, x2)
        return out if self.bias is None else out + self.bias


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor)


class Unfold(Layer):
    def __init__(self, kernel_sizes, dilations=1, paddings=0, strides=1, name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)
