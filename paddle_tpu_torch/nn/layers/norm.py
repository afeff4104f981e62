"""Normalisation layers (counterpart of paddle_tpu/nn/layers/norm.py).

The batch norms keep the reference's buffer names and layout: ``_mean``
and ``_variance``, float32 [num_features] (zeros and ones at the start),
so that ``convert.load_state_dict`` carries them across; their running
update is the reference's (nn/functional/norm.py)."""
import numpy as np
import torch

from ...core import place as place_mod
from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter([num_features], attr=weight_attr,
                                            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)
        dev = place_mod.current_device()
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self._momentum,
                            epsilon=self._epsilon, data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The fluid form: ``BatchNorm(num_channels, act=...)``, the activation
    applied after the norm."""

    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32", data_layout="NCHW",
                 in_place=False, moving_mean_name=None, moving_variance_name=None,
                 do_model_average_for_mean_and_var=True, use_global_stats=False,
                 trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr, bias_attr, data_layout,
                         use_global_stats)
        self._act = act
        if is_test:
            self.eval()

    def forward(self, x):
        y = super().forward(x)
        return getattr(F, self._act)(y) if self._act else y


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """A BatchNorm over the batch of this device: the port trains on one
    card, where there is no other replica to synchronise with."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every batch norm under ``layer`` replaced by a SyncBatchNorm that
        shares its parameters and buffers."""
        for mod in layer.sublayers(include_self=True):
            for name, sub in list(mod._modules.items()):
                if isinstance(sub, _BatchNormBase) and not isinstance(sub, cls):
                    new = cls(sub._num_features, sub._momentum, sub._epsilon,
                              data_format=sub._data_format)
                    new.weight, new.bias = sub.weight, sub.bias
                    new._mean, new._variance = sub._mean, sub._variance
                    setattr(mod, name, new)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 name=None, *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(self._normalized_shape, attr=weight_attr,
                                            default_initializer=I.Constant(1.0),
                                            device=device)
        self.bias = self.create_parameter(self._normalized_shape, attr=bias_attr,
                                          is_bias=True, device=device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCL", name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False:
            self.scale = self.bias = None
        else:
            self.scale = self.create_parameter([num_features], attr=weight_attr,
                                               default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias, eps=self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr, bias_attr)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr, bias_attr)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = self.create_parameter([num_channels], attr=weight_attr,
                                            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight, self.bias)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma the top singular value of ``weight`` (its
    axis ``dim`` first, the rest flattened) by ``power_iters`` power
    iterations from the kept vectors ``weight_u``/``weight_v``, which are
    updated and carry no gradient."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12, name=None,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter([h], default_initializer=I.Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter([w], default_initializer=I.Normal(0.0, 1.0))
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        w = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim], -1)
        u, v = self.weight_u, self.weight_v
        wd = w.detach()
        for _ in range(self._power_iters):
            v_new = wd.T @ u
            v = v_new / (torch.linalg.vector_norm(v_new) + self._eps)
            u_new = wd @ v
            u = u_new / (torch.linalg.vector_norm(u_new) + self._eps)
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = (u.detach() * (w @ v.detach())).sum()
        return weight / sigma
