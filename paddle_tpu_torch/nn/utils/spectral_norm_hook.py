"""Spectral normalization hook (counterpart of paddle_tpu/nn/utils/
spectral_norm_hook.py).

``spectral_norm(layer)`` moves the wrapped parameter to ``<name>_orig``
(the trainable Parameter) and sets ``layer.<name> = W / sigma`` in a
forward pre-hook, sigma the top singular value estimated by power
iteration on the buffers ``<name>_u`` and ``<name>_v``, which carry no
gradient. The iteration runs on the weight's device; its start vectors
are the reference's (numpy's RandomState(0)), warmed by 15 iterations at
apply time.
"""
import numpy as np
import torch

__all__ = ["spectral_norm"]


class _SpectralNorm:
    def __init__(self, name, n_power_iterations, eps, dim):
        self.name = name
        self.n_power_iterations = int(n_power_iterations)
        self.eps = float(eps)
        self.dim = int(dim)

    def _matrix(self, w):
        return w.movedim(self.dim, 0).reshape(w.shape[self.dim], -1)

    def compute(self, layer, training):
        orig = layer._parameters[self.name + "_orig"]
        mat = self._matrix(orig.detach().float())
        u, v = layer._buffers[self.name + "_u"], layer._buffers[self.name + "_v"]
        if training:
            for _ in range(self.n_power_iterations):
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + self.eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + self.eps)
            with torch.no_grad():
                layer._buffers[self.name + "_u"].copy_(u)
                layer._buffers[self.name + "_v"].copy_(v)
        sigma = u @ (mat @ v)
        object.__setattr__(layer, self.name, orig * (1.0 / torch.clamp(sigma, min=self.eps)))

    def __call__(self, layer, inputs):
        self.compute(layer, layer.training)


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12, dim=None):
    """Spectral normalization of ``layer.<name>``; ``dim`` defaults to 1
    for Linear and the conv transposes (their output axis is second), else
    0."""
    if name + "_orig" in layer._parameters:
        raise RuntimeError(f"spectral_norm already applied to {name}")
    weight = layer._parameters.get(name)
    if weight is None:
        raise ValueError(f"layer has no parameter {name!r}")
    if dim is None:
        from ..layers.common import Linear
        from ..layers.conv import Conv1DTranspose, Conv2DTranspose, Conv3DTranspose

        dim = 1 if isinstance(layer, (Linear, Conv1DTranspose, Conv2DTranspose,
                                      Conv3DTranspose)) else 0
    fn = _SpectralNorm(name, n_power_iterations, eps, dim)
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", weight)
    mat = fn._matrix(weight.detach())
    rng = np.random.RandomState(0)
    for suffix, n in (("_u", mat.shape[0]), ("_v", mat.shape[1])):
        vec = rng.randn(n).astype(np.float32)
        vec /= np.linalg.norm(vec) + eps
        layer.register_buffer(name + suffix, torch.from_numpy(vec).to(weight.device))
    fn.n_power_iterations, warm = max(fn.n_power_iterations, 15), fn.n_power_iterations
    fn.compute(layer, training=True)
    fn.n_power_iterations = warm
    torch.nn.Module.register_forward_pre_hook(layer, fn)
    return layer
