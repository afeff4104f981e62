"""Containers (counterpart of paddle_tpu/nn/layers/container.py)."""
import torch

from ..layer import Layer


class Sequential(Layer):
    """``Sequential(l1, l2, ...)``, named "0", "1", ...; or
    ``Sequential(("a", l1), ("b", l2))`` (or one list of such pairs), named
    as given."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and not isinstance(
                layers[0][0] if layers[0] else None, torch.nn.Module):
            layers = layers[0]
        for i, item in enumerate(layers):
            name, layer = item if isinstance(item, (list, tuple)) else (str(i), item)
            self.add_sublayer(name, layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer, torch.nn.ModuleList):
    """Sublayers named "0", "1", ... as in the JAX package's LayerList."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.extend(sublayers)


class ParameterList(Layer):
    """Parameters named "0", "1", ..."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    """Sublayers by name, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)
