"""Pipeline layer description (counterpart of
paddle_tpu/distributed/meta_parallel/pp_layers.py; reference:
fleet/meta_parallel/parallel_layers/pp_layers.py:22 SegmentLayers, :61
PipelineLayer).

``PipelineLayer`` holds the whole layer list, as the reference's does, and
``segment_parts`` its stage boundaries; its forward is the sequential
composition. ``PipelineParallel.train_batch`` splits the list into pre,
trunk and post and pipelines the trunk over the "pp" axis
(distributed/pipeline.py).
"""
import numpy as np

from ... import nn
from ...nn.layer import Layer


class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None, shared_weight_attr="weight",
                 *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """reference: pp_layers.py:22 — partition N layers into M stages by
    ``method``: "uniform" (equal counts, the first stages one more),
    "layer:<Class>" (an equal share of the layers of that class, or built
    by a ``LayerDesc`` of that name) or "param" (comparable parameter
    counts, each ``LayerDesc`` built and freed one at a time, never an
    empty stage)."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self):
        n = len(self.layers_desc)
        if self.method == "uniform":
            base, extra = divmod(n, self.num_parts)
            parts = [0]
            for i in range(self.num_parts):
                parts.append(parts[-1] + base + (1 if i < extra else 0))
            return parts
        if self.method.startswith("layer:"):
            cls_name = self.method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self.layers_desc)
                     if type(d).__name__ == cls_name
                     or getattr(getattr(d, "layer_func", None), "__name__", None) == cls_name]
            if len(marks) < self.num_parts:
                raise ValueError(f"{len(marks)} '{cls_name}' layers cannot fill "
                                 f"{self.num_parts} stages")
            per, extra = divmod(len(marks), self.num_parts)
            parts = [0]
            taken = 0
            for i in range(self.num_parts - 1):
                taken += per + (1 if i < extra else 0)
                parts.append(marks[taken - 1] + 1)
            parts.append(n)
            return parts
        if self.method == "param":
            weights = []
            for d in self.layers_desc:
                if hasattr(d, "named_parameters"):
                    layer = d
                elif hasattr(d, "build_layer"):
                    layer = d.build_layer()
                else:
                    layer = None
                w = (sum(int(np.prod(p.shape)) for _, p in layer.named_parameters())
                     if layer is not None else 0)
                del layer  # free a transient build before the next
                weights.append(max(w, 1))
            target = sum(weights) / self.num_parts
            parts = [0]
            acc = 0
            for i, w in enumerate(weights):
                acc += w
                # keep a layer for every remaining stage: a tail-heavy
                # model cannot leave the last stage empty
                latest = n - (self.num_parts - len(parts))
                if (len(parts) < self.num_parts and acc >= target * len(parts)
                        and parts[-1] < i + 1 <= latest):
                    parts.append(i + 1)
            while len(parts) < self.num_parts:
                parts.append(min(parts[-1] + 1, n - (self.num_parts - len(parts))))
            parts.append(n)
            assert all(b > a for a, b in zip(parts, parts[1:])), parts
            return parts
        raise ValueError(self.method)


class PipelineLayer(Layer):
    """reference: pp_layers.py:61. Builds every ``LayerDesc`` (a Layer is
    taken as it is, a plain callable wrapped), segments the list into
    ``num_stages`` (the topology's "pipe" dimension when not given) and
    runs it in order."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, **kwargs):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        self._num_stages = num_stages or (topology.get_dim("pipe") if topology else 1)
        self.layers_desc = list(layers)
        self.run_functions = nn.LayerList()
        for item in self.layers_desc:
            if isinstance(item, LayerDesc):
                self.run_functions.append(item.build_layer())
            elif isinstance(item, Layer):
                self.run_functions.append(item)
            else:
                self.run_functions.append(_FuncLayer(item))
        self.segment_parts = SegmentLayers(self.layers_desc, self._num_stages,
                                           seg_method).do_segment()

    def get_stage_from_index(self, layer_idx):
        for stage in range(self._num_stages):
            if self.segment_parts[stage] <= layer_idx < self.segment_parts[stage + 1]:
                return stage
        return self._num_stages - 1

    def stage_layers(self, stage):
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return list(self.run_functions)[lo:hi]

    def forward(self, x):
        for layer in self.run_functions:
            x = layer(x)
        return x


class _FuncLayer(Layer):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)
