"""Loss layers (counterpart of paddle_tpu/nn/layers/loss.py)."""
import numpy as np

from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False,
                 axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index, self.reduction,
                               self.soft_label, self.axis, self.use_softmax)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None, name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, self.weight, self.reduction,
                                                  self.pos_weight)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index, self.reduction)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin, self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin, self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths, norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths, self.blank,
                          self.reduction, norm_by_times)


class HSigmoidLoss(Layer):
    """Owns the internal nodes' weights [num_classes - 1, feature_size]
    (uniform in +-1/sqrt(feature_size)) and biases [num_classes - 1, 1]."""

    def __init__(self, feature_size, num_classes, weight_attr=None, bias_attr=None,
                 is_custom=False, is_sparse=False, name=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.is_custom = is_custom
        k = 1.0 / np.sqrt(feature_size)
        self.weight = self.create_parameter([num_classes - 1, feature_size], attr=weight_attr,
                                            default_initializer=I.Uniform(-k, k))
        self.bias = self.create_parameter([num_classes - 1, 1], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight, self.bias,
                               path_table, path_code)
