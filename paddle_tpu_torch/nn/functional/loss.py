"""Losses and distances (paddle_tpu/nn/functional.py:783-962 and
:1158-1170, :1391-1576; ``pairwise_distance`` is the reference's
PairwiseDistance layer, nn/layers/distance.py:24)."""
import functools

import numpy as np
import torch

from ...amp.auto_cast import cast_inputs


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _softplus_abs(x):
    """log1p(exp(-|x|)), the stable tail of softplus."""
    return torch.log1p(torch.exp(-torch.abs(x)))


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, name=None):
    """Softmax cross entropy over ``axis``. Hard labels equal to
    ``ignore_index`` add nothing and are left out of the mean; ``weight``
    weighs each class, and the mean is then over the picked weights."""
    input, weight = cast_inputs("cross_entropy", input, weight)
    logp = (torch.log_softmax(input, dim=axis) if use_softmax
            else torch.log(input.clamp_min(1e-30)))
    if soft_label:
        return _reduce_loss(-(label * logp).sum(dim=axis), reduction)
    lbl = label.long()
    if lbl.dim() == logp.dim():
        lbl = lbl.squeeze(axis)
    valid = lbl != ignore_index
    picked = torch.take_along_dim(logp.movedim(axis, -1),
                                  lbl.clamp_min(0)[..., None], dim=-1)[..., 0]
    loss = torch.where(valid, -picked, 0.0)
    if weight is not None:
        wpc = torch.where(valid, weight[lbl.clamp_min(0)], 0.0)
        loss = loss * wpc
        if reduction == "mean":
            return loss.sum() / wpc.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.to(loss.dtype).sum().clamp_min(1.0)
    return _reduce_loss(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label, ignore_index=ignore_index,
                         reduction="none", axis=axis).unsqueeze(-1)
    if return_softmax:
        (logits,) = cast_inputs("softmax", logits)
        return loss, torch.softmax(logits, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean", name=None):
    """``input`` log-probabilities [N, C] or [N, C, d1, ...]."""
    input, weight = cast_inputs("nll_loss", input, weight)
    logp = input.movedim(1, -1) if input.dim() > 2 else input
    lbl = label.long()
    loss = -torch.take_along_dim(logp, lbl.clamp_min(0)[..., None], dim=-1)[..., 0]
    valid = lbl != ignore_index
    loss = torch.where(valid, loss, 0.0)
    if weight is not None:
        loss = loss * weight[lbl.clamp_min(0)]
    if reduction == "mean":
        denom = ((weight[lbl.clamp_min(0)] * valid).sum() if weight is not None
                 else valid.to(loss.dtype).sum())
        return loss.sum() / denom.clamp_min(1e-12)
    return _reduce_loss(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    input, label = cast_inputs("mse_loss", input, label)
    return _reduce_loss(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = cast_inputs("l1_loss", input, label)
    return _reduce_loss(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    input, label = cast_inputs("smooth_l1_loss", input, label)
    d = torch.abs(input - label)
    return _reduce_loss(torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta),
                        reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):
    input, label, weight = cast_inputs("bce", input, label, weight)
    p = torch.clamp(input, 1e-12, 1 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean",
                                     pos_weight=None, name=None):
    logit, label, weight, pos_weight = cast_inputs("bce_logits", logit, label, weight,
                                                   pos_weight)
    max_val = torch.clamp(-logit, min=0)
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (_softplus_abs(logit) + max_val)
    else:
        loss = (1 - label) * logit + _softplus_abs(logit) + max_val
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    input, label = cast_inputs("kl_div", input, label)
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):
    input, other, label = cast_inputs("margin_ranking_loss", input, other, label)
    return _reduce_loss(torch.clamp(-label * (input - other) + margin, min=0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean", name=None):
    input, label = cast_inputs("hinge_embedding_loss", input, label)
    return _reduce_loss(torch.where(label == 1, input, torch.clamp(margin - input, min=0)),
                        reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    logit, label, normalizer = cast_inputs("sigmoid_focal_loss", logit, label, normalizer)
    p = torch.sigmoid(logit)
    ce = (1 - label) * logit + _softplus_abs(logit) + torch.clamp(-logit, min=0)
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


def square_error_cost(input, label):
    input, label = cast_inputs("square_error_cost", input, label)
    return torch.square(input - label)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    anchor, positive = cast_inputs("npair_loss", anchor, positive)
    sim = anchor @ positive.T
    eq = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = eq / eq.sum(dim=1, keepdim=True)
    ce = -(tgt * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
    reg = l2_reg * (anchor.square().sum(dim=1).mean()
                    + positive.square().sum(dim=1).mean()) / 2
    return ce + reg


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - 2 |X n Y| / (|X| + |Y|), the label one-hot over input's last
    axis."""
    (input,) = cast_inputs("dice_loss", input)
    oh = (label[..., 0].long()[..., None]
          == torch.arange(input.shape[-1], device=input.device)).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * oh).sum(dim=dims)
    union = input.sum(dim=dims) + oh.sum(dim=dims)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def log_loss(input, label, epsilon=1e-4, name=None):
    input, label = cast_inputs("log_loss", input, label)
    return -(label * torch.log(input + epsilon)
             + (1.0 - label) * torch.log(1.0 - input + epsilon))


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``log_probs`` [T, B, C] (log-softmaxed here: idempotent on
    log-probabilities), labels [B, L]: ATen's alpha recursion (the
    reference runs its own as a scan). ``mean`` divides each sample's loss
    by its label length, then means over the batch."""
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    loss = torch.nn.functional.ctc_loss(lp, labels.long(), input_lengths.long(),
                                        label_lengths.long(), blank=int(blank),
                                        reduction="none")
    if norm_by_times:
        loss = loss / input_lengths.to(loss.dtype).clamp_min(1.0)
    if reduction == "mean":
        return (loss / label_lengths.to(loss.dtype).clamp_min(1.0)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@functools.lru_cache(maxsize=32)
def _hsigmoid_default_tree(num_classes):
    """(table, code, mask) [num_classes, depth] of the default tree: a
    complete binary heap over the classes (leaf c is node c + num_classes,
    internal node n's weight row n - 1)."""
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    table = np.zeros((num_classes, depth), np.int64)
    code = np.zeros((num_classes, depth), np.float32)
    mask = np.zeros((num_classes, depth), np.float32)
    for c in range(num_classes):
        node, path = c + num_classes, []
        while node > 1:
            path.append((node // 2, float(node & 1)))
            node //= 2
        for d, (n, bit) in enumerate(reversed(path)):
            table[c, d], code[c, d], mask[c, d] = n - 1, bit, 1.0
    return table, code, mask


def hsigmoid_loss(input, label, num_classes, weight, bias=None, path_table=None,
                  path_code=None, is_sparse=False, name=None):
    """Hierarchical sigmoid: the sum over a label's path of the BCE of each
    node's logit against the path's bit; the default tree, or a custom one
    from ``path_table``/``path_code`` [B, D] (a negative entry ends a
    path). [B, 1]."""
    input, weight, bias = cast_inputs("hsigmoid_loss", input, weight, bias)
    lab = label[:, 0] if label.dim() == 2 else label
    if path_table is None:
        table, code, mask = (torch.from_numpy(a).to(input.device)
                             for a in _hsigmoid_default_tree(int(num_classes)))
        rows, cd, valid = table[lab.long()], code[lab.long()], mask[lab.long()]
    else:
        rows = path_table.long().clamp_min(0)
        valid = (path_table >= 0).to(input.dtype)
        cd = path_code.to(input.dtype)
    logits = torch.einsum("bdf,bf->bd", weight[rows], input)
    if bias is not None:
        logits = logits + bias.reshape(-1)[rows]
    per = torch.clamp(logits, min=0) - logits * cd + _softplus_abs(logits)
    return (per * valid).sum(dim=1, keepdim=True)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The p-norm of x - y (+ epsilon) over the last axis."""
    x, y = cast_inputs("pairwise_distance", x, y)
    d = torch.abs(x - y) + epsilon
    if p == float("inf"):
        return torch.amax(d, dim=-1, keepdim=keepdim)
    return torch.pow(torch.pow(d, p).sum(dim=-1, keepdim=keepdim), 1.0 / p)
