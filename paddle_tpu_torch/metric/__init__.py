"""paddle.metric (counterpart of paddle_tpu/metric): ``Metric``, ``Accuracy``
(top-k), ``Precision``, ``Recall``, ``Auc`` and ``accuracy``. They compute on
the host in numpy, as the reference does (its argsort order included), and
take Tensors or torch tensors on any place, or arrays; a Tensor they return
lies on the current place."""
import numpy as np
import torch

from ..core.tensor import to_tensor


def _np(x):
    """A host ndarray of a tensor (a bfloat16 one as its float32 upcast) or
    array-like."""
    if isinstance(x, torch.Tensor):
        t = torch.Tensor.detach(x).cpu()
        return torch.Tensor.numpy(t.float() if t.dtype == torch.bfloat16 else t)
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or "acc"
        self.maxk = max(self.topk)
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        idx = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1)
        correct = (idx == label_np[..., None]).astype(np.float32)
        return to_tensor(correct)

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0] if c.ndim > 0 else 1
        accs = []
        for k in self.topk:
            ck = c[..., :k].sum(-1)
            self.total[self.topk.index(k)] += float(ck.sum())
            self.count[self.topk.index(k)] += num
            accs.append(float(ck.sum()) / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds).reshape(-1)
        l = _np(labels).reshape(-1)
        pred_pos = p > 0.5
        self.tp += int(np.sum(pred_pos & (l == 1)))
        self.fp += int(np.sum(pred_pos & (l == 0)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds).reshape(-1)
        l = _np(labels).reshape(-1)
        pred_pos = p > 0.5
        self.tp += int(np.sum(pred_pos & (l == 1)))
        self.fn += int(np.sum(~pred_pos & (l == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels).reshape(-1)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None):
    """Functional accuracy (reference: fluid/layers/metric_op.py accuracy)."""
    pred_np = _np(input)
    label_np = _np(label)
    idx = np.argsort(-pred_np, axis=-1)[:, :k]
    if label_np.ndim == 2:
        label_np = label_np[:, 0]
    acc = float(np.mean(np.any(idx == label_np[:, None], axis=1)))
    return to_tensor(np.asarray([acc], np.float32))


from ..core.module_alias import alias_submodules as _alias

_alias(__name__, "metrics")
