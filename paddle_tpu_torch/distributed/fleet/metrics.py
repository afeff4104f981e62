"""Fleet distributed metrics (counterpart of
paddle_tpu/distributed/fleet/metrics.py; reference:
python/paddle/distributed/fleet/metrics/metric.py — global metric
reduction across trainers; the all_reduce rides UtilBase)."""
import numpy as np

from .util import UtilBase

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "mse", "acc"]

_util = UtilBase()


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x,
                      np.float64)


def sum(input, scope=None, util=None):  # noqa: A001
    return float((util or _util).all_reduce(_np(input).sum(), "sum"))


def max(input, scope=None, util=None):  # noqa: A001
    return float((util or _util).all_reduce(_np(input).max(), "max"))


def min(input, scope=None, util=None):  # noqa: A001
    return float((util or _util).all_reduce(_np(input).min(), "min"))


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Global AUC from per-trainer confusion bins (reference
    metric.py:142): bins are summed across trainers, then the ROC is
    integrated by trapezoid over thresholds."""
    u = util or _util
    pos = np.asarray(u.all_reduce(_np(stat_pos), "sum"), np.float64)
    neg = np.asarray(u.all_reduce(_np(stat_neg), "sum"), np.float64)
    # walk bins from the highest threshold down; the ROC starts at (0,0)
    new_pos = np.concatenate([[0.0], np.cumsum(pos[::-1])])
    new_neg = np.concatenate([[0.0], np.cumsum(neg[::-1])])
    total_pos = new_pos[-1]
    total_neg = new_neg[-1]
    if total_pos == 0 or total_neg == 0:
        return 0.5
    area = np.trapezoid(new_pos, new_neg) if hasattr(np, "trapezoid") \
        else np.trapz(new_pos, new_neg)
    return float(area / (total_pos * total_neg))


def mae(abserr, total_ins_num, scope=None, util=None):
    u = util or _util
    err = float(u.all_reduce(_np(abserr).sum(), "sum"))
    n = float(u.all_reduce(np.float64(total_ins_num), "sum"))
    return err / n if n else 0.0


def mse(sqrerr, total_ins_num, scope=None, util=None):
    u = util or _util
    err = float(u.all_reduce(_np(sqrerr).sum(), "sum"))
    n = float(u.all_reduce(np.float64(total_ins_num), "sum"))
    return err / n if n else 0.0


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    return float(np.sqrt(mse(sqrerr, total_ins_num, scope, util)))


def acc(correct, total, scope=None, util=None):
    u = util or _util
    c = float(u.all_reduce(_np(correct).sum(), "sum"))
    t = float(u.all_reduce(_np(total).sum(), "sum"))
    return c / t if t else 0.0
