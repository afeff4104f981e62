"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py:1-126):
``ClipGradByValue``, ``ClipGradByNorm`` (each gradient by its own norm),
``ClipGradByGlobalNorm`` (all of them by their joint norm),
``clip_grad_norm_`` and ``clip_by_norm``. An optimizer calls a clip's
``clip_arrays`` on its gradients; ``clip((param, grad) pairs)`` is the
dygraph form, which leaves a parameter with ``need_clip = False`` and a
missing gradient as they are.

``clip_arrays(grads, sum_sq=...)`` clips gradients that are blocks of
the whole ones (ZeRO's sharded gradients, distributed/spmd.py): the
norms read ``sum_sq(per-gradient sums of squares)``, which returns the
whole gradients' sums (the blocks' sums added over the ranks)."""
import torch


class ClipGradBase:
    def __call__(self, params_grads):
        """(param, grad) pairs -> the same pairs with clipped grads."""
        idx = [i for i, (p, g) in enumerate(params_grads)
               if g is not None and getattr(p, "need_clip", True)]
        if not idx:
            return list(params_grads)
        clipped = self.clip_arrays([params_grads[i][1] for i in idx])
        out = list(params_grads)
        for i, g in zip(idx, clipped):
            out[i] = (out[i][0], g)
        return out

    def clip_arrays(self, grads, sum_sq=None):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each element into [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def clip_arrays(self, grads, sum_sq=None):
        return [None if g is None else torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient g with an L2 norm above clip_norm becomes
    g * clip_norm / norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def clip_arrays(self, grads, sum_sq=None):
        sums = [None if g is None else torch.sum(torch.square(g)) for g in grads]
        if sum_sq is not None:
            live = [i for i, t in enumerate(sums) if t is not None]
            for i, t in zip(live, sum_sq([sums[i] for i in live])):
                sums[i] = t
        out = []
        for g, sq in zip(grads, sums):
            if g is None:
                out.append(None)
                continue
            n = torch.sqrt(sq)
            out.append(torch.where(n > self.clip_norm,
                                   g * (self.clip_norm / torch.clamp_min(n, 1e-12)), g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by clip_norm / max(global norm, clip_norm), the
    norm taken over all gradients as one float32 vector."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def clip_arrays(self, grads, sum_sq=None):
        if all(g is None for g in grads):
            return list(grads)
        sums = [torch.sum(torch.square(g.float())) for g in grads if g is not None]
        sq = sum(sums if sum_sq is None else sum_sq(sums))
        gnorm = torch.sqrt(sq)
        scale = self.clip_norm / torch.clamp_min(gnorm, self.clip_norm)
        return [None if g is None else (g * scale).to(g.dtype) for g in grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Clip the ``.grad`` of ``parameters`` in place by their global L2
    norm (as ClipGradByGlobalNorm) and return that norm, before clipping.
    The reference takes ``norm_type`` and ``error_if_nonfinite`` and reads
    neither (its norm is L2, nothing is checked): here any other value
    than the default raises."""
    if float(norm_type) != 2.0 or error_if_nonfinite:
        raise NotImplementedError("clip_grad_norm_: the reference clips by the L2 norm "
                                  "only and checks nothing")
    ps =[p for p in parameters if p.grad is not None]
    if not ps:
        return torch.zeros(())
    grads = [p.grad for p in ps]
    total = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    for p, g in zip(ps, ClipGradByGlobalNorm(max_norm).clip_arrays(grads)):
        p.grad = g
    return total


def clip_by_norm(x, max_norm, name=None):
    """x scaled to an L2 norm of at most ``max_norm`` (the norm in
    float32, the scale applied in x's dtype)."""
    norm = torch.sqrt(torch.sum(x.float() ** 2))
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return x * scale.to(x.dtype)
