"""Gradient clipping by global norm (counterpart of the
``ClipGradByGlobalNorm`` of paddle_tpu/nn/clip.py)."""
import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by clip_norm / max(global norm, clip_norm), the
    norm taken over all gradients as one float32 vector."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        """(param, grad) pairs -> the same pairs with clipped grads; params
        with ``need_clip = False`` and missing grads pass through."""
        idx = [i for i, (p, g) in enumerate(params_grads)
               if g is not None and getattr(p, "need_clip", True)]
        if not idx:
            return list(params_grads)
        clipped = self.clip_arrays([params_grads[i][1] for i in idx])
        out = list(params_grads)
        for i, g in zip(idx, clipped):
            out[i] = (out[i][0], g)
        return out

    def clip_arrays(self, grads):
        if all(g is None for g in grads):
            return list(grads)
        sq = sum(torch.sum(torch.square(g.float())) for g in grads if g is not None)
        gnorm = torch.sqrt(sq)
        scale = self.clip_norm / torch.clamp_min(gnorm, self.clip_norm)
        return [None if g is None else (g * scale).to(g.dtype) for g in grads]
