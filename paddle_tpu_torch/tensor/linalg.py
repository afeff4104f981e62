"""Linear algebra (counterpart of paddle_tpu/tensor/linalg.py): the
products and solvers the reference leaves to XLA go to ``torch.linalg``.
``lstsq`` is computed from the SVD as jax computes it (torch's CUDA
``lstsq`` gives no rank or singular values), and ``histogram`` bins as
``jnp.histogram`` does."""
import numpy as np
import torch

from ..core.dispatch import apply
from .math import _f, bmm, dot, matmul, t  # noqa: F401

_I32 = torch.int32


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def _norm(x):
        dims = tuple(range(x.dim())) if ax is None else ax
        if p == "fro" or (p == 2 and ax is None):
            return torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=keepdim))
        if p == float("inf"):
            return torch.amax(torch.abs(x), dim=dims, keepdim=keepdim)
        if p == float("-inf"):
            return torch.amin(torch.abs(x), dim=dims, keepdim=keepdim)
        if p == 0:
            return torch.sum((x != 0).to(x.dtype), dim=dims, keepdim=keepdim)
        return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dims, keepdim=keepdim),
                         1.0 / p)

    return apply("p_norm", _norm, x)


def cond(x, p=None, name=None):
    return apply("cond", lambda x: torch.linalg.cond(x, p), x)


def cholesky(x, upper=False, name=None):
    return apply("cholesky", lambda x: torch.linalg.cholesky(x, upper=bool(upper)), x)


def cholesky_solve(x, y, upper=False, name=None):
    return apply("cholesky_solve", lambda x, y: torch.cholesky_solve(x, y, upper=bool(upper)),
                 x, y)


def inverse(x, name=None):
    return apply("inverse", torch.linalg.inv, x)


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply("pinv", lambda x: torch.linalg.pinv(x, rtol=float(rcond),
                                                     hermitian=bool(hermitian)), x)


def det(x, name=None):
    return apply("det", torch.linalg.det, x)


def slogdet(x, name=None):
    return apply("slogdet", lambda x: torch.stack(tuple(torch.linalg.slogdet(x))), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply("matrix_rank", lambda x: torch.linalg.matrix_rank(
        x, rtol=tol, hermitian=bool(hermitian)).to(_I32), x)


def matrix_power(x, n, name=None):
    return apply("matrix_power", lambda x: torch.linalg.matrix_power(x, int(n)), x)


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return apply("qr", lambda x: torch.linalg.qr(x, mode="r")[1], x)
    return apply("qr", lambda x: tuple(torch.linalg.qr(x, mode=mode)), x)


def svd(x, full_matrices=False, name=None):
    return apply("svd", lambda x: tuple(torch.linalg.svd(x, full_matrices=bool(full_matrices))),
                 x)


def eig(x, name=None):
    return apply("eig", lambda x: tuple(torch.linalg.eig(x)), x)


def eigh(x, UPLO="L", name=None):
    return apply("eigh", lambda x: tuple(torch.linalg.eigh(x, UPLO=UPLO)), x)


def eigvals(x, name=None):
    return apply("eigvals", torch.linalg.eigvals, x)


def eigvalsh(x, UPLO="L", name=None):
    return apply("eigvalsh", lambda x: torch.linalg.eigvalsh(x, UPLO=UPLO), x)


def solve(x, y, name=None):
    return apply("solve", torch.linalg.solve, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False, name=None):
    def _ts(x, y):
        a, up = (x.mT, not upper) if transpose else (x, upper)
        return torch.linalg.solve_triangular(a, y, upper=bool(up),
                                             unitriangular=bool(unitriangular))

    return apply("triangular_solve", _ts, x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """jnp.linalg.lstsq: the SVD solution, the squared residual norms of
    every column (jax returns them in all cases), the rank and the
    singular values."""

    def _lstsq(a, b):
        m, n = a.shape[-2], a.shape[-1]
        rc = float(np.finfo(np.float32).eps) * max(n, m) if rcond is None else rcond
        vec = b.dim() == 1
        if vec:
            b = b[:, None]
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        mask = (s > 0) & (s >= torch.as_tensor(rc, dtype=s.dtype, device=s.device) * s[0])
        rank = mask.sum().to(_I32)
        safe_s = torch.where(mask, s, torch.ones_like(s))
        s_inv = torch.where(mask, 1 / safe_s, torch.zeros_like(s))[:, None]
        sol = torch.matmul(vh.conj().mT, s_inv * torch.matmul(u.conj().mT, b))
        resid = torch.linalg.vector_norm(b - torch.matmul(a, sol), dim=0) ** 2
        if vec:
            sol = sol.reshape(-1)
        return sol, resid, rank, s

    return apply("lstsq", _lstsq, x, y)


def lu(x, pivot=True, get_infos=False, name=None):
    outs = apply("lu", lambda x: (lambda lu_p: (lu_p[0], lu_p[1].to(_I32)))(
        torch.linalg.lu_factor(x)), x)
    if get_infos:
        from .creation import zeros

        return outs[0], outs[1], zeros([1], "int32")
    return outs


def multi_dot(x, name=None):
    return apply("multi_dot", lambda *xs: torch.linalg.multi_dot(xs), *x)


def histogram(input, bins=100, min=0, max=0, name=None):
    def _hist(x):
        x = _f(x).reshape(-1)
        lo, hi = (x.min(), x.max()) if (min == 0 and max == 0) else (
            torch.tensor(float(min), device=x.device), torch.tensor(float(max), device=x.device))
        lo, hi = lo.to(torch.float32), hi.to(torch.float32)
        if bool(lo == hi):
            lo, hi = lo - 0.5, hi + 0.5
        step = torch.arange(int(bins), dtype=torch.float32, device=x.device) * float(
            np.float32(1) / np.float32(int(bins)))
        edges = torch.cat([lo * (1 - step) + hi * step, hi[None]])
        idx = torch.searchsorted(edges, x.to(torch.float32), right=True)
        idx = torch.where(x == edges[-1], len(edges) - 1, idx)
        counts = torch.bincount(idx, minlength=len(edges) + 1)[:len(edges)]
        return counts[1:].to(_I32)

    return apply("histogram", _hist, input)


def bincount(x, weights=None, minlength=0, name=None):
    def _bincount(x, w):
        x = x.reshape(-1).long()
        length = max(int(x.max()) + 1 if x.numel() else 0, int(minlength))
        out = torch.bincount(x, None if w is None else w.reshape(-1), minlength=length)
        return out if w is None else out.to(w.dtype)

    return apply("bincount", _bincount, x, weights)


def cross(x, y, axis=9, name=None):
    def _cross(x, y):
        ax = axis
        if ax == 9:
            ax = next((i for i, s in enumerate(x.shape) if s == 3), -1)
        return torch.linalg.cross(x, y, dim=ax)

    return apply("cross", _cross, x, y)


def corrcoef(x, rowvar=True, name=None):
    return apply("corrcoef", lambda x: torch.corrcoef(x if rowvar else x.mT), x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply("cov", lambda x, fw, aw: torch.cov(x if rowvar else x.mT,
                                                    correction=1 if ddof else 0,
                                                    fweights=None if fw is None else fw.long(),
                                                    aweights=aw), x, fweights, aweights)


def dist(x, y, p=2, name=None):
    """p-norm of (x - y) (reference: tensor/linalg.py:446)."""
    p = float(p)

    def _dist(x, y):
        d = torch.abs(x - y)
        if p == float("inf"):
            return torch.amax(d)
        if p == float("-inf"):
            return torch.amin(d)
        if p == 0:
            return torch.sum((d != 0).to(x.dtype)).to(x.dtype)
        return torch.sum(d ** p) ** (1.0 / p)

    return apply("dist", _dist, x, y)


def mv(x, vec, name=None):
    """Matrix-vector product [M,N]x[N]->[M] (reference: linalg.py:882)."""
    return apply("mv", torch.matmul, x, vec)
