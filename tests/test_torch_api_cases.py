"""The op cases of the ``paddle.*`` tensor namespace and the harness that
runs them, jax-free: tests/test_torch_tensor_api*.py hold the port
against the JAX package with them on the CPU, and chip_smoke.py's phase
15 (e) holds the port on the card against the port on the CPU.

A case is ``fn(P, T, R)``: ``P`` a package (``paddle_tpu`` or
``paddle_tpu_torch``), ``T(array, sg=True, dtype=None)`` its
``to_tensor`` (``sg=False`` makes a leaf that the harness differentiates
by), ``R`` a ``numpy.random.RandomState`` seeded from the case's name, so
both runs see the same inputs. ``_run`` seeds ``P``'s key stream the same
way, runs the case and takes ``P.grad`` of a seeded weighted sum of its
float outputs; ``check`` compares two runs.

Tolerances, relative to the largest magnitude of the wanted output:
- ``EXACT``: bitwise (integer, bool, index, manipulation and creation
  ops, and random ops built on bits or uniform);
- ``ELEM`` 1e-6: float32 elementwise ops (transcendental functions round
  differently from one library to another);
- ``RED`` 1e-5: reductions and linalg (other summation orders, LAPACK
  paths);
- ``ulp(n)``: within n float32 ulp element by element (the samplers
  whose ``erfinv`` or ``log`` differ).
A case gives one tolerance, or a list with one per output. Gradients are
held to the case's tolerance, and at least ``RED``.

Decompositions whose factors are defined up to sign or phase (``svd``,
``qr``, ``eig``, ``eigh``) are held through what is unique: singular and
eigen values, the products that rebuild the input, and |factors|. Random
ops draw one key each from the same seed on both sides: those built on
bits or uniform (``uniform``, ``rand``, ``randint``, ``randperm``,
``bernoulli``, ``multinomial``, ``poisson`` for rates below 10) are
bitwise; the standard normal samples of ``normal``/``randn``/
``standard_normal`` (``erfinv``) and ``exponential_`` (``log1p``) are
held to NORMAL_ULP and EXP_ULP float32 ulp, and a normal sample moved by
a mean and scaled by a std (``gaussian``, ``normal(mean, std)``) to ELEM,
as the elementwise op on top of it is.
"""
import zlib

import numpy as np
import torch

EXACT = ("exact", 0.0)
ELEM = ("rel", 1e-6)
RED = ("rel", 1e-5)


def ulp(n):
    return ("ulp", n)


class Case:
    def __init__(self, fn, tol=EXACT, grad=True):
        self.fn = fn
        self.tol = tol
        self.grad = grad


def _flat(out):
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res += _flat(o)
        return res
    return [out]


def _value(x):
    """(numpy value, dtype name) of an output of either package."""
    if isinstance(x, torch.Tensor):
        from paddle_tpu_torch import Tensor
        from paddle_tpu_torch.core.dtype import dtype_name

        return Tensor.numpy(x), dtype_name(x.dtype)
    if hasattr(x, "numpy") and hasattr(x, "dtype"):
        arr = np.asarray(x.numpy())
        name = np.dtype(x.dtype).name
        if name == "bfloat16":
            arr = arr.astype(np.float32)
        return arr, name
    if isinstance(x, np.ndarray):
        return x, x.dtype.name
    return x, type(x).__name__


def _compare(label, got, want, tol):
    g, gd = _value(got)
    w, wd = _value(want)
    assert gd == wd, f"{label}: dtype {gd} != reference {wd}"
    if not isinstance(w, np.ndarray):
        assert g == w, f"{label}: {g!r} != reference {w!r}"
        return
    g = np.asarray(g)
    assert g.shape == w.shape, f"{label}: shape {g.shape} != reference {w.shape}"
    kind, bound = tol
    if kind == "exact" or w.dtype.kind in "biu" or w.size == 0:
        ok = np.array_equal(g, w, equal_nan=w.dtype.kind in "fc")
        assert ok, f"{label}: not bitwise the reference's\n{g}\n{w}"
        return
    finite = np.isfinite(w)
    assert np.array_equal(np.isfinite(g), finite), f"{label}: non-finite entries differ"
    assert np.array_equal(g[~finite], w[~finite], equal_nan=True), f"{label}: inf/nan differ"
    if kind == "ulp":
        err = np.abs(g[finite].astype(np.float64) - w[finite])
        space = np.spacing(np.abs(w[finite]).astype(np.float32)).astype(np.float64)
        worst = float(np.max(err / space)) if err.size else 0.0
        assert worst <= bound, f"{label}: {worst} ulp > {bound}"
        return
    scale = float(np.max(np.abs(w[finite]))) if finite.any() else 0.0
    err = float(np.max(np.abs(g[finite].astype(np.complex128) - w[finite]))) if finite.any() \
        else 0.0
    assert err <= bound * max(scale, 1e-30), \
        f"{label}: max abs err {err:.3e} > {bound} x {scale:.3e}"


def _is_float(x):
    if isinstance(x, torch.Tensor):
        return x.dtype.is_floating_point
    return hasattr(x, "dtype") and np.dtype(x.dtype).kind == "f"


def _run(P, case, seed):
    made = []

    def T(a, sg=True, dtype=None):
        t = P.to_tensor(a, dtype=dtype, stop_gradient=sg)
        if not sg:
            made.append(t)
        return t

    P.seed(seed % 1000)
    out = case.fn(P, T, np.random.RandomState(seed))
    grads = None
    if case.grad and made:
        floats = [o for o in _flat(out) if _is_float(o) and not o.stop_gradient]
        if floats:
            wr = np.random.RandomState(seed + 1)
            loss = None
            for o in floats:
                w = wr.standard_normal(tuple(o.shape)).astype(np.float32)
                term = P.sum(P.multiply(o, P.to_tensor(w)))
                loss = term if loss is None else P.add(loss, term)
            grads = P.grad(loss, made, allow_unused=True)
    return out, grads


def check(name, case, run_got, run_want):
    """Run ``case`` through ``run_got`` and ``run_want`` (each ``lambda
    case, seed: _run(P, case, seed)`` for some package and device) and
    compare the outputs, dtypes and gradients at the case's tolerance."""
    seed = zlib.crc32(name.encode())
    got, ggrads = run_got(case, seed)
    want, wgrads = run_want(case, seed)
    gflat, wflat = _flat(got), _flat(want)
    assert len(gflat) == len(wflat), f"{name}: {len(gflat)} outputs != {len(wflat)}"
    for i, (g, w) in enumerate(zip(gflat, wflat)):
        _compare(f"{name} output {i}", g, w, case.tol[i] if isinstance(case.tol, list)
                 else case.tol)
    assert (ggrads is None) == (wgrads is None), f"{name}: only one side differentiates"
    if wgrads is not None:
        gtol = (case.tol if not isinstance(case.tol, list) and case.tol[0] == "rel"
                and case.tol[1] >= RED[1] else RED)
        for i, (g, w) in enumerate(zip(ggrads, wgrads)):
            assert (g is None) == (w is None), f"{name}: grad {i} reached one side only"
            if w is not None:
                _compare(f"{name} grad {i}", g, w, gtol)


def _n(R, *shape, lo=None, hi=None):
    if lo is not None:
        return R.uniform(lo, hi, shape).astype(np.float32)
    return R.standard_normal(shape).astype(np.float32)


def _i(R, *shape, lo=-5, hi=6):
    return R.randint(lo, hi, shape).astype(np.int32)


def _spd(R, n=4):
    a = _n(R, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


# ---------------------------------------------------------------- creation
CREATION = {
    "arange": Case(lambda P, T, R: (P.arange(1, 10, 2), P.arange(0.5, 3.0, 0.25), P.arange(5),
                                    P.arange(0, 1, 0.1))),
    "assign": Case(lambda P, T, R: (P.assign(T(_n(R, 3, 4), sg=False)),
                                    P.assign(_n(R, 2).astype(np.float64)))),
    "clone": Case(lambda P, T, R: P.clone(T(_n(R, 3, 4), sg=False))),
    "complex": Case(lambda P, T, R: P.complex(T(_n(R, 3)), T(_n(R, 3)))),
    "diag": Case(lambda P, T, R: (P.diag(T(_n(R, 3), sg=False)), P.diag(T(_n(R, 3)), offset=1),
                                  P.diag(T(_n(R, 3)), padding_value=2.0),
                                  P.diag(T(_n(R, 3, 4), sg=False), offset=-1))),
    "diagflat": Case(lambda P, T, R: P.diagflat(T(_n(R, 2, 2), sg=False), offset=1)),
    "empty": Case(lambda P, T, R: P.empty([2, 3]).shape, grad=False),
    "empty_like": Case(lambda P, T, R: P.empty_like(T(_n(R, 2, 3))).shape),
    "eye": Case(lambda P, T, R: (P.eye(3), P.eye(2, 4, dtype="int32"))),
    "full": Case(lambda P, T, R: (P.full([2, 3], 1.5), P.full([2], 7), P.full([2], True),
                                  P.full([2, 2], 3, dtype="float32"))),
    "full_like": Case(lambda P, T, R: (P.full_like(T(_n(R, 2, 3)), 2.5),
                                       P.full_like(T(_i(R, 3)), 4, dtype="float32"))),
    "linspace": Case(lambda P, T, R: (P.linspace(0, 1, 7), P.linspace(-2.5, 3.0, 5),
                                      P.linspace(1, 1, 1))),
    "meshgrid": Case(lambda P, T, R: P.meshgrid(T(_n(R, 3), sg=False), T(_n(R, 2), sg=False))),
    "numel": Case(lambda P, T, R: P.numel(T(_n(R, 3, 4)))),
    "ones": Case(lambda P, T, R: (P.ones([2, 3]), P.ones([3], dtype="int64"))),
    "ones_like": Case(lambda P, T, R: (P.ones_like(T(_n(R, 2, 3))), P.ones_like(T(_i(R, 3))))),
    "tril": Case(lambda P, T, R: (P.tril(T(_n(R, 4, 4), sg=False)),
                                  P.tril(T(_n(R, 3, 5)), diagonal=1))),
    "tril_indices": Case(lambda P, T, R: (P.tril_indices(4, 4), P.tril_indices(3, 5, 1))),
    "triu": Case(lambda P, T, R: (P.triu(T(_n(R, 4, 4), sg=False)),
                                  P.triu(T(_n(R, 3, 5)), diagonal=-1))),
    "triu_indices": Case(lambda P, T, R: (P.triu_indices(4), P.triu_indices(3, 5, 1))),
    "zeros": Case(lambda P, T, R: (P.zeros([2, 3]), P.zeros([2], dtype="bool"))),
    "zeros_like": Case(lambda P, T, R: P.zeros_like(T(_n(R, 2, 3)))),
    "create_parameter": Case(lambda P, T, R: (P.create_parameter([3, 4], "float32").shape,
                                              P.create_parameter([2], "float32",
                                                                 is_bias=True).numpy()),
                             grad=False),
}


# ---------------------------------------------------------------- math
def _bin(fn, lo=None, hi=None, ints=False):
    if ints:
        return Case(lambda P, T, R: getattr(P, fn)(T(_i(R, 3, 4, lo=1, hi=20)),
                                                   T(_i(R, 3, 4, lo=1, hi=20))))
    return Case(lambda P, T, R: (getattr(P, fn)(T(_n(R, 3, 4, lo=lo, hi=hi), sg=False),
                                                T(_n(R, 3, 4, lo=lo, hi=hi), sg=False)),
                                 getattr(P, fn)(T(_n(R, 3, 4, lo=lo, hi=hi)), 0.5)), tol=ELEM)


def _un(fn, lo=None, hi=None, tol=ELEM, grad=True):
    return Case(lambda P, T, R: (getattr(P, fn)(T(_n(R, 3, 4, lo=lo, hi=hi), sg=False)),
                                 getattr(P, fn)(T(_n(R, 5, lo=lo, hi=hi)))), tol=tol, grad=grad)


def _red(fn, data=None, grad=True):
    data = data or (lambda R: _n(R, 3, 4, 5))
    return Case(lambda P, T, R: (lambda x: (getattr(P, fn)(x), getattr(P, fn)(x, axis=1),
                                            getattr(P, fn)(x, axis=[0, 2], keepdim=True),
                                            getattr(P, fn)(x, axis=-1, keepdim=True)))(
        T(data(R), sg=False)), tol=RED, grad=grad)


MATH = {
    "abs": _un("abs"), "acos": _un("acos", -0.9, 0.9), "acosh": _un("acosh", 1.1, 4.0),
    "asin": _un("asin", -0.9, 0.9), "asinh": _un("asinh"), "atan": _un("atan"),
    "atanh": _un("atanh", -0.9, 0.9), "ceil": _un("ceil", grad=False),
    "cos": _un("cos"), "cosh": _un("cosh"), "deg2rad": _un("deg2rad"),
    "digamma": _un("digamma", 0.5, 4.0), "erf": _un("erf"), "erfinv": _un("erfinv", -0.9, 0.9),
    "exp": _un("exp"), "expm1": _un("expm1"), "floor": _un("floor", grad=False),
    "frac": _un("frac"), "i0": _un("i0", grad=False), "lgamma": _un("lgamma", 0.5, 4.0),
    "log": _un("log", 0.1, 5.0), "log10": _un("log10", 0.1, 5.0),
    "log1p": _un("log1p", -0.5, 5.0), "log2": _un("log2", 0.1, 5.0),
    "neg": _un("neg"), "rad2deg": _un("rad2deg"), "reciprocal": _un("reciprocal", 0.5, 3.0),
    "round": _un("round", grad=False), "rsqrt": _un("rsqrt", 0.2, 4.0),
    "sign": _un("sign"), "sin": _un("sin"), "sinh": _un("sinh"),
    "sqrt": _un("sqrt", 0.2, 4.0), "square": _un("square"), "tan": _un("tan", -1.2, 1.2),
    "tanh": _un("tanh"), "trunc": _un("trunc", grad=False),
    "angle": Case(lambda P, T, R: P.angle(T(_n(R, 3, 4))), tol=ELEM),
    "conj": Case(lambda P, T, R: (P.conj(T(_n(R, 3), sg=False)),
                                  P.conj(P.complex(T(_n(R, 3)), T(_n(R, 3)))))),
    "real": Case(lambda P, T, R: (P.real(P.complex(T(_n(R, 3)), T(_n(R, 3)))),
                                  P.real(T(_n(R, 3))))),
    "imag": Case(lambda P, T, R: (P.imag(P.complex(T(_n(R, 3)), T(_n(R, 3)))),
                                  P.imag(T(_n(R, 3))))),
    "add": _bin("add"), "subtract": _bin("subtract"), "multiply": _bin("multiply"),
    "maximum": _bin("maximum"), "minimum": _bin("minimum"), "fmax": _bin("fmax"),
    "fmin": _bin("fmin"), "logaddexp": _bin("logaddexp"), "atan2": _bin("atan2"),
    "copysign": _bin("copysign"), "nextafter": Case(lambda P, T, R: P.nextafter(
        T(_n(R, 3, 4)), T(_n(R, 3, 4)))),
    "heaviside": Case(lambda P, T, R: P.heaviside(T(np.array([-1.0, 0.0, 2.0], np.float32)),
                                                  T(np.array([0.5, 0.5, 0.5], np.float32)))),
    "mod": Case(lambda P, T, R: (P.mod(T(_n(R, 3, 4), sg=False), T(_n(R, 3, 4, lo=0.5, hi=2.0))),
                                 P.mod(T(_i(R, 3, 4)), T(_i(R, 3, 4, lo=1, hi=4)))), tol=ELEM),
    "remainder": Case(lambda P, T, R: P.remainder(T(_i(R, 3, 4)), T(_i(R, 3, 4, lo=1, hi=4)))),
    "floor_mod": Case(lambda P, T, R: P.floor_mod(T(_i(R, 3, 4)), T(_i(R, 3, 4, lo=-4, hi=-1)))),
    "floor_divide": Case(lambda P, T, R: P.floor_divide(T(_i(R, 3, 4)),
                                                        T(_i(R, 3, 4, lo=1, hi=4)))),
    "divide": Case(lambda P, T, R: (P.divide(T(_n(R, 3, 4), sg=False),
                                             T(_n(R, 3, 4, lo=0.5, hi=2.0), sg=False)),
                                    P.divide(T(_i(R, 3)), T(_i(R, 3, lo=1, hi=4))),
                                    P.divide(T(_n(R, 3)), 3.0)), tol=ELEM),
    "pow": Case(lambda P, T, R: (P.pow(T(_n(R, 3, 4, lo=0.5, hi=2.0), sg=False),
                                       T(_n(R, 3, 4), sg=False)),
                                 P.pow(T(_n(R, 3, 4), sg=False), 2),
                                 P.pow(T(_i(R, 3, lo=0, hi=5)), 3)), tol=ELEM),
    "gcd": _bin("gcd", ints=True), "lcm": _bin("lcm", ints=True),
    "inner": Case(lambda P, T, R: P.inner(T(_n(R, 3, 4), sg=False), T(_n(R, 2, 4), sg=False)),
                  tol=RED),
    "outer": Case(lambda P, T, R: P.outer(T(_n(R, 3), sg=False), T(_n(R, 4), sg=False)),
                  tol=ELEM),
    "kron": Case(lambda P, T, R: P.kron(T(_n(R, 2, 3), sg=False), T(_n(R, 2, 2), sg=False)),
                 tol=ELEM),
    "multiplex": Case(lambda P, T, R: P.multiplex(
        [T(_n(R, 4, 3), sg=False), T(_n(R, 4, 3), sg=False)],
        T(np.array([[0], [1], [1], [0]], np.int32)))),
    "scale": Case(lambda P, T, R: (P.scale(T(_n(R, 3, 4), sg=False), 2.0, 0.5),
                                   P.scale(T(_n(R, 3, 4)), 2.0, 0.5, bias_after_scale=False)),
                  tol=ELEM),
    "increment": Case(lambda P, T, R: P.increment(T(_n(R, 1)), 2.0), tol=ELEM),
    "clip": Case(lambda P, T, R: (P.clip(T(_n(R, 3, 4), sg=False), -0.5, 0.5),
                                  P.clip(T(_n(R, 3, 4)), min=0.0),
                                  P.clip(T(_n(R, 3, 4)), max=0.2)), tol=ELEM),
    "lerp": Case(lambda P, T, R: P.lerp(T(_n(R, 3, 4), sg=False), T(_n(R, 3, 4), sg=False),
                                        T(_n(R, 3, 4, lo=0.0, hi=1.0), sg=False)), tol=ELEM),
    "stanh": _un("stanh"),
    "rsqrt_": Case(lambda P, T, R: P.rsqrt_(T(_n(R, 3, lo=0.5, hi=2.0))), tol=ELEM),
    "sum": Case(lambda P, T, R: (lambda x: (P.sum(x), P.sum(x, axis=1), P.sum(x, axis=[0, 2],
                                                                             keepdim=True),
                                            P.sum(T(_i(R, 3, 4)), axis=0),
                                            P.sum(T(_i(R, 3, 4)) > 0),
                                            P.sum(x, dtype="float32")))(
        T(_n(R, 3, 4, 5), sg=False)), tol=RED),
    "mean": _red("mean"), "max": _red("max"), "min": _red("min"), "amax": _red("amax"),
    "amin": _red("amin"), "prod": _red("prod", lambda R: _n(R, 3, 4, 5, lo=0.5, hi=1.5)),
    "logsumexp": _red("logsumexp"),
    "nansum": _red("nansum", lambda R: np.where(_n(R, 3, 4, 5) > 1.0, np.nan,
                                                _n(R, 3, 4, 5)).astype(np.float32)),
    "nanmean": _red("nanmean", lambda R: np.where(_n(R, 3, 4, 5) > 1.0, np.nan,
                                                  _n(R, 3, 4, 5)).astype(np.float32)),
    "all": Case(lambda P, T, R: (lambda x: (P.all(x), P.all(x, axis=1), P.all(x, axis=[0, 2],
                                                                             keepdim=True)))(
        T(_n(R, 3, 4, 5) > -1.5))),
    "any": Case(lambda P, T, R: (lambda x: (P.any(x), P.any(x, axis=1), P.any(x, axis=[0, 2],
                                                                             keepdim=True)))(
        T(_n(R, 3, 4, 5) > 1.5))),
    "count_nonzero": Case(lambda P, T, R: (lambda x: (P.count_nonzero(x),
                                                      P.count_nonzero(x, axis=1),
                                                      P.count_nonzero(x, axis=1, keepdim=True)))(
        T(_i(R, 3, 4, lo=-1, hi=2)))),
    "cumsum": Case(lambda P, T, R: (P.cumsum(T(_n(R, 3, 4), sg=False)),
                                    P.cumsum(T(_n(R, 3, 4), sg=False), axis=1),
                                    P.cumsum(T(_i(R, 3, 4)), axis=0)), tol=RED),
    "cumprod": Case(lambda P, T, R: (P.cumprod(T(_n(R, 3, 4, lo=0.5, hi=1.5), sg=False), dim=1),
                                     P.cumprod(T(_i(R, 3, 4, lo=1, hi=3)), dim=0)), tol=RED),
    "cummax": Case(lambda P, T, R: (P.cummax(T(_n(R, 4, 5), sg=False), axis=1),
                                    P.cummax(T(_i(R, 6, lo=0, hi=3)), axis=0))),
    "cummin": Case(lambda P, T, R: (P.cummin(T(_n(R, 4, 5), sg=False), axis=1),
                                    P.cummin(T(_i(R, 6, lo=0, hi=3)), axis=0))),
    "matmul": Case(lambda P, T, R: (P.matmul(T(_n(R, 3, 4), sg=False), T(_n(R, 4, 5), sg=False)),
                                    P.matmul(T(_n(R, 2, 4, 3)), T(_n(R, 2, 5, 3)),
                                             transpose_y=True),
                                    P.matmul(T(_n(R, 4, 3)), T(_n(R, 4)), transpose_x=True)),
                   tol=RED),
    "mm": Case(lambda P, T, R: P.mm(T(_n(R, 3, 4), sg=False), T(_n(R, 4, 2), sg=False)), tol=RED),
    "bmm": Case(lambda P, T, R: P.bmm(T(_n(R, 2, 3, 4), sg=False), T(_n(R, 2, 4, 2), sg=False)),
                tol=RED),
    "dot": Case(lambda P, T, R: (P.dot(T(_n(R, 5), sg=False), T(_n(R, 5), sg=False)),
                                 P.dot(T(_n(R, 3, 5)), T(_n(R, 3, 5)))), tol=RED),
    "t": Case(lambda P, T, R: (P.t(T(_n(R, 3, 4), sg=False)), P.t(T(_n(R, 3))))),
    "addmm": Case(lambda P, T, R: P.addmm(T(_n(R, 3, 2), sg=False), T(_n(R, 3, 4), sg=False),
                                          T(_n(R, 4, 2), sg=False), beta=0.5, alpha=2.0),
                  tol=RED),
    "diff": Case(lambda P, T, R: (P.diff(T(_n(R, 3, 5), sg=False)),
                                  P.diff(T(_n(R, 3, 5)), n=2, axis=0),
                                  P.diff(T(_i(R, 6)), prepend=T(_i(R, 2)),
                                         append=T(_i(R, 1)))), tol=ELEM),
    "trace": Case(lambda P, T, R: (P.trace(T(_n(R, 4, 4), sg=False)),
                                   P.trace(T(_n(R, 2, 3, 4)), offset=1, axis1=1, axis2=2),
                                   P.trace(T(_i(R, 3, 3)))), tol=RED),
    "isfinite": Case(lambda P, T, R: P.isfinite(T(np.array([1.0, np.inf, -np.inf, np.nan],
                                                           np.float32)))),
    "isinf": Case(lambda P, T, R: P.isinf(T(np.array([1.0, np.inf, -np.inf, np.nan],
                                                     np.float32)))),
    "isnan": Case(lambda P, T, R: P.isnan(T(np.array([1.0, np.inf, -np.inf, np.nan],
                                                     np.float32)))),
    "nan_to_num": Case(lambda P, T, R: (
        P.nan_to_num(T(np.array([1.0, np.inf, -np.inf, np.nan], np.float32))),
        P.nan_to_num(T(np.array([1.0, np.inf, -np.inf, np.nan], np.float32)), nan=2.0,
                     posinf=9.0, neginf=-9.0))),
    "broadcast_shape": Case(lambda P, T, R: P.broadcast_shape([3, 1, 4], [5, 1])),
    "add_n": Case(lambda P, T, R: (P.add_n([T(_n(R, 3, 4), sg=False), T(_n(R, 3, 4), sg=False),
                                            T(_n(R, 3, 4))]), P.add_n(T(_n(R, 2)))), tol=ELEM),
}


MANIPULATION = {
    "as_complex": Case(lambda P, T, R: P.as_complex(T(_n(R, 3, 2)))),
    "as_real": Case(lambda P, T, R: P.as_real(P.complex(T(_n(R, 3)), T(_n(R, 3))))),
    "broadcast_tensors": Case(lambda P, T, R: P.broadcast_tensors(
        [T(_n(R, 3, 1), sg=False), T(_n(R, 1, 4), sg=False)])),
    "broadcast_to": Case(lambda P, T, R: P.broadcast_to(T(_n(R, 3, 1), sg=False), [2, 3, 4])),
    "cast": Case(lambda P, T, R: (P.cast(T(_n(R, 3, 4) * 3, sg=False), "int32"),
                                  P.cast(T(_i(R, 3, 4)), "float32"),
                                  P.cast(T(_i(R, 3)), "bool"),
                                  P.cast(T(_n(R, 3, 4), sg=False), "float64"),
                                  P.cast(T(_n(R, 3, 4)), "bfloat16"))),
    "chunk": Case(lambda P, T, R: P.chunk(T(_n(R, 6, 4), sg=False), 3, axis=0)),
    "concat": Case(lambda P, T, R: (P.concat([T(_n(R, 2, 3), sg=False), T(_n(R, 4, 3), sg=False)]),
                                    P.concat([T(_i(R, 2, 3)), T(_i(R, 2, 1))], axis=1))),
    "crop": Case(lambda P, T, R: P.crop(T(_n(R, 4, 5), sg=False), shape=[2, 3], offsets=[1, 1])),
    "crop_tensor": Case(lambda P, T, R: P.crop_tensor(T(_n(R, 4, 5), sg=False), shape=[2, -1],
                                                      offsets=[1, 2])),
    "expand": Case(lambda P, T, R: P.expand(T(_n(R, 3, 1), sg=False), [2, -1, 4])),
    "expand_as": Case(lambda P, T, R: P.expand_as(T(_n(R, 1, 4), sg=False), T(_n(R, 3, 4)))),
    "fill_diagonal": Case(lambda P, T, R: (P.fill_diagonal(T(_n(R, 4, 5)), 2.0),
                                           P.fill_diagonal(T(_n(R, 4, 5)), -1.0, offset=1),
                                           P.fill_diagonal(T(_n(R, 5, 4)), 3.0, offset=-2))),
    "flatten": Case(lambda P, T, R: (P.flatten(T(_n(R, 2, 3, 4), sg=False)),
                                     P.flatten(T(_n(R, 2, 3, 4)), 1, 2))),
    "flip": Case(lambda P, T, R: (P.flip(T(_n(R, 3, 4), sg=False), 0), P.flip(T(_i(R, 3, 4)),
                                                                             [0, 1]))),
    "reverse": Case(lambda P, T, R: P.reverse(T(_n(R, 3, 4), sg=False), 1)),
    "gather": Case(lambda P, T, R: (P.gather(T(_n(R, 5, 3), sg=False),
                                             T(np.array([0, 3, 3, 1], np.int32))),
                                    P.gather(T(_n(R, 3, 5)), T(np.array([4, 0], np.int32)),
                                             axis=1))),
    "gather_nd": Case(lambda P, T, R: P.gather_nd(T(_n(R, 3, 4, 2), sg=False),
                                                  T(np.array([[0, 1], [2, 3]], np.int32)))),
    "index_add": Case(lambda P, T, R: P.index_add(T(_n(R, 5, 3), sg=False),
                                                  T(np.array([0, 2, 2], np.int32)), 0,
                                                  T(_n(R, 3, 3), sg=False)), tol=ELEM),
    "index_sample": Case(lambda P, T, R: P.index_sample(T(_n(R, 3, 5), sg=False),
                                                        T(_i(R, 3, 2, lo=0, hi=5)))),
    "index_select": Case(lambda P, T, R: P.index_select(T(_n(R, 3, 5), sg=False),
                                                        T(np.array([4, 1], np.int32)), axis=1)),
    "masked_fill": Case(lambda P, T, R: P.masked_fill(T(_n(R, 3, 4), sg=False),
                                                      T(_n(R, 3, 4) > 0), 9.0)),
    "masked_select": Case(lambda P, T, R: P.masked_select(T(_n(R, 3, 4)), T(_n(R, 3, 4) > 0)),
                          grad=False),
    "moveaxis": Case(lambda P, T, R: P.moveaxis(T(_n(R, 2, 3, 4), sg=False), [0, 1], [2, 0])),
    "pad": Case(lambda P, T, R: (P.pad(T(_n(R, 1, 2, 3, 4), sg=False), [1, 2, 0, 1]),
                                 P.pad(T(_n(R, 1, 2, 3, 4)), [1, 1, 2, 0], mode="reflect"),
                                 P.pad(T(_n(R, 1, 2, 3, 4)), [1, 2, 1, 0], mode="replicate"),
                                 P.pad(T(_n(R, 1, 2, 3, 4)), [2, 1, 1, 2], mode="circular"),
                                 P.pad(T(_n(R, 2, 3)), [1, 0, 0, 2], value=5.0))),
    "put_along_axis": Case(lambda P, T, R: (
        P.put_along_axis(T(_n(R, 3, 4), sg=False), T(np.array([[1], [0], [3]], np.int32)),
                         T(_n(R, 3, 1), sg=False), 1),
        P.put_along_axis(T(_n(R, 3, 4)), T(np.array([[1], [0], [3]], np.int32)), 2.0, 1,
                         reduce="add"),
        P.put_along_axis(T(_n(R, 3, 4)), T(np.array([[1], [0], [3]], np.int32)), 2.0, 1,
                         reduce="multiply")), tol=ELEM),
    "repeat_interleave": Case(lambda P, T, R: (P.repeat_interleave(T(_n(R, 3, 2), sg=False), 2,
                                                                   axis=0),
                                               P.repeat_interleave(T(_i(R, 2, 2)), 3))),
    "reshape": Case(lambda P, T, R: (P.reshape(T(_n(R, 3, 4), sg=False), [2, -1]),
                                     P.reshape(T(_i(R, 3, 4)), (4, 3)))),
    "roll": Case(lambda P, T, R: (P.roll(T(_n(R, 3, 4), sg=False), 1, 0),
                                  P.roll(T(_n(R, 3, 4)), [1, -2], [0, 1]),
                                  P.roll(T(_i(R, 3, 4)), 5))),
    "rot90": Case(lambda P, T, R: (P.rot90(T(_n(R, 3, 4), sg=False)),
                                   P.rot90(T(_n(R, 2, 3, 4)), k=3, axes=(1, 2)))),
    "scatter": Case(lambda P, T, R: (P.scatter(T(_n(R, 5, 3), sg=False),
                                               T(np.array([1, 3], np.int32)),
                                               T(_n(R, 2, 3), sg=False)),
                                     P.scatter(T(_n(R, 5, 3)), T(np.array([1, 1, 3], np.int32)),
                                               T(_n(R, 3, 3)), overwrite=False)), tol=ELEM),
    "scatter_nd": Case(lambda P, T, R: P.scatter_nd(T(np.array([[1], [3], [1]], np.int32)),
                                                    T(_n(R, 3, 4), sg=False), [5, 4]), tol=ELEM),
    "scatter_nd_add": Case(lambda P, T, R: P.scatter_nd_add(
        T(_n(R, 4, 3), sg=False), T(np.array([[0, 1], [2, 2], [0, 1]], np.int32)),
        T(_n(R, 3), sg=False)), tol=ELEM),
    "shard_index": Case(lambda P, T, R: P.shard_index(T(_i(R, 6, 1, lo=0, hi=20)), 20, 4, 1)),
    "slice": Case(lambda P, T, R: P.slice(T(_n(R, 4, 5, 6), sg=False), [0, 2], [1, -4],
                                          [3, 100])),
    "split": Case(lambda P, T, R: (P.split(T(_n(R, 6, 4), sg=False), 2),
                                   P.split(T(_n(R, 3, 7)), [2, -1, 1], axis=1))),
    "squeeze": Case(lambda P, T, R: (P.squeeze(T(_n(R, 1, 3, 1), sg=False)),
                                     P.squeeze(T(_n(R, 1, 3, 1)), axis=[0, 1]),
                                     P.squeeze(T(_i(R, 1, 3)), axis=0))),
    "stack": Case(lambda P, T, R: (P.stack([T(_n(R, 3), sg=False), T(_n(R, 3), sg=False)]),
                                   P.stack([T(_i(R, 2, 3)), T(_i(R, 2, 3))], axis=2))),
    "strided_slice": Case(lambda P, T, R: (
        P.strided_slice(T(_n(R, 6, 7), sg=False), [0, 1], [1, 0], [6, 7], [2, 3]),
        P.strided_slice(T(_n(R, 6, 7)), [1], [5], [0], [-2]))),
    "swapaxes": Case(lambda P, T, R: P.swapaxes(T(_n(R, 2, 3, 4), sg=False), 0, 2)),
    "take_along_axis": Case(lambda P, T, R: P.take_along_axis(
        T(_n(R, 3, 4), sg=False), T(np.array([[0, 3], [1, 1], [2, 0]], np.int32)), 1)),
    "tile": Case(lambda P, T, R: (P.tile(T(_n(R, 2, 3), sg=False), [2, 1]),
                                  P.tile(T(_i(R, 3)), [2, 2]))),
    "tolist": Case(lambda P, T, R: (P.tolist(T(_i(R, 2, 3))), P.tolist(T(_n(R, 2))))),
    "transpose": Case(lambda P, T, R: P.transpose(T(_n(R, 2, 3, 4), sg=False), [2, 0, 1])),
    "transpose_": Case(lambda P, T, R: P.transpose_(T(_n(R, 2, 3), sg=False), [1, 0])),
    "unbind": Case(lambda P, T, R: P.unbind(T(_n(R, 3, 4), sg=False), axis=1)),
    "unique": Case(lambda P, T, R: (P.unique(T(_i(R, 12, lo=0, hi=5))),
                                    P.unique(T(_i(R, 12, lo=0, hi=5)), return_index=True,
                                             return_inverse=True, return_counts=True),
                                    P.unique(T(_n(R, 6).round(0))))),
    "unique_consecutive": Case(lambda P, T, R: (
        P.unique_consecutive(T(np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int32))),
        P.unique_consecutive(T(np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int32)),
                             return_inverse=True, return_counts=True))),
    "unsqueeze": Case(lambda P, T, R: (P.unsqueeze(T(_n(R, 3, 4), sg=False), 1),
                                       P.unsqueeze(T(_n(R, 3, 4)), [0, -1]),
                                       P.unsqueeze(T(_i(R, 3)), [0, 2]))),
    "unstack": Case(lambda P, T, R: P.unstack(T(_n(R, 3, 4), sg=False), axis=0)),
}

LOGIC = {
    "allclose": Case(lambda P, T, R: (lambda a: (P.allclose(a, a + 1e-7), P.allclose(a, a + 1)))(
        T(_n(R, 3, 4)))),
    "bitwise_and": Case(lambda P, T, R: P.bitwise_and(T(_i(R, 3, 4)), T(_i(R, 3, 4)))),
    "bitwise_not": Case(lambda P, T, R: P.bitwise_not(T(_i(R, 3, 4)))),
    "bitwise_or": Case(lambda P, T, R: P.bitwise_or(T(_i(R, 3, 4)), T(_i(R, 3, 4)))),
    "bitwise_xor": Case(lambda P, T, R: P.bitwise_xor(T(_i(R, 3, 4)), T(_i(R, 3, 4)))),
    "equal": Case(lambda P, T, R: (P.equal(T(_i(R, 3, 4, lo=0, hi=2)), T(_i(R, 3, 4, lo=0, hi=2))),
                                   P.equal(T(_i(R, 3)), 1))),
    "equal_all": Case(lambda P, T, R: (lambda a: (P.equal_all(a, a), P.equal_all(a, a + 1)))(
        T(_i(R, 3, 4)))),
    "greater_equal": Case(lambda P, T, R: P.greater_equal(T(_n(R, 3, 4)), T(_n(R, 3, 4)))),
    "greater_than": Case(lambda P, T, R: P.greater_than(T(_n(R, 3, 4)), 0.0)),
    "is_empty": Case(lambda P, T, R: (P.is_empty(T(_n(R, 3))), P.is_empty(T(_n(R, 0, 2))))),
    "is_tensor": Case(lambda P, T, R: (P.is_tensor(T(_n(R, 3))), P.is_tensor(_n(R, 3)))),
    "isclose": Case(lambda P, T, R: (lambda a: P.isclose(a, a + T(_n(R, 3, 4)) * 1e-6))(
        T(_n(R, 3, 4)))),
    "less_equal": Case(lambda P, T, R: P.less_equal(T(_i(R, 3, 4)), T(_i(R, 3, 4)))),
    "less_than": Case(lambda P, T, R: P.less_than(T(_n(R, 3, 4)), T(_n(R, 3, 4)))),
    "logical_and": Case(lambda P, T, R: P.logical_and(T(_n(R, 3, 4) > 0), T(_n(R, 3, 4) > 0))),
    "logical_not": Case(lambda P, T, R: P.logical_not(T(_n(R, 3, 4) > 0))),
    "logical_or": Case(lambda P, T, R: P.logical_or(T(_n(R, 3, 4) > 0), T(_n(R, 3, 4) > 0))),
    "logical_xor": Case(lambda P, T, R: P.logical_xor(T(_n(R, 3, 4) > 0), T(_n(R, 3, 4) > 0))),
    "not_equal": Case(lambda P, T, R: P.not_equal(T(_i(R, 3, 4, lo=0, hi=2)),
                                                  T(_i(R, 3, 4, lo=0, hi=2)))),
}

SEARCH = {
    "argmax": Case(lambda P, T, R: (lambda x: (P.argmax(x), P.argmax(x, axis=1),
                                               P.argmax(x, axis=0, keepdim=True)))(
        T(_i(R, 4, 5, lo=0, hi=3)))),
    "argmin": Case(lambda P, T, R: (lambda x: (P.argmin(x), P.argmin(x, axis=1),
                                               P.argmin(x, axis=0, keepdim=True)))(
        T(_n(R, 4, 5)))),
    "argsort": Case(lambda P, T, R: (P.argsort(T(_i(R, 4, 6, lo=0, hi=3))),
                                     P.argsort(T(_i(R, 4, 6, lo=0, hi=3)), axis=0,
                                               descending=True),
                                     P.argsort(T(_n(R, 7))))),
    "bucketize": Case(lambda P, T, R: (P.bucketize(T(_n(R, 3, 4)), T(np.sort(_n(R, 5)))),
                                       P.bucketize(T(np.array([1.0, 2.0], np.float32)),
                                                   T(np.array([0.0, 1.0, 2.0], np.float32)),
                                                   right=True))),
    "kthvalue": Case(lambda P, T, R: (P.kthvalue(T(_n(R, 4, 5), sg=False), 2),
                                      P.kthvalue(T(_i(R, 4, 5, lo=0, hi=3)), 3, axis=0,
                                                 keepdim=True))),
    "masked_select": Case(lambda P, T, R: P.masked_select(T(_i(R, 3, 4)), T(_n(R, 3, 4) > 0))),
    "mode": Case(lambda P, T, R: (P.mode(T(_i(R, 3, 7, lo=0, hi=3))),
                                  P.mode(T(_i(R, 5, 4, lo=0, hi=3)), axis=0, keepdim=True))),
    "nonzero": Case(lambda P, T, R: (P.nonzero(T(_i(R, 3, 4, lo=-1, hi=2))),
                                     P.nonzero(T(_i(R, 3, 4, lo=-1, hi=2)), as_tuple=True))),
    "searchsorted": Case(lambda P, T, R: (
        P.searchsorted(T(np.sort(_n(R, 6))), T(_n(R, 3, 4))),
        P.searchsorted(T(np.array([1, 2, 2, 4], np.int32)), T(np.array([2, 3, 5], np.int32)),
                       right=True))),
    "sort": Case(lambda P, T, R: (P.sort(T(_n(R, 4, 5), sg=False)),
                                  P.sort(T(_i(R, 4, 5)), axis=0, descending=True))),
    "topk": Case(lambda P, T, R: (P.topk(T(_n(R, 4, 6), sg=False), 3),
                                  P.topk(T(_i(R, 4, 6, lo=0, hi=3)), 2, axis=0),
                                  P.topk(T(_i(R, 4, 6, lo=0, hi=3)), 2, largest=False))),
    "where": Case(lambda P, T, R: (P.where(T(_n(R, 3, 4) > 0), T(_n(R, 3, 4), sg=False),
                                           T(_n(R, 3, 4), sg=False)),
                                   P.where(T(_i(R, 3, 4, lo=-1, hi=2))))),
}


NORMAL_ULP = 4
EXP_ULP = 2
POISSON_OFF = 0.02


def _svd(P, x):
    u, s, vh = P.svd(x)
    return s, P.matmul(P.matmul(u, P.diag(s)), vh), P.abs(u), P.abs(vh)


def _qr(P, x):
    q, r = P.qr(x)
    return P.matmul(q, r), P.abs(q), P.abs(r)


def _eigh(P, x):
    w, v = P.eigh(x)
    return w, P.abs(v)


def _eig(P, x):
    w, v = P.eig(x)
    order = np.lexsort((np.round(w.numpy().imag, 4), np.round(w.numpy().real, 4)))
    return w.numpy()[order]


LINALG = {
    "bincount": Case(lambda P, T, R: (P.bincount(T(_i(R, 12, lo=0, hi=6))),
                                      P.bincount(T(_i(R, 8, lo=0, hi=4)), T(_n(R, 8)),
                                                 minlength=6)), tol=RED),
    "bmm": Case(lambda P, T, R: P.bmm(T(_n(R, 2, 3, 4), sg=False), T(_n(R, 2, 4, 5), sg=False)),
                tol=RED),
    "cholesky": Case(lambda P, T, R: (P.cholesky(T(_spd(R), sg=False)),
                                      P.cholesky(T(_spd(R)), upper=True)), tol=RED),
    "cholesky_solve": Case(lambda P, T, R: P.cholesky_solve(
        T(_n(R, 4, 2), sg=False), P.cholesky(T(_spd(R)))), tol=RED),
    "cond": Case(lambda P, T, R: P.cond(T(_spd(R))), tol=RED, grad=False),
    "corrcoef": Case(lambda P, T, R: (P.corrcoef(T(_n(R, 3, 6), sg=False)),
                                      P.corrcoef(T(_n(R, 6, 3)), rowvar=False)), tol=RED),
    "cov": Case(lambda P, T, R: (P.cov(T(_n(R, 3, 6), sg=False)),
                                 P.cov(T(_n(R, 6, 3)), rowvar=False, ddof=False),
                                 P.cov(T(_n(R, 3, 6)), fweights=T(_i(R, 6, lo=1, hi=4)),
                                       aweights=T(_n(R, 6, lo=0.5, hi=1.5)))), tol=RED),
    "cross": Case(lambda P, T, R: (P.cross(T(_n(R, 4, 3), sg=False), T(_n(R, 4, 3), sg=False)),
                                   P.cross(T(_n(R, 3, 5)), T(_n(R, 3, 5)), axis=0)), tol=RED),
    "det": Case(lambda P, T, R: P.det(T(_spd(R), sg=False)), tol=RED),
    "dist": Case(lambda P, T, R: (P.dist(T(_n(R, 3, 4), sg=False), T(_n(R, 3, 4), sg=False)),
                                  P.dist(T(_n(R, 3, 4)), T(_n(R, 3, 4)), p=1),
                                  P.dist(T(_n(R, 3, 4)), T(_n(R, 3, 4)), p=float("inf")),
                                  P.dist(T(_n(R, 3, 4)), T(_n(R, 3, 4)), p=0)), tol=RED),
    "dot": Case(lambda P, T, R: P.dot(T(_n(R, 5), sg=False), T(_n(R, 5), sg=False)), tol=RED),
    "eig": Case(lambda P, T, R: _eig(P, T(_n(R, 4, 4))), tol=RED, grad=False),
    "eigh": Case(lambda P, T, R: _eigh(P, T(_spd(R), sg=False)), tol=RED),
    "eigvals": Case(lambda P, T, R: np.sort_complex(P.eigvals(T(_spd(R))).numpy()), tol=RED),
    "eigvalsh": Case(lambda P, T, R: P.eigvalsh(T(_spd(R), sg=False)), tol=RED),
    "histogram": Case(lambda P, T, R: (P.histogram(T(_n(R, 50)), bins=7),
                                       P.histogram(T(_n(R, 50)), bins=5, min=-1, max=1))),
    "inv": Case(lambda P, T, R: P.inv(T(_spd(R), sg=False)), tol=RED),
    "inverse": Case(lambda P, T, R: P.inverse(T(_spd(R), sg=False)), tol=RED),
    # an underdetermined system's residuals are 0 up to rounding on both
    # sides: its solution, rank and singular values are held
    "lstsq": Case(lambda P, T, R: (P.lstsq(T(_n(R, 6, 3)), T(_n(R, 6, 2))),
                                   [o for i, o in enumerate(P.lstsq(T(_n(R, 3, 5)),
                                                                    T(_n(R, 3, 2)))) if i != 1]),
                  tol=RED),
    "lu": Case(lambda P, T, R: P.lu(T(_n(R, 4, 4))), tol=RED, grad=False),
    "matmul": Case(lambda P, T, R: P.matmul(T(_n(R, 3, 4), sg=False), T(_n(R, 4, 2), sg=False)),
                   tol=RED),
    "matrix_power": Case(lambda P, T, R: (P.matrix_power(T(_n(R, 3, 3) / 2, sg=False), 3),
                                          P.matrix_power(T(_spd(R, 3)), -1)), tol=RED),
    "matrix_rank": Case(lambda P, T, R: (P.matrix_rank(T(_n(R, 4, 4))),
                                         P.matrix_rank(T(np.outer(_n(R, 4), _n(R, 4)))))),
    "multi_dot": Case(lambda P, T, R: P.multi_dot([T(_n(R, 3, 4), sg=False),
                                                   T(_n(R, 4, 5), sg=False),
                                                   T(_n(R, 5, 2), sg=False)]), tol=RED),
    "mv": Case(lambda P, T, R: P.mv(T(_n(R, 3, 4), sg=False), T(_n(R, 4), sg=False)), tol=RED),
    "norm": Case(lambda P, T, R: (lambda x: (P.norm(x), P.norm(x, p=2, axis=1),
                                             P.norm(x, p=1, axis=0, keepdim=True),
                                             P.norm(x, p=float("inf"), axis=1),
                                             P.norm(x, p=3, axis=[0, 1])))(
        T(_n(R, 3, 4), sg=False)), tol=RED),
    "pinv": Case(lambda P, T, R: P.pinv(T(_n(R, 4, 3), sg=False)), tol=RED),
    "qr": Case(lambda P, T, R: _qr(P, T(_n(R, 5, 3), sg=False)), tol=RED),
    "slogdet": Case(lambda P, T, R: P.slogdet(T(_spd(R), sg=False)), tol=RED),
    "solve": Case(lambda P, T, R: P.solve(T(_spd(R), sg=False), T(_n(R, 4, 2), sg=False)),
                  tol=RED),
    "svd": Case(lambda P, T, R: _svd(P, T(_n(R, 5, 3), sg=False)), tol=RED),
    "t": Case(lambda P, T, R: P.t(T(_n(R, 3, 4), sg=False))),
    "triangular_solve": Case(lambda P, T, R: (
        P.triangular_solve(T(np.triu(_spd(R)), sg=False), T(_n(R, 4, 2), sg=False)),
        P.triangular_solve(T(np.tril(_spd(R))), T(_n(R, 4, 2)), upper=False, transpose=True),
        P.triangular_solve(T(np.triu(_spd(R))), T(_n(R, 4, 2)), unitriangular=True)), tol=RED),
}

STAT = {
    "mean": Case(lambda P, T, R: (P.mean(T(_n(R, 3, 4), sg=False)), P.mean(T(_i(R, 3, 4)), 1)),
                 tol=RED),
    "median": Case(lambda P, T, R: (P.median(T(_n(R, 4, 6), sg=False)),
                                    P.median(T(_n(R, 4, 5)), axis=1),
                                    P.median(T(_n(R, 4, 6)), axis=0, keepdim=True)), tol=RED),
    "nanmedian": Case(lambda P, T, R: P.nanmedian(T(np.where(_n(R, 4, 6) > 1, np.nan, _n(R, 4, 6))
                                                    .astype(np.float32)), axis=1), tol=RED),
    "nanquantile": Case(lambda P, T, R: P.nanquantile(
        T(np.where(_n(R, 4, 6) > 1, np.nan, _n(R, 4, 6)).astype(np.float32)), 0.3, axis=1),
        tol=RED),
    "quantile": Case(lambda P, T, R: (P.quantile(T(_n(R, 4, 6), sg=False), 0.3),
                                      P.quantile(T(_n(R, 4, 6)), [0.1, 0.75], axis=1),
                                      P.quantile(T(_n(R, 4, 6)), 0.5, axis=0, keepdim=True)),
                     tol=RED),
    "std": Case(lambda P, T, R: (P.std(T(_n(R, 3, 4), sg=False)),
                                 P.std(T(_n(R, 3, 4)), axis=1, unbiased=False, keepdim=True)),
                tol=RED),
    "var": Case(lambda P, T, R: (P.var(T(_n(R, 3, 4), sg=False)),
                                 P.var(T(_n(R, 3, 4)), axis=[0, 1], unbiased=False)), tol=RED),
}

RANDOM = {
    "bernoulli": Case(lambda P, T, R: P.bernoulli(T(_n(R, 4, 5, lo=0.0, hi=1.0))), grad=False),
    "check_shape": Case(lambda P, T, R: (P.tensor.random.check_shape([2, 3]),
                                         P.tensor.random.check_shape(T(_i(R, 2, lo=1, hi=4))))),
    "exponential_": Case(lambda P, T, R: P.exponential_(T(_n(R, 4, 5)), lam=2.0),
                         tol=ulp(EXP_ULP)),
    "gaussian": Case(lambda P, T, R: P.gaussian([4, 5], mean=1.0, std=2.0), tol=ELEM),
    "multinomial": Case(lambda P, T, R: (P.multinomial(T(_n(R, 3, 6, lo=0.1, hi=1.0)), 4),
                                         P.multinomial(T(_n(R, 3, 6, lo=0.1, hi=1.0)), 5,
                                                       replacement=True))),
    "normal": Case(lambda P, T, R: (P.normal(0.0, 1.0, [3, 4]), P.normal(0.5, 2.0, [3, 4]),
                                    P.normal(T(_n(R, 3, 4)), T(_n(R, 3, 4, lo=0.5, hi=1.0)))),
                   tol=[ulp(NORMAL_ULP), ELEM, ELEM]),
    "poisson": Case(lambda P, T, R: P.poisson(T(_n(R, 6, 8, lo=0.0, hi=9.0)))),
    "rand": Case(lambda P, T, R: P.rand([4, 5])),
    "randint": Case(lambda P, T, R: (P.randint(0, 10, [4, 5]), P.randint(-7, 3, [6]),
                                     P.randint(100))),
    "randint_like": Case(lambda P, T, R: P.randint_like(T(_i(R, 3, 4)), 0, 50)),
    "randn": Case(lambda P, T, R: P.randn([4, 5]), tol=ulp(NORMAL_ULP)),
    "randperm": Case(lambda P, T, R: (P.randperm(10), P.randperm(7, dtype="int32"))),
    "standard_normal": Case(lambda P, T, R: P.standard_normal([4, 5]), tol=ulp(NORMAL_ULP)),
    "uniform": Case(lambda P, T, R: (P.uniform([4, 5]), P.uniform([3], min=2.0, max=5.0))),
}

OTHER = {
    "einsum": Case(lambda P, T, R: (P.einsum("ij,jk->ik", T(_n(R, 3, 4), sg=False),
                                             T(_n(R, 4, 2), sg=False)),
                                    P.einsum("bij->bji", T(_n(R, 2, 3, 4)))), tol=RED),
    "is_complex": Case(lambda P, T, R: (P.is_complex(T(_n(R, 3))),
                                        P.is_complex(P.complex(T(_n(R, 3)), T(_n(R, 3)))))),
    "is_floating_point": Case(lambda P, T, R: (P.is_floating_point(T(_n(R, 3))),
                                               P.is_floating_point(T(_i(R, 3))))),
    "is_integer": Case(lambda P, T, R: (P.is_integer(T(_n(R, 3))), P.is_integer(T(_i(R, 3))))),
    "rank": Case(lambda P, T, R: P.rank(T(_n(R, 2, 3, 4)))),
    "shape": Case(lambda P, T, R: P.shape(T(_n(R, 2, 3, 4)))),
    "set_printoptions": Case(lambda P, T, R: (P.set_printoptions(precision=4), str(
        np.array2string(np.float32([1.234567]))), P.set_printoptions(precision=8))),
}


ALL = {**CREATION, **MATH, **MANIPULATION, **LOGIC, **SEARCH, **LINALG, **STAT, **RANDOM,
       **OTHER}


def test_every_case_names_a_port_function():
    import paddle_tpu_torch as tp

    missing = [n for n in ALL if not callable(getattr(tp, n, None))
               and not callable(getattr(tp.tensor.random, n, None))]
    assert not missing, missing
