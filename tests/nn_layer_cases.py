"""The cases of the layer zoo (paddle.nn.functional and the nn layer
classes), jax-free, in tests/test_torch_api_cases.py's form: a case is
``fn(P, T, R)`` with ``P`` a package, ``T`` its to_tensor (``sg=False``
makes a leaf the harness differentiates by) and ``R`` a numpy RandomState
seeded from the case's name, so both packages see the same inputs. A layer
case builds the layer in ``P`` and fills its parameters and buffers from
``R`` in the order of their sorted names (``layer``), so both packages
hold the same values. tests/test_torch_nn_layers.py,
tests/test_torch_nn_conv_pool_loss.py and
tests/test_torch_nn_layer_classes.py run them against the JAX package.

Tolerances, relative to the largest magnitude of the wanted output (the
harness's):
- ``EXACT``: integer outputs (argmax masks, sequence masks) and the ops
  that only move or pick values (pooling's max, pads, shuffles, dropout by
  the bitwise key stream);
- ``ELEM`` 1e-6: elementwise float32 ops;
- ``RED`` 1e-5: convolutions, norms, losses, resampling and every other
  op that sums (another summation order in ATen than in XLA);
- ``LOOSE`` 1e-4: the ops whose sums run through a transcendental before
  they are compared (the batch norms' 3-call running statistics, CTC's
  log-space recursion, the spectral norm's power iteration).
Gradients are held to the case's tolerance and at least RED.
"""
import numpy as np

from test_torch_api_cases import ELEM, EXACT, RED, Case

LOOSE = ("rel", 1e-4)


def n(R, *shape, lo=None, hi=None):
    if lo is not None:
        return R.uniform(lo, hi, shape).astype(np.float32)
    return R.standard_normal(shape).astype(np.float32)


def F(P):
    return P.nn.functional


def layer(P, R, cls, *args, **kw):
    """``P.nn.<cls>(*args, **kw)``, its floating parameters and buffers drawn
    from ``R`` by sorted name (variances positive)."""
    m = getattr(P.nn, cls)(*args, **kw)
    state = {}
    for name, v in sorted(m.state_dict().items()):
        shape = tuple(v.shape)
        state[name] = (R.uniform(0.5, 1.5, shape) if name.endswith("_variance")
                       else 0.5 * R.standard_normal(shape)).astype(np.float32)
    m.set_state_dict(state)
    return m


def ties(R, *shape):
    """Values in {0, 1, 2}: windows full of equal maxima."""
    return R.randint(0, 3, shape).astype(np.float32)


def _act(fn, tol=ELEM, **kw):
    return Case(lambda P, T, R: getattr(F(P), fn)(T(n(R, 3, 4, 5), sg=False), **kw), tol=tol)


# ---------------------------------------------------------------- activations
ACTIVATION = {
    "relu": _act("relu"), "relu6": Case(lambda P, T, R: F(P).relu6(T(n(R, 3, 4) * 5, sg=False))),
    "sigmoid": _act("sigmoid"), "tanh": _act("tanh"), "silu": _act("silu"),
    "swish": _act("swish"), "mish": _act("mish"), "tanhshrink": _act("tanhshrink"),
    "softsign": _act("softsign"), "log_sigmoid": _act("log_sigmoid"),
    "gelu": Case(lambda P, T, R: (F(P).gelu(T(n(R, 3, 4), sg=False)),
                                  F(P).gelu(T(n(R, 3, 4), sg=False), approximate=True)), tol=ELEM),
    "leaky_relu": _act("leaky_relu", negative_slope=0.2), "elu": _act("elu", alpha=0.7),
    "celu": _act("celu", alpha=1.3), "selu": _act("selu"),
    "hardshrink": _act("hardshrink", threshold=0.4), "softshrink": _act("softshrink"),
    "hardsigmoid": Case(lambda P, T, R: F(P).hardsigmoid(T(n(R, 3, 4) * 4, sg=False)),
                        tol=ELEM),
    "hardswish": Case(lambda P, T, R: F(P).hardswish(T(n(R, 3, 4) * 4, sg=False)), tol=ELEM),
    "hardtanh": _act("hardtanh", min=-0.5, max=0.7),
    "prelu": Case(lambda P, T, R: (
        F(P).prelu(T(n(R, 2, 3, 4, 4), sg=False), T(n(R, 3), sg=False)),
        F(P).prelu(T(n(R, 2, 4, 4, 3), sg=False), T(n(R, 3), sg=False), data_format="NHWC"),
        F(P).prelu(T(n(R, 2, 3), sg=False), T(n(R, 1), sg=False))), tol=ELEM),
    "softplus": Case(lambda P, T, R: (F(P).softplus(T(n(R, 3, 4) * 8, sg=False)),
                                      F(P).softplus(T(n(R, 3, 4), sg=False), beta=2,
                                                    threshold=1.5)), tol=ELEM),
    "maxout": Case(lambda P, T, R: (F(P).maxout(T(n(R, 2, 6, 3), sg=False), 3),
                                    F(P).maxout(T(n(R, 2, 3, 4), sg=False), 2, axis=-1))),
    "thresholded_relu": _act("thresholded_relu", threshold=0.3),
    "glu": Case(lambda P, T, R: (F(P).glu(T(n(R, 3, 4), sg=False)),
                                 F(P).glu(T(n(R, 4, 3), sg=False), axis=0)), tol=ELEM),
    "softmax": Case(lambda P, T, R: (F(P).softmax(T(n(R, 3, 4), sg=False)),
                                     F(P).softmax(T(n(R, 3, 4), sg=False), axis=0,
                                                  dtype="float32")), tol=ELEM),
    "log_softmax": Case(lambda P, T, R: F(P).log_softmax(T(n(R, 3, 4), sg=False), axis=1,
                                                         dtype="float32"), tol=ELEM),
    "gumbel_softmax": Case(lambda P, T, R: (
        F(P).gumbel_softmax(T(n(R, 3, 5), sg=False), temperature=0.7),
        F(P).gumbel_softmax(T(n(R, 3, 5), sg=False), hard=True)), tol=RED),
    "relu_": Case(lambda P, T, R: F(P).relu_(T(n(R, 3, 4))), tol=ELEM, grad=False),
    "elu_": Case(lambda P, T, R: F(P).elu_(T(n(R, 3, 4))), tol=ELEM, grad=False),
    "tanh_": Case(lambda P, T, R: F(P).tanh_(T(n(R, 3, 4))), tol=ELEM, grad=False),
    "softmax_": Case(lambda P, T, R: F(P).softmax_(T(n(R, 3, 4))), tol=ELEM, grad=False),
}


# ---------------------------------------------------------------- common
def _interp(P, T, R):
    x = T(n(R, 2, 3, 5, 6), sg=False)
    f = F(P).interpolate
    return (f(x, size=[7, 9]), f(x, size=[3, 4]), f(x, scale_factor=2, mode="bilinear"),
            f(x, size=[4, 8], mode="bilinear", align_corners=True),
            f(x, size=[8, 4], mode="nearest", align_corners=True),
            f(T(n(R, 2, 5, 6, 3), sg=False), size=[7, 4], mode="bilinear", data_format="NHWC"),
            f(x, size=[9, 11], mode="bicubic"), f(x, size=[3, 4], mode="area"))


COMMON = {
    "linear": Case(lambda P, T, R: (F(P).linear(T(n(R, 3, 4), sg=False), T(n(R, 4, 5), sg=False),
                                                T(n(R, 5), sg=False)),
                                    F(P).linear(T(n(R, 2, 3, 4)), T(n(R, 4, 2), sg=False))),
                   tol=RED),
    "embedding": Case(lambda P, T, R: (
        F(P).embedding(T(R.randint(0, 6, (2, 3)).astype(np.int32)), T(n(R, 6, 4), sg=False),
                       padding_idx=2),
        F(P).embedding(T(R.randint(0, 6, (4,)).astype(np.int32)), T(n(R, 6, 4), sg=False),
                       sparse=True)), tol=EXACT),
    "one_hot": Case(lambda P, T, R: F(P).one_hot(T(R.randint(0, 5, (2, 3)).astype(np.int32)), 5)),
    "label_smooth": Case(lambda P, T, R: (
        F(P).label_smooth(T(n(R, 2, 4, lo=0, hi=1), sg=False)),
        F(P).label_smooth(T(n(R, 2, 4, lo=0, hi=1), sg=False), T(n(R, 4, lo=0, hi=1)), 0.2)),
        tol=ELEM),
    "dropout": Case(lambda P, T, R: (
        F(P).dropout(T(n(R, 4, 5), sg=False), 0.3),
        F(P).dropout(T(n(R, 4, 5, 2), sg=False), 0.5, axis=[0, 2]),
        F(P).dropout(T(n(R, 4, 5), sg=False), 0.4, mode="downscale_in_infer"),
        F(P).dropout(T(n(R, 4, 5), sg=False), 0.4, training=False, mode="downscale_in_infer"),
        F(P).dropout(T(n(R, 4, 5), sg=False), 0.4, training=False)), tol=ELEM),
    "dropout2d": Case(lambda P, T, R: (
        F(P).dropout2d(T(n(R, 2, 3, 4, 4), sg=False), 0.5),
        F(P).dropout2d(T(n(R, 2, 4, 4, 3), sg=False), 0.5, data_format="NHWC")), tol=ELEM),
    "dropout3d": Case(lambda P, T, R: F(P).dropout3d(T(n(R, 2, 3, 2, 2, 2), sg=False), 0.5),
                      tol=ELEM),
    "alpha_dropout": Case(lambda P, T, R: (F(P).alpha_dropout(T(n(R, 5, 6), sg=False), 0.3),
                                           F(P).alpha_dropout(T(n(R, 3), sg=False), 0.3,
                                                              training=False)), tol=ELEM),
    "interpolate": Case(_interp, tol=RED),
    "upsample": Case(lambda P, T, R: F(P).upsample(T(n(R, 1, 2, 3, 3), sg=False),
                                                   scale_factor=2, mode="bilinear"), tol=RED),
    "pixel_shuffle": Case(lambda P, T, R: F(P).pixel_shuffle(T(n(R, 2, 8, 3, 3), sg=False), 2)),
    "unfold": Case(lambda P, T, R: (F(P).unfold(T(n(R, 2, 3, 6, 5), sg=False), 3),
                                    F(P).unfold(T(n(R, 1, 2, 7, 7), sg=False), [2, 3], strides=2,
                                                paddings=1, dilations=[1, 2]))),
    "grid_sample": Case(lambda P, T, R: (
        F(P).grid_sample(T(n(R, 2, 3, 5, 6), sg=False), T(n(R, 2, 4, 3, 2, lo=-1.2, hi=1.2))),
        F(P).grid_sample(T(n(R, 1, 2, 4, 4), sg=False), T(n(R, 1, 3, 3, 2, lo=-1, hi=1)),
                         align_corners=False)), tol=RED),
    "affine_grid": Case(lambda P, T, R: (F(P).affine_grid(T(n(R, 2, 2, 3), sg=False), [2, 3, 4, 5]),
                                         F(P).affine_grid(T(n(R, 1, 2, 3), sg=False), [1, 1, 3, 3],
                                                          align_corners=False)), tol=RED),
    "temporal_shift": Case(lambda P, T, R: F(P).temporal_shift(T(n(R, 6, 8, 2, 2), sg=False), 3)),
    "bilinear": Case(lambda P, T, R: (
        F(P).bilinear(T(n(R, 3, 4), sg=False), T(n(R, 3, 5), sg=False), T(n(R, 2, 4, 5), sg=False),
                      T(n(R, 1, 2), sg=False)),
        F(P).bilinear(T(n(R, 3, 4)), T(n(R, 3, 5)), T(n(R, 2, 4, 5), sg=False))), tol=RED),
    "cosine_similarity": Case(lambda P, T, R: (
        F(P).cosine_similarity(T(n(R, 3, 4), sg=False), T(n(R, 3, 4), sg=False)),
        F(P).cosine_similarity(T(n(R, 3, 4), sg=False), T(n(R, 3, 4)), axis=0)), tol=RED),
    "pad": Case(lambda P, T, R: (F(P).pad(T(n(R, 2, 3, 4, 4), sg=False), [1, 2, 0, 1]),
                                 F(P).pad(T(n(R, 2, 3, 4), sg=False), [2, 1], mode="reflect",
                                          data_format="NCL"),
                                 F(P).pad(T(n(R, 1, 2, 3, 3), sg=False), [1, 1, 1, 1],
                                          value=2.5))),
    "unstack": Case(lambda P, T, R: (F(P).unstack(T(n(R, 3, 4), sg=False)),
                                     F(P).unstack(T(n(R, 3, 4), sg=False), axis=1))),
    "diag_embed": Case(lambda P, T, R: (F(P).diag_embed(T(n(R, 2, 3), sg=False)),
                                        F(P).diag_embed(T(n(R, 3), sg=False), offset=1))),
    "sequence_mask": Case(lambda P, T, R: (
        F(P).sequence_mask(T(np.array([1, 3, 0, 2], np.int32))),
        F(P).sequence_mask(T(np.array([[2, 4]], np.int32)), maxlen=5, dtype="float32"))),
    "normalize": Case(lambda P, T, R: (F(P).normalize(T(n(R, 3, 4), sg=False)),
                                       F(P).normalize(T(n(R, 3, 4), sg=False), p=1, axis=0)),
                      tol=RED),
}


# ---------------------------------------------------------------- conv
def _w(R, *shape):
    return n(R, *shape) * 0.3


CONV = {
    "conv1d": Case(lambda P, T, R: (
        F(P).conv1d(T(n(R, 2, 3, 9), sg=False), T(_w(R, 4, 3, 3), sg=False),
                    T(n(R, 4), sg=False), padding=1),
        F(P).conv1d(T(n(R, 2, 9, 4), sg=False), T(_w(R, 2, 2, 3), sg=False), stride=2,
                    padding="SAME", groups=2, data_format="NLC")), tol=RED),
    "conv2d": Case(lambda P, T, R: (
        F(P).conv2d(T(n(R, 2, 3, 8, 7), sg=False), T(_w(R, 4, 3, 3, 3), sg=False),
                    T(n(R, 4), sg=False), padding=1),
        F(P).conv2d(T(n(R, 2, 3, 8, 7), sg=False), T(_w(R, 4, 3, 3, 2), sg=False), stride=2,
                    padding="SAME"),
        F(P).conv2d(T(n(R, 2, 3, 8, 7), sg=False), T(_w(R, 4, 3, 3, 3), sg=False),
                    padding=[0, 2, 1, 0], dilation=2),
        F(P).conv2d(T(n(R, 1, 4, 6, 6), sg=False), T(_w(R, 4, 2, 3, 3), sg=False),
                    padding=[[1, 0], [2, 1]], groups=2, stride=[1, 2]),
        F(P).conv2d(T(n(R, 2, 7, 6, 3), sg=False), T(_w(R, 5, 3, 3, 3), sg=False),
                    T(n(R, 5), sg=False), padding="VALID", data_format="NHWC"),
        F(P).conv2d(T(n(R, 1, 4, 7, 7), sg=False), T(_w(R, 4, 1, 3, 3), sg=False), stride=2,
                    padding=1, groups=4)), tol=RED),
    "conv3d": Case(lambda P, T, R: (
        F(P).conv3d(T(n(R, 1, 2, 5, 4, 4), sg=False), T(_w(R, 3, 2, 3, 3, 3), sg=False),
                    T(n(R, 3), sg=False), padding=1),
        F(P).conv3d(T(n(R, 1, 5, 4, 4, 2), sg=False), T(_w(R, 2, 2, 2, 2, 2), sg=False),
                    stride=2, padding="SAME", data_format="NDHWC")), tol=RED),
    "conv1d_transpose": Case(lambda P, T, R: (
        F(P).conv1d_transpose(T(n(R, 2, 3, 5), sg=False), T(_w(R, 3, 4, 3), sg=False),
                              T(n(R, 4), sg=False), stride=2, padding=1, output_padding=1),
        F(P).conv1d_transpose(T(n(R, 2, 5, 4), sg=False), T(_w(R, 4, 1, 3), sg=False),
                              stride=2, groups=2, data_format="NLC")), tol=RED),
    "conv2d_transpose": Case(lambda P, T, R: (
        F(P).conv2d_transpose(T(n(R, 2, 3, 4, 5), sg=False), T(_w(R, 3, 4, 3, 3), sg=False),
                              T(n(R, 4), sg=False), stride=2, padding=1),
        F(P).conv2d_transpose(T(n(R, 2, 3, 4, 5), sg=False), T(_w(R, 3, 2, 3, 3), sg=False),
                              stride=2, padding=1, output_size=[8, 10]),
        F(P).conv2d_transpose(T(n(R, 1, 4, 3, 3), sg=False), T(_w(R, 4, 1, 2, 3), sg=False),
                              stride=[2, 3], padding=[[1, 0], [0, 2]], output_padding=1,
                              groups=2),
        F(P).conv2d_transpose(T(n(R, 1, 3, 4, 2), sg=False), T(_w(R, 2, 3, 3, 3), sg=False),
                              dilation=2, data_format="NHWC"),
        F(P).conv2d_transpose(T(n(R, 1, 2, 3, 3), sg=False), T(_w(R, 2, 2, 4, 4), sg=False),
                              stride=2, padding=[0, 2, 1, 1])), tol=RED),
    "conv3d_transpose": Case(lambda P, T, R: F(P).conv3d_transpose(
        T(n(R, 1, 2, 3, 3, 2), sg=False), T(_w(R, 2, 3, 2, 2, 2), sg=False),
        T(n(R, 3), sg=False), stride=2, padding=[1, 0, 0], output_size=[5, 6, 4]), tol=RED),
}


# ---------------------------------------------------------------- pooling
POOLING = {
    "max_pool1d": Case(lambda P, T, R: (
        F(P).max_pool1d(T(n(R, 2, 3, 9), sg=False), 3, 2, padding=1),
        F(P).max_pool1d(T(ties(R, 2, 3, 8)), 3, 2, return_mask=True, ceil_mode=True))),
    "max_pool2d": Case(lambda P, T, R: (
        F(P).max_pool2d(T(n(R, 2, 3, 8, 7), sg=False), 3, 2, padding=1),
        F(P).max_pool2d(F(P).relu(T(n(R, 2, 3, 8, 8), sg=False)), 3, 2, padding=1),
        F(P).max_pool2d(T(ties(R, 2, 3, 7, 7), sg=False), 2, ceil_mode=True),
        F(P).max_pool2d(T(ties(R, 1, 2, 6, 7)), 3, 2, padding=1, return_mask=True),
        F(P).max_pool2d(T(ties(R, 1, 2, 7, 5)), [3, 2], [2, 1],
                        padding=[[2, 0], [1, 1]], return_mask=True),
        F(P).max_pool2d(T(n(R, 2, 6, 6, 3), sg=False), 2, padding="SAME", data_format="NHWC"),
        F(P).max_pool2d(T(n(R, 1, 2, 7, 7), sg=False), 3, 3, padding=[1, 0, 0, 1]))),
    "max_pool3d": Case(lambda P, T, R: (
        F(P).max_pool3d(T(n(R, 1, 2, 5, 4, 4), sg=False), 2, ceil_mode=True),
        F(P).max_pool3d(T(ties(R, 1, 2, 4, 4, 4)), 3, 2, padding=1, return_mask=True))),
    "avg_pool1d": Case(lambda P, T, R: (
        F(P).avg_pool1d(T(n(R, 2, 3, 9), sg=False), 3, 2, padding=1),
        F(P).avg_pool1d(T(n(R, 2, 3, 9), sg=False), 3, 2, padding=1, exclusive=False),
        F(P).avg_pool1d(T(n(R, 2, 3, 8), sg=False), 3, 2, ceil_mode=True)), tol=RED),
    "avg_pool2d": Case(lambda P, T, R: (
        F(P).avg_pool2d(T(n(R, 2, 3, 8, 7), sg=False), 3, 2, padding=1),
        F(P).avg_pool2d(T(n(R, 2, 3, 8, 7), sg=False), 3, 2, padding=1, exclusive=False),
        F(P).avg_pool2d(T(n(R, 2, 3, 7, 7), sg=False), 2, ceil_mode=True),
        F(P).avg_pool2d(T(n(R, 2, 3, 6, 6), sg=False), 2, divisor_override=3),
        F(P).avg_pool2d(T(n(R, 2, 6, 5, 3), sg=False), 3, 2, padding="SAME",
                        data_format="NHWC"),
        F(P).avg_pool2d(T(n(R, 1, 2, 7, 7), sg=False), 3, 2, padding=[[1, 2], [0, 1]])),
        tol=RED),
    "avg_pool3d": Case(lambda P, T, R: (
        F(P).avg_pool3d(T(n(R, 1, 2, 5, 4, 4), sg=False), 2, padding=1),
        F(P).avg_pool3d(T(n(R, 1, 2, 5, 4, 4), sg=False), 3, 2, ceil_mode=True,
                        divisor_override=5)), tol=RED),
    "adaptive_avg_pool1d": Case(lambda P, T, R: (
        F(P).adaptive_avg_pool1d(T(n(R, 2, 3, 8), sg=False), 4),
        F(P).adaptive_avg_pool1d(T(n(R, 2, 3, 7), sg=False), 3)), tol=RED),
    "adaptive_avg_pool2d": Case(lambda P, T, R: (
        F(P).adaptive_avg_pool2d(T(n(R, 2, 3, 8, 6), sg=False), [4, 3]),
        F(P).adaptive_avg_pool2d(T(n(R, 2, 3, 7, 5), sg=False), 3),
        F(P).adaptive_avg_pool2d(T(n(R, 2, 5, 6, 3), sg=False), 1, data_format="NHWC")),
        tol=RED),
    "adaptive_avg_pool3d": Case(lambda P, T, R: F(P).adaptive_avg_pool3d(
        T(n(R, 1, 2, 5, 4, 6), sg=False), [2, 2, 3]), tol=RED),
    "adaptive_max_pool1d": Case(lambda P, T, R: (
        F(P).adaptive_max_pool1d(T(n(R, 2, 3, 8), sg=False), 4),
        F(P).adaptive_max_pool1d(T(n(R, 2, 3, 7), sg=False), 3, return_mask=True))),
    "adaptive_max_pool2d": Case(lambda P, T, R: (
        F(P).adaptive_max_pool2d(T(n(R, 2, 3, 8, 6), sg=False), [4, 3]),
        F(P).adaptive_max_pool2d(T(n(R, 2, 3, 7, 5), sg=False), 3, return_mask=True))),
    "adaptive_max_pool3d": Case(lambda P, T, R: (
        F(P).adaptive_max_pool3d(T(n(R, 1, 2, 4, 4, 6), sg=False), [2, 2, 3]),
        F(P).adaptive_max_pool3d(T(n(R, 1, 2, 5, 4, 4), sg=False), 2, return_mask=True))),
}


# ---------------------------------------------------------------- norms
def _bn_train(P, T, R):
    x = T(n(R, 4, 3, 5, 5) * 2 + 1, sg=False)
    rm, rv = T(n(R, 3)), T(n(R, 3, lo=0.5, hi=1.5))
    y = F(P).batch_norm(x, rm, rv, T(n(R, 3), sg=False), T(n(R, 3), sg=False), training=True,
                        momentum=0.8)
    y2 = F(P).batch_norm(T(n(R, 4, 5, 3), sg=False), T(n(R, 3)), T(n(R, 3, lo=0.5, hi=1.5)),
                         training=True, data_format="NLC")
    return y, y2, P.assign(rm), P.assign(rv)


NORM = {
    "batch_norm": Case(lambda P, T, R: (
        _bn_train(P, T, R),
        F(P).batch_norm(T(n(R, 2, 3, 4, 4), sg=False), T(n(R, 3)), T(n(R, 3, lo=0.5, hi=1.5)),
                        T(n(R, 3), sg=False), T(n(R, 3), sg=False)),
        F(P).batch_norm(T(n(R, 6, 4), sg=False), T(n(R, 4)), T(n(R, 4, lo=0.5, hi=1.5)),
                        training=True, use_global_stats=True)), tol=RED),
    "layer_norm": Case(lambda P, T, R: (
        F(P).layer_norm(T(n(R, 2, 3, 4), sg=False), 4, T(n(R, 4), sg=False), T(n(R, 4), sg=False)),
        F(P).layer_norm(T(n(R, 2, 3, 4), sg=False), [3, 4], epsilon=1e-3)), tol=RED),
    "instance_norm": Case(lambda P, T, R: (
        F(P).instance_norm(T(n(R, 2, 3, 4, 5), sg=False), weight=T(n(R, 3), sg=False),
                           bias=T(n(R, 3), sg=False)),
        F(P).instance_norm(T(n(R, 2, 3, 6), sg=False), eps=1e-3)), tol=RED),
    "group_norm": Case(lambda P, T, R: (
        F(P).group_norm(T(n(R, 2, 6, 3, 3), sg=False), 3, weight=T(n(R, 6), sg=False),
                        bias=T(n(R, 6), sg=False)),
        F(P).group_norm(T(n(R, 2, 4, 5), sg=False), 2, epsilon=1e-3)), tol=RED),
    "local_response_norm": Case(lambda P, T, R: (
        F(P).local_response_norm(T(n(R, 2, 6, 3, 3), sg=False), 3),
        F(P).local_response_norm(T(n(R, 2, 5, 4), sg=False), 4, alpha=0.1, beta=0.5, k=2.0)),
        tol=RED),
}


# ---------------------------------------------------------------- losses
def _labels(R, *shape, c):
    return R.randint(0, c, shape).astype(np.int32)


def _probs(R, *shape):
    return n(R, *shape, lo=0.05, hi=0.95)


def _ctc(P, T, R):
    lp = T(n(R, 8, 2, 5), sg=False)
    labels = T(np.array([[1, 2, 2], [3, 1, 0]], np.int32))
    in_len, lab_len = T(np.array([8, 6], np.int32)), T(np.array([3, 2], np.int32))
    f = F(P).ctc_loss
    return (f(lp, labels, in_len, lab_len), f(lp, labels, in_len, lab_len, reduction="sum"),
            f(lp, labels, in_len, lab_len, reduction="none", norm_by_times=True))


LOSS = {
    "cross_entropy": Case(lambda P, T, R: (
        F(P).cross_entropy(T(n(R, 4, 5), sg=False), T(_labels(R, 4, 1, c=5))),
        F(P).cross_entropy(T(n(R, 4, 5), sg=False), T(np.array([1, -100, 3, 0], np.int32)),
                           weight=T(n(R, 5, lo=0.5, hi=2))),
        F(P).cross_entropy(T(n(R, 4, 5), sg=False), T(np.array([2, 1, 4, 4], np.int32)),
                           ignore_index=4, reduction="sum"),
        F(P).cross_entropy(T(n(R, 4, 5), sg=False), T(_probs(R, 4, 5)), soft_label=True,
                           reduction="none"),
        # the class axis given as 1 of 2 (the reference's take_along_axis
        # picks the right logit only when the class axis is the last)
        F(P).cross_entropy(T(n(R, 3, 5), sg=False), T(_labels(R, 3, c=5)), axis=1),
        F(P).cross_entropy(T(_probs(R, 3, 4), sg=False), T(_labels(R, 3, c=4)),
                           use_softmax=False)), tol=RED),
    "softmax_with_cross_entropy": Case(lambda P, T, R: (
        F(P).softmax_with_cross_entropy(T(n(R, 4, 5), sg=False), T(_labels(R, 4, 1, c=5))),
        F(P).softmax_with_cross_entropy(T(n(R, 4, 5), sg=False), T(_labels(R, 4, 1, c=5)),
                                        return_softmax=True)), tol=RED),
    "nll_loss": Case(lambda P, T, R: (
        F(P).nll_loss(T(n(R, 4, 5), sg=False), T(_labels(R, 4, c=5))),
        F(P).nll_loss(T(n(R, 2, 5, 3, 2), sg=False), T(_labels(R, 2, 3, 2, c=5)),
                      weight=T(n(R, 5, lo=0.5, hi=2)), reduction="mean"),
        F(P).nll_loss(T(n(R, 4, 5), sg=False), T(np.array([1, -100, 0, 2], np.int32)),
                      reduction="sum")), tol=RED),
    "mse_loss": Case(lambda P, T, R: (F(P).mse_loss(T(n(R, 3, 4), sg=False), T(n(R, 3, 4))),
                                      F(P).mse_loss(T(n(R, 3, 4), sg=False), T(n(R, 3, 4)),
                                                    reduction="none")), tol=RED),
    "l1_loss": Case(lambda P, T, R: F(P).l1_loss(T(n(R, 3, 4), sg=False), T(n(R, 3, 4)),
                                                 reduction="sum"), tol=RED),
    "smooth_l1_loss": Case(lambda P, T, R: F(P).smooth_l1_loss(
        T(n(R, 3, 4) * 2, sg=False), T(n(R, 3, 4)), delta=0.7), tol=RED),
    "binary_cross_entropy": Case(lambda P, T, R: (
        F(P).binary_cross_entropy(T(_probs(R, 3, 4), sg=False), T(_probs(R, 3, 4))),
        F(P).binary_cross_entropy(T(_probs(R, 3, 4), sg=False), T(_probs(R, 3, 4)),
                                  weight=T(_probs(R, 3, 4)), reduction="none")), tol=RED),
    "binary_cross_entropy_with_logits": Case(lambda P, T, R: (
        F(P).binary_cross_entropy_with_logits(T(n(R, 3, 4), sg=False), T(_probs(R, 3, 4))),
        F(P).binary_cross_entropy_with_logits(T(n(R, 3, 4), sg=False), T(_probs(R, 3, 4)),
                                              weight=T(_probs(R, 3, 4)),
                                              pos_weight=T(_probs(R, 4)), reduction="sum")),
        tol=RED),
    "kl_div": Case(lambda P, T, R: (
        F(P).kl_div(T(n(R, 3, 4), sg=False), T(_probs(R, 3, 4))),
        F(P).kl_div(T(n(R, 3, 4), sg=False), T(_probs(R, 3, 4)), reduction="batchmean")),
        tol=RED),
    "margin_ranking_loss": Case(lambda P, T, R: F(P).margin_ranking_loss(
        T(n(R, 5), sg=False), T(n(R, 5), sg=False),
        T(np.sign(n(R, 5)).astype(np.float32)), margin=0.1), tol=RED),
    "hinge_embedding_loss": Case(lambda P, T, R: F(P).hinge_embedding_loss(
        T(n(R, 6), sg=False), T(np.array([1, -1, 1, -1, -1, 1], np.float32)), margin=0.5),
        tol=RED),
    "sigmoid_focal_loss": Case(lambda P, T, R: (
        F(P).sigmoid_focal_loss(T(n(R, 3, 4), sg=False),
                                T(R.randint(0, 2, (3, 4)).astype(np.float32))),
        F(P).sigmoid_focal_loss(T(n(R, 3, 4), sg=False),
                                T(R.randint(0, 2, (3, 4)).astype(np.float32)),
                                normalizer=T(np.array([2.0], np.float32)), reduction="mean")),
        tol=RED),
    "square_error_cost": Case(lambda P, T, R: F(P).square_error_cost(T(n(R, 3, 4), sg=False),
                                                                     T(n(R, 3, 4))), tol=ELEM),
    "npair_loss": Case(lambda P, T, R: F(P).npair_loss(
        T(n(R, 4, 3), sg=False), T(n(R, 4, 3), sg=False),
        T(np.array([0, 1, 0, 2], np.float32))), tol=RED),
    "dice_loss": Case(lambda P, T, R: F(P).dice_loss(
        T(_probs(R, 3, 4, 5), sg=False), T(_labels(R, 3, 4, 1, c=5))), tol=RED),
    "log_loss": Case(lambda P, T, R: F(P).log_loss(T(_probs(R, 4, 1), sg=False),
                                                   T(_probs(R, 4, 1))), tol=RED),
    "ctc_loss": Case(_ctc, tol=LOOSE),
    "hsigmoid_loss": Case(lambda P, T, R: (
        F(P).hsigmoid_loss(T(n(R, 4, 3), sg=False), T(_labels(R, 4, 1, c=6)), 6,
                           T(n(R, 5, 3), sg=False), T(n(R, 5, 1), sg=False)),
        F(P).hsigmoid_loss(T(n(R, 2, 3), sg=False), T(_labels(R, 2, c=4)), 4,
                           T(n(R, 3, 3), sg=False),
                           path_table=T(np.array([[0, 1, -1], [0, 2, 1]], np.int64)),
                           path_code=T(np.array([[1, 0, 0], [0, 1, 1]], np.int64)))), tol=RED),
}


# ---------------------------------------------------------------- layers
def _layer_case(cls, args, kw=None, shape=(2, 3, 6, 6), tol=RED, inputs=1, x=None):
    def fn(P, T, R):
        m = layer(P, R, cls, *args, **(kw or {}))
        xs = [T(x(R) if x else n(R, *shape), sg=False) for _ in range(inputs)]
        return m(*xs)

    return Case(fn, tol=tol)


def _acts():
    cases = {}
    for cls in ("ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish", "Hardswish",
                "Hardsigmoid", "Softsign", "Tanhshrink", "LogSigmoid", "SELU"):
        cases[cls] = _layer_case(cls, (), shape=(3, 4), tol=ELEM)
    for cls, kw in (("GELU", dict(approximate=True)), ("LeakyReLU", dict(negative_slope=0.1)),
                    ("ELU", dict(alpha=0.5)), ("CELU", dict(alpha=2.0)),
                    ("Hardshrink", dict(threshold=0.3)), ("Softshrink", dict(threshold=0.2)),
                    ("Hardtanh", dict(min=-0.3, max=0.4)), ("Softplus", dict(beta=3)),
                    ("Softmax", dict(axis=0)), ("LogSoftmax", {}),
                    ("ThresholdedReLU", dict(threshold=0.2))):
        cases[cls] = _layer_case(cls, (), kw, shape=(3, 4), tol=ELEM)
    cases["PReLU"] = _layer_case("PReLU", (3,), dict(init=0.1), shape=(2, 3, 4), tol=ELEM)
    cases["Maxout"] = _layer_case("Maxout", (2,), shape=(2, 4, 3), tol=EXACT)
    return cases


def _bilinear_layer(P, T, R):
    """The layer's x1 W x2 + b (the reference's layer calls its einsum
    module as a function and fails: its F.bilinear, on the same
    parameters, is the reference)."""
    m = layer(P, R, "Bilinear", 3, 4, 2)
    x1, x2 = T(n(R, 5, 3), sg=False), T(n(R, 5, 4), sg=False)
    if P.__name__ == "paddle_tpu":
        return F(P).bilinear(x1, x2, m.weight, m.bias)
    return m(x1, x2)


def _sequential(P, T, R):
    nn = P.nn
    named = nn.Sequential(("fc", layer(P, R, "Linear", 4, 3)), ("act", nn.Tanh()))
    seq = nn.Sequential(layer(P, R, "Linear", 3, 5), nn.ReLU(), layer(P, R, "Linear", 5, 2))
    x = T(n(R, 2, 4), sg=False)
    assert [k for k, _ in named.named_sublayers()] == ["fc", "act"] and len(seq) == 3
    return named(x), seq(named(x)), seq[1:](T(n(R, 2, 5))), seq[0](T(n(R, 2, 3)))


def _containers(P, T, R):
    nn = P.nn
    lst = nn.LayerList([layer(P, R, "Linear", 3, 3) for _ in range(2)])
    lst.append(nn.Tanh())
    d = nn.LayerDict({"a": layer(P, R, "Linear", 3, 2)})
    d["b"] = nn.Sigmoid()
    x = T(n(R, 2, 3), sg=False)
    for m in lst:
        x = m(x)
    out = d["b"](d["a"](x))
    plist = nn.ParameterList([P.create_parameter([3], "float32") for _ in range(2)])
    plist.append(P.create_parameter([2], "float32"))
    assert len(lst) == 3 and list(d.keys()) == ["a", "b"] and "a" in d and len(plist) == 3
    assert [list(p.shape) for p in plist] == [[3], [3], [2]]
    return out


def _bn_layers(P, T, R):
    """Three training calls of each batch norm, then its buffers and an
    eval call (the reference's momentum and biased variance)."""
    outs = []
    for cls, shape, kw in (("BatchNorm2D", (4, 3, 5, 5), {}), ("BatchNorm1D", (6, 3), {}),
                           ("BatchNorm1D", (4, 3, 5), dict(momentum=0.7)),
                           ("BatchNorm3D", (2, 3, 2, 3, 3), {}),
                           ("BatchNorm2D", (2, 4, 4, 3), dict(data_format="NHWC")),
                           ("SyncBatchNorm", (4, 3, 3, 3), {}),
                           ("BatchNorm", (4, 3, 4, 4), dict(act="relu"))):
        m = layer(P, R, cls, 3, **kw)
        for _ in range(3):
            outs.append(m(T(n(R, *shape) * 2 + 0.5, sg=False)))
        outs += [P.assign(m._mean), P.assign(m._variance)]
        m.eval()
        outs.append(m(T(n(R, *shape), sg=False)))
    return outs


def _convert_sync(P, T, R):
    nn = P.nn
    net = nn.Sequential(layer(P, R, "Conv2D", 2, 3, 3, padding=1), layer(P, R, "BatchNorm2D", 3))
    nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert type(net[1]).__name__ == "SyncBatchNorm"
    return net(T(n(R, 2, 2, 4, 4), sg=False)), P.assign(net[1]._mean)


def _spectral(P, T, R):
    sn = layer(P, R, "SpectralNorm", [4, 3, 2], dim=1, power_iters=3)
    w = T(n(R, 4, 3, 2), sg=False)
    return sn(w), sn(w)


def _spectral_hook(P, T, R):
    lin = layer(P, R, "Linear", 4, 3)
    P.nn.utils.spectral_norm(lin)
    conv = layer(P, R, "Conv2D", 2, 3, 3)
    P.nn.utils.spectral_norm(conv, n_power_iterations=2)
    x = T(n(R, 2, 4), sg=False)
    return lin(x), lin(x), conv(T(n(R, 1, 2, 4, 4), sg=False))


def _losses():
    c = {}
    lab = lambda R: _labels(R, 4, c=5)  # noqa: E731
    for cls, kw, a, b in (
            ("CrossEntropyLoss", dict(reduction="sum"), lambda R: n(R, 4, 5), lab),
            ("NLLLoss", {}, lambda R: n(R, 4, 5), lab),
            ("MSELoss", {}, lambda R: n(R, 3, 4), lambda R: n(R, 3, 4)),
            ("L1Loss", dict(reduction="none"), lambda R: n(R, 3, 4), lambda R: n(R, 3, 4)),
            ("SmoothL1Loss", dict(delta=0.5), lambda R: n(R, 3, 4), lambda R: n(R, 3, 4)),
            ("BCELoss", {}, lambda R: _probs(R, 3, 4), lambda R: _probs(R, 3, 4)),
            ("BCEWithLogitsLoss", {}, lambda R: n(R, 3, 4), lambda R: _probs(R, 3, 4)),
            ("KLDivLoss", dict(reduction="sum"), lambda R: n(R, 3, 4), lambda R: _probs(R, 3, 4)),
            ("HingeEmbeddingLoss", {}, lambda R: n(R, 4),
             lambda R: np.array([1, -1, -1, 1], np.float32)),
            ("PairwiseDistance", dict(p=3.0, keepdim=True), lambda R: n(R, 3, 4),
             lambda R: n(R, 3, 4))):
        def fn(P, T, R, cls=cls, kw=kw, a=a, b=b):
            return getattr(P.nn, cls)(**kw)(T(a(R), sg=False), T(b(R)))

        c[cls] = Case(fn, tol=RED)
    c["MarginRankingLoss"] = Case(lambda P, T, R: P.nn.MarginRankingLoss(margin=0.2)(
        T(n(R, 5), sg=False), T(n(R, 5), sg=False), T(np.sign(n(R, 5)))), tol=RED)
    c["CTCLoss"] = Case(lambda P, T, R: P.nn.CTCLoss(blank=0)(
        T(n(R, 6, 2, 4), sg=False), T(np.array([[1, 2], [3, 0]], np.int32)),
        T(np.array([6, 5], np.int32)), T(np.array([2, 1], np.int32))), tol=LOOSE)
    c["HSigmoidLoss"] = Case(lambda P, T, R: layer(P, R, "HSigmoidLoss", 3, 5)(
        T(n(R, 4, 3), sg=False), T(_labels(R, 4, 1, c=5))), tol=RED)
    return c


LAYERS = {
    **_acts(),
    "Linear": _layer_case("Linear", (4, 3), shape=(2, 4)),
    "Embedding": Case(lambda P, T, R: layer(P, R, "Embedding", 6, 3, sparse=True)(
        T(R.randint(0, 6, (2, 4)).astype(np.int32))), tol=EXACT),
    "Dropout": _layer_case("Dropout", (0.4,), dict(axis=1), shape=(3, 4), tol=ELEM),
    "Dropout2D": _layer_case("Dropout2D", (0.5,), tol=ELEM),
    "Dropout3D": _layer_case("Dropout3D", (0.5,), shape=(2, 3, 2, 2, 2), tol=ELEM),
    "AlphaDropout": _layer_case("AlphaDropout", (0.2,), shape=(4, 5), tol=ELEM),
    "Flatten": _layer_case("Flatten", (), tol=EXACT),
    "Identity": _layer_case("Identity", (3,), dict(bias=True), tol=EXACT),
    "Pad1D": _layer_case("Pad1D", ([1, 2],), dict(mode="replicate"), shape=(2, 3, 4), tol=EXACT),
    "Pad2D": _layer_case("Pad2D", ([1, 0, 2, 1],), dict(value=1.5), tol=EXACT),
    "Pad3D": _layer_case("Pad3D", ([1, 0, 0, 1, 1, 1],), shape=(1, 2, 2, 2, 2), tol=EXACT),
    "Upsample": _layer_case("Upsample", (), dict(scale_factor=2), tol=EXACT),
    "UpsamplingBilinear2D": _layer_case("UpsamplingBilinear2D", (), dict(size=[9, 7])),
    "UpsamplingNearest2D": _layer_case("UpsamplingNearest2D", (), dict(size=[4, 9]),
                                       tol=EXACT),
    "Bilinear": Case(_bilinear_layer, tol=RED),
    "CosineSimilarity": _layer_case("CosineSimilarity", (), dict(axis=-1), shape=(3, 4),
                                    inputs=2),
    "PixelShuffle": _layer_case("PixelShuffle", (3,), shape=(1, 9, 2, 2), tol=EXACT),
    "Unfold": _layer_case("Unfold", ([2, 2],), dict(strides=2), tol=EXACT),
    "Sequential": Case(_sequential, tol=RED),
    "LayerList": Case(_containers, tol=RED),
    "Conv1D": _layer_case("Conv1D", (3, 4, 3), dict(padding="SAME"), shape=(2, 3, 7)),
    "Conv2D": _layer_case("Conv2D", (3, 4, 3), dict(stride=2, padding=1)),
    "Conv3D": _layer_case("Conv3D", (3, 2, 2), shape=(1, 3, 3, 4, 4)),
    "Conv1DTranspose": _layer_case("Conv1DTranspose", (3, 2, 3), dict(stride=2),
                                   shape=(2, 3, 5)),
    "Conv2DTranspose": _layer_case("Conv2DTranspose", (3, 4, 4), dict(stride=2, padding=1,
                                                                      groups=1)),
    "Conv3DTranspose": _layer_case("Conv3DTranspose", (3, 2, 2), dict(stride=2),
                                   shape=(1, 3, 2, 3, 2)),
    "MaxPool1D": _layer_case("MaxPool1D", (3, 2, 1), shape=(2, 3, 9), tol=EXACT),
    "MaxPool2D": _layer_case("MaxPool2D", (3, 2, 1), tol=EXACT, x=lambda R: ties(R, 2, 3, 6, 6)),
    "MaxPool3D": _layer_case("MaxPool3D", (2,), dict(ceil_mode=True), shape=(1, 2, 3, 5, 5),
                             tol=EXACT),
    "AvgPool1D": _layer_case("AvgPool1D", (3, 2, 1), shape=(2, 3, 9)),
    "AvgPool2D": _layer_case("AvgPool2D", (3, 2, 1), dict(exclusive=False)),
    "AvgPool3D": _layer_case("AvgPool3D", (2,), shape=(1, 2, 4, 4, 4)),
    "AdaptiveAvgPool1D": _layer_case("AdaptiveAvgPool1D", (3,), shape=(2, 3, 7)),
    "AdaptiveAvgPool2D": _layer_case("AdaptiveAvgPool2D", ((1, 1),)),
    "AdaptiveAvgPool3D": _layer_case("AdaptiveAvgPool3D", (2,), shape=(1, 2, 4, 4, 4)),
    "AdaptiveMaxPool1D": _layer_case("AdaptiveMaxPool1D", (3,), shape=(2, 3, 7), tol=EXACT),
    "AdaptiveMaxPool2D": _layer_case("AdaptiveMaxPool2D", (3,), tol=EXACT),
    "AdaptiveMaxPool3D": _layer_case("AdaptiveMaxPool3D", (2,), shape=(1, 2, 4, 4, 4),
                                     tol=EXACT),
    "BatchNorm2D": Case(_bn_layers, tol=LOOSE),
    "SyncBatchNorm": Case(_convert_sync, tol=RED),
    "LayerNorm": _layer_case("LayerNorm", ([6, 6],), shape=(2, 3, 6, 6)),
    "InstanceNorm1D": _layer_case("InstanceNorm1D", (3,), shape=(2, 3, 5)),
    "InstanceNorm2D": _layer_case("InstanceNorm2D", (3,)),
    "InstanceNorm3D": _layer_case("InstanceNorm3D", (3,), shape=(1, 3, 2, 3, 3)),
    "GroupNorm": _layer_case("GroupNorm", (3, 6), shape=(2, 6, 3, 3)),
    "LocalResponseNorm": _layer_case("LocalResponseNorm", (3,)),
    "SpectralNorm": Case(_spectral, tol=LOOSE),
    "spectral_norm": Case(_spectral_hook, tol=LOOSE),
    **_losses(),
}

# layer classes whose case is another's
LAYER_ALIASES = {"ParameterList": "LayerList", "LayerDict": "LayerList",
                 "BatchNorm": "BatchNorm2D", "BatchNorm1D": "BatchNorm2D",
                 "BatchNorm3D": "BatchNorm2D"}

FUNCTIONAL = {**ACTIVATION, **COMMON, **CONV, **POOLING, **NORM, **LOSS}
# functional names held elsewhere: the attention and beam search ops by
# their own test files
FUNCTIONAL_ELSEWHERE = {"scaled_dot_product_attention": "tests/test_torch_parity.py",
                        "gather_tree": "tests/test_torch_seq2seq.py"}
