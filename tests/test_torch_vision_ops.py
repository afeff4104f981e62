"""paddle_tpu_torch.vision.ops (the detection ops) against the JAX
package's paddle_tpu.vision.ops on the CPU, at small sizes, on inputs made
from a seed with numpy.

- The dense geometry: anchor_generator, iou_similarity and box_clip
  bitwise; prior_box, density_prior_box, box_coder and yolo_box within
  1e-6 of each output's max (XLA's fused divisions, logs, exps and
  sigmoids round a last bit apart from torch's).
- The host ops (nms, multiclass_nms, matrix_nms, distribute/collect FPN
  proposals): the same numpy calls on the same float32 arrays, so the
  kept indices and rows are bitwise the reference's (its indices are
  int32, jax's int64 off; the port's int64, as Paddle's).
- ``roi_align``: within 1e-6 of the output's max (XLA turns the bin
  centre's ``* rh / oh`` into a product by 1/oh fused with the add, an
  FMA, so a coordinate may sit an ulp apart); its gradients to the map and
  the boxes within 1e-5 of their max (the scatter-add's order); over
  several images with ``boxes_num``, each image's RoIs bitwise the port
  called on that image alone and within 1e-6 of the reference called on
  it (the reference reads ``x[0]`` for every RoI).
- ``deform_conv2d`` / ``DeformConv2D``, v1 and v2, groups and deformable
  groups > 1, stride, dilation, padding: the forward within 1e-5 of its
  max (the contraction's summation order), the gradients to x, offset,
  mask, weight and bias within 1e-5 of each max; the bilinear samples
  bitwise; ``static.nn.deform_conv2d`` in a Program against the
  reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.vision import ops as tops

torch.set_num_threads(1)

TOL_TRANSCENDENTAL = 1e-6  # a last bit of a division/FMA/log/exp/sigmoid, of each output's max
TOL_SUM = 1e-5  # contractions and scatter-adds in another order, of each output's max


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def J(a, grad=False):
    return jp.to_tensor(np.asarray(a), stop_gradient=not grad)


def T(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def jnp_(t):
    return np.asarray(t.numpy())


def tnp(t):
    return t.detach().cpu().numpy()


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def close(got, want, tol=TOL_TRANSCENDENTAL):
    got, want = tnp(got), jnp_(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    assert rel(got, want) <= tol


def same(got, want):
    got, want = tnp(got), jnp_(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def same_index(got, want):
    got, want = tnp(got), jnp_(want)
    assert got.dtype == np.int64 and want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def rand_boxes(rng, n, size=32.0):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * size / 2 + 0.5
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ------------------------------------------------------------------ dense ops
@pytest.mark.parametrize("clip,sxy", [(True, 1.0), (False, 1.05)])
def test_yolo_box(clip, sxy):
    rng = np.random.RandomState(0)
    anchors, cls = [10, 13, 16, 30, 33, 23], 4
    x = rng.randn(2, 3 * (cls + 5), 5, 6).astype(np.float32) * 2
    img = np.array([[40, 48], [32, 30]], np.int32)
    kw = dict(anchors=anchors, class_num=cls, conf_thresh=0.3, downsample_ratio=8,
              clip_bbox=clip, scale_x_y=sxy)
    jb, js = jops.yolo_box(J(x), J(img), **kw)
    tb, ts = tops.yolo_box(T(x), T(img), **kw)
    assert tb.shape == (2, 90, 4) and ts.shape == (2, 90, cls)
    assert rel(tnp(tb), jnp_(jb)) <= TOL_TRANSCENDENTAL
    assert rel(tnp(ts), jnp_(js)) <= TOL_TRANSCENDENTAL
    # the static-shape contract: zeroed where the objectness is at or under conf
    assert np.array_equal(tnp(ts) == 0, jnp_(js) == 0) and (tnp(ts) == 0).any()


def test_prior_box_and_density_prior_box():
    feat, img = np.zeros((1, 8, 4, 5), np.float32), np.zeros((1, 3, 32, 40), np.float32)
    for kw in (dict(min_sizes=[9.0], max_sizes=[20.0], aspect_ratios=[2.0, 3.0], flip=True),
               dict(min_sizes=[6.0, 12.0], aspect_ratios=[0.5], clip=True,
                    steps=(7.0, 9.0), offset=0.25)):
        for j, t in zip(jops.prior_box(J(feat), J(img), **kw),
                        tops.prior_box(T(feat), T(img), **kw)):
            close(t, j)
    kw = dict(densities=[2, 1], fixed_sizes=[8.0, 16.0], fixed_ratios=[1.0, 2.0])
    for step in (0.0, 6.0):
        for j, t in zip(jops.density_prior_box(J(feat), J(img), step=step, **kw),
                        tops.density_prior_box(T(feat), T(img), step=step, **kw)):
            close(t, j)


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder(normalized):
    rng = np.random.RandomState(1)
    prior = rand_boxes(rng, 6)
    pvar = (rng.rand(6, 4) * 0.2 + 0.1).astype(np.float32)
    target = rand_boxes(rng, 5)
    for var in (pvar, None):
        kw = dict(code_type="encode_center_size", box_normalized=normalized)
        close(tops.box_coder(T(prior), None if var is None else T(var), T(target), **kw),
             jops.box_coder(J(prior), None if var is None else J(var), J(target), **kw))
    for deltas in (rng.randn(3, 6, 4).astype(np.float32) * 0.3,
                   rng.randn(6, 4).astype(np.float32) * 0.3):
        kw = dict(code_type="decode_center_size", box_normalized=normalized)
        close(tops.box_coder(T(prior), T(pvar), T(deltas), **kw),
             jops.box_coder(J(prior), J(pvar), J(deltas), **kw))
    with pytest.raises(ValueError):
        tops.box_coder(T(prior), T(pvar), T(target), code_type="other")


def test_anchor_generator_iou_and_box_clip():
    feat = np.zeros((1, 4, 3, 5), np.float32)
    kw = dict(anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0, 2.0], stride=(8.0, 16.0),
              offset=0.3)
    for j, t in zip(jops.anchor_generator(J(feat), **kw), tops.anchor_generator(T(feat), **kw)):
        same(t, j)
    rng = np.random.RandomState(2)
    a, b = rand_boxes(rng, 7), rand_boxes(rng, 5)
    for norm in (True, False):
        same(tops.iou_similarity(T(a), T(b), box_normalized=norm),
             jops.iou_similarity(J(a), J(b), box_normalized=norm))
    boxes = (rng.randn(2, 6, 8) * 30 + 10).astype(np.float32)
    info = np.array([[31.0, 45.0, 1.0], [60.0, 41.0, 2.0]], np.float32)
    same(tops.box_clip(T(boxes), T(info[:, None, :])), jops.box_clip(J(boxes), J(info[:, None, :])))


def test_paddle_tensors_in_give_tensors_out():
    a = np.random.RandomState(3).rand(4, 4).astype(np.float32)
    a[:, 2:] += a[:, :2]
    out = tops.iou_similarity(tp.to_tensor(a), tp.to_tensor(a))
    assert type(out) is tp.Tensor and out.shape == [4, 4]
    keep = tops.nms(tp.to_tensor(a), 0.5, scores=tp.to_tensor(a[:, 0]))
    assert type(keep) is tp.Tensor and keep.dtype == torch.int64


# ------------------------------------------------------------------ host ops
def test_nms_kept_indices_bitwise():
    rng = np.random.RandomState(4)
    boxes = rand_boxes(rng, 60, size=20.0)
    scores = rng.rand(60).astype(np.float32)
    scores[10:14] = scores[3]  # ties: argsort's order decides
    for thr, top_k, s in ((0.3, None, scores), (0.6, 7, scores), (0.5, None, None)):
        want = jops.nms(J(boxes), thr, scores=None if s is None else J(s), top_k=top_k)
        got = tops.nms(T(boxes), thr, scores=None if s is None else T(s), top_k=top_k)
        same_index(got, want)
        assert 0 < len(tnp(got)) < 60


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.3, nms_threshold=0.45),
    dict(score_threshold=0.1, nms_top_k=8, keep_top_k=12, nms_threshold=0.3,
         background_label=0),
])
def test_multiclass_nms_rows_bitwise(kw):
    rng = np.random.RandomState(5)
    boxes = rand_boxes(rng, 50, size=24.0)
    scores = rng.rand(4, 50).astype(np.float32)
    scores[2, :5] = scores[2, 7]
    want = jops.multiclass_nms(J(boxes), J(scores), **kw)
    got = tops.multiclass_nms(T(boxes), T(scores), **kw)
    same(got, want)
    assert got.shape[0] > 4
    # numpy inputs, as the reference takes them
    same(tops.multiclass_nms(boxes, scores, **kw), want)


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.2, post_threshold=0.1, nms_top_k=30, keep_top_k=25),
    dict(score_threshold=0.05, post_threshold=0.05, nms_top_k=-1, keep_top_k=-1,
         use_gaussian=True, gaussian_sigma=2.0, background_label=-1, normalized=False),
])
def test_matrix_nms_rows_and_index_bitwise(kw):
    rng = np.random.RandomState(6)
    boxes = rand_boxes(rng, 40, size=16.0)
    scores = rng.rand(3, 40).astype(np.float32)
    jr, ji = jops.matrix_nms(J(boxes), J(scores), return_index=True, **kw)
    tr, ti = tops.matrix_nms(T(boxes), T(scores), return_index=True, **kw)
    same(tr, jr)
    same_index(ti, ji)
    same(tops.matrix_nms(T(boxes), T(scores), **kw), jops.matrix_nms(J(boxes), J(scores), **kw))
    empty = tops.matrix_nms(T(boxes), T(scores * 0), score_threshold=0.5)
    assert tuple(empty.shape) == (0, 6)


def test_fpn_proposals_bitwise():
    rng = np.random.RandomState(7)
    rois = np.concatenate([rand_boxes(rng, 30, size=s) for s in (40.0, 200.0, 900.0)])
    jm, jr = jops.distribute_fpn_proposals(J(rois), 2, 5, 4, 224)
    tm, tr = tops.distribute_fpn_proposals(T(rois), 2, 5, 4, 224)
    assert len(tm) == len(jm) == 4
    for t, j in zip(tm, jm):
        same(t, j)
    same_index(tr, jr)
    assert sum(len(tnp(t)) > 0 for t in tm) >= 3
    scores = [rng.rand(len(tnp(t))).astype(np.float32) for t in tm]
    same(tops.collect_fpn_proposals(tm, [T(s) for s in scores], 2, 5, 25),
         jops.collect_fpn_proposals(jm, [J(s) for s in scores], 2, 5, 25))


# ------------------------------------------------------------------ roi_align
def roi_case(seed=8, n=1, rois=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3, 12, 14).astype(np.float32)
    boxes = rand_boxes(rng, rois, size=40.0)
    return x, boxes


@pytest.mark.parametrize("aligned,scale", [(True, 0.25), (False, 0.5)])
def test_roi_align_one_image_bitwise_and_gradients(aligned, scale):
    x, boxes = roi_case()
    kw = dict(output_size=(3, 4), spatial_scale=scale, aligned=aligned)
    g = np.random.RandomState(9).randn(6, 3, 3, 4).astype(np.float32)
    jx, jb = J(x, True), J(boxes, True)
    jo = jops.roi_align(jx, jb, J(np.array([6], np.int32)), **kw)
    (jo * J(g)).sum().backward()
    tx, tb = T(x, True), T(boxes, True)
    to = tops.roi_align(tx, tb, torch.tensor([6]), **kw)
    (to * T(g)).sum().backward()
    close(to, jo)
    assert rel(tnp(tx.grad), jnp_(jx.grad)) <= TOL_SUM
    assert rel(tnp(tb.grad), jnp_(jb.grad)) <= TOL_SUM
    # no boxes_num: one image, as the reference reads it
    np.testing.assert_array_equal(tnp(tops.roi_align(T(x), T(boxes), None, **kw)), tnp(to))


def test_roi_align_several_images_reads_boxes_num():
    x, boxes = roi_case(seed=10, n=3, rois=9)
    counts = [4, 0, 5]
    got = tops.roi_align(T(x), T(boxes), torch.tensor(counts), 2, spatial_scale=0.5)
    assert got.shape == (9, 3, 2, 2)
    start = 0
    for i, cnt in enumerate(counts):
        if cnt:
            alone = tops.roi_align(T(x[i:i + 1]), T(boxes[start:start + cnt]), None, 2,
                                   spatial_scale=0.5)
            np.testing.assert_array_equal(tnp(got[start:start + cnt]), tnp(alone))
            want = jops.roi_align(J(x[i:i + 1]), J(boxes[start:start + cnt]), None, 2,
                                  spatial_scale=0.5)
            close(got[start:start + cnt], want)
        start += cnt
    with pytest.raises(ValueError, match="boxes_num"):
        tops.roi_align(T(x), T(boxes), None, 2)
    with pytest.raises(ValueError, match="does not split"):
        tops.roi_align(T(x), T(boxes), torch.tensor([4, 4]), 2)


# ------------------------------------------------------------------ deform conv
DEFORM = {
    "v1": dict(b=2, c=4, cout=6, hw=(7, 6), k=(3, 3), stride=1, padding=1, dilation=1,
               dg=1, groups=1, mask=False),
    "v2": dict(b=2, c=4, cout=6, hw=(7, 6), k=(3, 3), stride=1, padding=1, dilation=1,
               dg=1, groups=1, mask=True),
    "v2_groups_dg": dict(b=1, c=8, cout=4, hw=(6, 7), k=(3, 2), stride=2, padding=(1, 0),
                         dilation=(1, 2), dg=2, groups=2, mask=True),
    "v1_dg4": dict(b=2, c=4, cout=2, hw=(5, 5), k=(2, 2), stride=1, padding=0, dilation=1,
                   dg=4, groups=1, mask=False),
}


def deform_inputs(cfg, seed=11):
    rng = np.random.RandomState(seed)
    kh, kw = cfg["k"]
    h, w = cfg["hw"]
    st = (cfg["stride"],) * 2 if isinstance(cfg["stride"], int) else cfg["stride"]
    pd = (cfg["padding"],) * 2 if isinstance(cfg["padding"], int) else cfg["padding"]
    dl = (cfg["dilation"],) * 2 if isinstance(cfg["dilation"], int) else cfg["dilation"]
    ho = (h + 2 * pd[0] - dl[0] * (kh - 1) - 1) // st[0] + 1
    wo = (w + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
    k = kh * kw
    x = rng.randn(cfg["b"], cfg["c"], h, w).astype(np.float32)
    # offsets up to 2.5 px: corners slide off the map at the border
    off = (rng.rand(cfg["b"], 2 * cfg["dg"] * k, ho, wo).astype(np.float32) - 0.5) * 5
    mask = rng.rand(cfg["b"], cfg["dg"] * k, ho, wo).astype(np.float32) if cfg["mask"] else None
    wt = rng.randn(cfg["cout"], cfg["c"] // cfg["groups"], kh, kw).astype(np.float32) * 0.3
    bias = rng.randn(cfg["cout"]).astype(np.float32)
    return x, off, mask, wt, bias


@pytest.mark.parametrize("case", sorted(DEFORM))
def test_deform_conv2d_forward_and_gradients(case):
    cfg = DEFORM[case]
    x, off, mask, wt, bias = deform_inputs(cfg)
    kw = dict(stride=cfg["stride"], padding=cfg["padding"], dilation=cfg["dilation"],
              deformable_groups=cfg["dg"], groups=cfg["groups"])
    arrays = [x, off, wt, bias] + ([mask] if mask is not None else [])
    js = [J(a, True) for a in arrays]
    ts = [T(a, True) for a in arrays]
    jy = jops.deform_conv2d(js[0], js[1], js[2], bias=js[3],
                            mask=js[4] if mask is not None else None, **kw)
    ty = tops.deform_conv2d(ts[0], ts[1], ts[2], bias=ts[3],
                            mask=ts[4] if mask is not None else None, **kw)
    assert tuple(ty.shape) == tuple(jy.shape)
    assert rel(tnp(ty), jnp_(jy)) <= TOL_SUM
    g = np.random.RandomState(12).randn(*ty.shape).astype(np.float32)
    (jy * J(g)).sum().backward()
    (ty * T(g)).sum().backward()
    for name, j, t in zip(("x", "offset", "weight", "bias", "mask"), js, ts):
        assert rel(tnp(t.grad), jnp_(j.grad)) <= TOL_SUM, name


def test_deform_samples_bitwise():
    """The bilinear samples (before the contraction) are the reference's
    bits: the same products and sums in the same order."""
    import jax.numpy as jnp

    cfg = DEFORM["v2_groups_dg"]
    x, off, _, _, _ = deform_inputs(cfg)
    rng = np.random.RandomState(13)
    py = (rng.rand(1, 2, 6, 3, 3) * 9 - 1.5).astype(np.float32)
    px = (rng.rand(1, 2, 6, 3, 3) * 10 - 1.5).astype(np.float32)
    want = np.asarray(jops._deform_sample(jnp.asarray(x), jnp.asarray(py), jnp.asarray(px), 2))
    got = tnp(tops._deform_sample(T(x), T(py), T(px), 2))
    np.testing.assert_array_equal(got, want)


def test_deform_conv2d_layer_matches_the_reference():
    cfg = DEFORM["v2"]
    x, off, mask, _, _ = deform_inputs(cfg, seed=14)
    jp.seed(3)
    jl = jp.vision.ops.DeformConv2D(4, 6, 3, padding=1)
    tl = tp.vision.ops.DeformConv2D(4, 6, 3, padding=1)
    assert [tuple(p.shape) for p in tl.parameters()] == [(6, 4, 3, 3), (6,)]
    convert.load_numpy_state(tl, {n: np.asarray(p.numpy()) for n, p in jl.named_parameters()})
    for m in (None, mask):
        want = jl(J(x), J(off), None if m is None else J(m))
        got = tl(tp.to_tensor(x), tp.to_tensor(off), None if m is None else tp.to_tensor(m))
        assert type(got) is tp.Tensor
        assert rel(got.numpy(), jnp_(want)) <= TOL_SUM
    assert tp.vision.ops.DeformConv2D(4, 6, 3, bias_attr=False).bias is None


def test_static_deform_conv2d_in_a_program():
    cfg = DEFORM["v2"]
    x, off, mask, _, _ = deform_inputs(cfg, seed=15)
    feed = {"x": x, "off": off, "mask": mask}

    def make(paddle):
        static = paddle.static
        d = {k: static.data(k, list(v.shape), "float32") for k, v in feed.items()}
        return paddle.static.nn.deform_conv2d(d["x"], d["off"], d["mask"], 6, 3, padding=1)

    def build(paddle):
        paddle.enable_static()
        main, startup = paddle.static.Program(), paddle.static.Program()
        try:
            with paddle.static.program_guard(main, startup):
                out = make(paddle)
        finally:
            paddle.disable_static()
        return main, out

    jp.seed(0)
    jm, jy = build(jp)
    tm, ty = build(tp)
    try:
        convert.set_by_position(tm, [np.asarray(p.numpy()) for p in jm.all_parameters()])
        want, = jp.static.Executor().run(jm, feed=feed, fetch_list=[jy])
        got, = tp.static.Executor().run(tm, feed=feed, fetch_list=[ty])
    finally:
        jp.disable_static()
        tp.disable_static()
    assert np.asarray(got).shape == (2, 6, 7, 6)
    assert rel(np.asarray(got), np.asarray(want)) <= TOL_SUM
