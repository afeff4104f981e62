"""The detection ops (counterpart of paddle_tpu/vision/ops.py; reference:
operators/detection/ and python/paddle/vision/ops.py).

Two kinds, as in the reference:

- dense geometry (``yolo_box``, ``prior_box``, ``box_coder``,
  ``anchor_generator``, ``iou_similarity``, ``box_clip``,
  ``density_prior_box``, ``roi_align``, ``deform_conv2d``): torch ops on
  the input's device, in the reference's operation order, so the CPU
  gives the reference's values (bitwise where no transcendental
  differs). ``yolo_box`` keeps the static-shape contract: a score under
  ``conf_thresh`` is zeroed, not filtered.
- host ops (``nms``, ``multiclass_nms``, ``matrix_nms``,
  ``distribute_fpn_proposals``, ``collect_fpn_proposals``): their output
  shapes depend on the data, so they run in numpy on the host with the
  reference's own numpy calls (``np.argsort(-s)`` and its tie order
  included): the kept indices are bitwise the reference's on the same
  float32 arrays. Each CUDA input crosses to the host once a call; the
  results go back to the input's device.

Where the port departs from the reference: ``roi_align`` reads each RoI's
image from ``boxes_num`` (the reference reads ``x[0]`` for every RoI); with
one image the two agree bitwise. Kept for parity: ``roi_align`` takes one
bilinear sample at each bin's centre whatever ``sampling_ratio`` says, and
``nms`` ignores ``category_idxs``/``categories``.

``deform_conv2d`` gathers per deformable group, the index broadcast over
the group's channels (the reference repeats the index out to every
channel, a tensor as large as the sampled one), and contracts the sampled
taps with the kernel in one batched GEMM per group. Gradients come from
autograd.
"""
import numpy as np
import torch

from ..core import errors
from ..core.tensor import boundary, capturing, plain
from ..nn.functional.common import _pair
from ..nn.functional.conv import _norm_padding
from ..nn.layer import Layer

__all__ = ["nms", "roi_align", "yolo_box", "prior_box", "box_coder", "multiclass_nms",
           "anchor_generator", "iou_similarity", "box_clip", "density_prior_box",
           "matrix_nms", "distribute_fpn_proposals", "collect_fpn_proposals",
           "deform_conv2d", "DeformConv2D"]

_F32 = torch.float32


# ------------------------------------------------------------ host side
def _host(x, what):
    """A tensor (or array) as a numpy array on the host: one crossing for a
    CUDA tensor. Refused inside a capture (the output shape is data's)."""
    if capturing():
        raise errors.UnimplementedError(f"{what} is not traceable (dynamic shape)")
    if isinstance(x, torch.Tensor):
        return plain(x).detach().cpu().numpy()
    return np.asarray(x)


def _device_of(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _out(arr, like):
    """A host result as a tensor on ``like``'s device, a Tensor when
    ``like`` is one."""
    from ..core.tensor import Tensor, wrap

    t = torch.from_numpy(np.ascontiguousarray(arr)).to(_device_of(like))
    return wrap(t) if type(like) is Tensor else t


def _nms_keep(b, s, iou_threshold):
    """The reference's greedy NMS over host arrays: indices into ``b``."""
    order = np.argsort(-s)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        xx1 = np.maximum(b[i, 0], b[order[1:], 0])
        yy1 = np.maximum(b[i, 1], b[order[1:], 1])
        xx2 = np.minimum(b[i, 2], b[order[1:], 2])
        yy2 = np.minimum(b[i, 3], b[order[1:], 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        area_i = (b[i, 2] - b[i, 0]) * (b[i, 3] - b[i, 1])
        area_o = (b[order[1:], 2] - b[order[1:], 0]) * \
                 (b[order[1:], 3] - b[order[1:], 1])
        iou = inter / (area_i + area_o - inter + 1e-12)
        order = order[1:][iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None, categories=None,
        top_k=None):
    """Greedy NMS on the host -> int64 indices of the kept boxes, highest
    score first. ``category_idxs``/``categories`` are ignored, as in the
    reference."""
    b = _host(boxes, "nms")
    s = _host(scores, "nms") if scores is not None else np.ones(len(b))
    keep = _nms_keep(b, s, iou_threshold)
    if top_k is not None:
        keep = keep[:top_k]
    return _out(keep, boxes)


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=-1, keep_top_k=-1,
                   nms_threshold=0.3, normalized=True, background_label=-1, name=None):
    """Per-class NMS over [N_box, 4] boxes and [C, N_box] scores (one
    image), on the host -> [M, 6] rows (class, score, x1, y1, x2, y2)."""
    b = _host(bboxes, "multiclass_nms")
    s = _host(scores, "multiclass_nms")
    out = []
    for c in range(s.shape[0]):
        if c == background_label:
            continue
        sel = np.where(s[c] > score_threshold)[0]
        if sel.size == 0:
            continue
        order = sel[np.argsort(-s[c][sel])]
        if nms_top_k > 0:
            order = order[:nms_top_k]
        for i in _nms_keep(b[order], s[c][order], nms_threshold):
            gi = order[i]
            out.append([c, s[c][gi], *b[gi]])
    out.sort(key=lambda r: -r[1])
    if keep_top_k > 0:
        out = out[:keep_top_k]
    return _out(np.asarray(out, np.float32).reshape(-1, 6), bboxes)


def _np_iou(bb, off):
    x1, y1, x2, y2 = bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3]
    area = (x2 - x1 + off) * (y2 - y1 + off)
    ix1 = np.maximum(x1[:, None], x1[None, :])
    iy1 = np.maximum(y1[:, None], y1[None, :])
    ix2 = np.minimum(x2[:, None], x2[None, :])
    iy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.clip(ix2 - ix1 + off, 0, None) * np.clip(iy2 - iy1 + off, 0, None)
    return inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-10)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0, nms_top_k=400,
               keep_top_k=200, use_gaussian=False, gaussian_sigma=2.0, background_label=0,
               normalized=True, return_index=False):
    """Matrix NMS (SOLOv2) over [N, 4] boxes and [C, N] scores, on the host:
    each box's score decays by its strongest higher-scored overlap ->
    [M, 6] rows (class, decayed score, x1, y1, x2, y2) by decayed score,
    and their box indices with ``return_index``."""
    b = _host(bboxes, "matrix_nms")
    s = _host(scores, "matrix_nms")
    out_rows, out_index = [], []
    for c in range(s.shape[0]):
        if c == background_label:
            continue
        cls_scores = s[c]
        keep = cls_scores > score_threshold
        if not keep.any():
            continue
        idx = np.where(keep)[0]
        order = idx[np.argsort(-cls_scores[idx])]
        if nms_top_k > 0:
            order = order[:nms_top_k]
        bb = b[order]
        sc = cls_scores[order]
        n = len(order)
        iou = _np_iou(bb.astype(np.float32), 0.0 if normalized else 1.0)
        tri = np.triu(iou, k=1)
        # comp[i] = max_{k<i} iou(k, i): box i's own strongest suppressor
        comp = np.concatenate([[0.0], tri[:, 1:].max(axis=0)]) if n > 1 else np.zeros(n)
        if use_gaussian:
            decay_mat = np.exp((comp[:, None] ** 2 - tri ** 2) * gaussian_sigma)
        else:
            decay_mat = (1.0 - tri) / np.maximum(1.0 - comp[:, None], 1e-10)
        decay_mat = np.where(np.triu(np.ones((n, n), bool), k=1), decay_mat, np.inf)
        decay = np.minimum(decay_mat.min(axis=0), 1.0) if n > 1 else np.ones(n)
        decayed = sc * decay
        for i in np.where(decayed > post_threshold)[0]:
            out_rows.append((float(c), float(decayed[i]), *bb[i].tolist()))
            out_index.append(int(order[i]))
    ranking = sorted(range(len(out_rows)), key=lambda k: -out_rows[k][1])
    if keep_top_k > 0:
        ranking = ranking[:keep_top_k]
    rows = [out_rows[k] for k in ranking]
    result = _out(np.asarray(rows, np.float32).reshape(-1, 6) if rows
                  else np.zeros((0, 6), np.float32), bboxes)
    if return_index:
        return result, _out(np.asarray([out_index[k] for k in ranking], np.int64), bboxes)
    return result


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level, refer_scale,
                             rois_num=None):
    """Assign RoIs to FPN levels by scale, level = floor(refer_level +
    log2(sqrt(area) / refer_scale)) clipped, on the host -> (the RoIs of
    each level, the restore index). ``rois_num`` is ignored, as in the
    reference."""
    rois = _host(fpn_rois, "distribute_fpn_proposals")
    w = np.maximum(rois[:, 2] - rois[:, 0], 0.0)
    h = np.maximum(rois[:, 3] - rois[:, 1], 0.0)
    scale = np.sqrt(w * h)
    lvl = np.floor(refer_level + np.log2(scale / refer_scale + 1e-8))
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    multi_rois, parts = [], []
    for level in range(min_level, max_level + 1):
        idx = np.where(lvl == level)[0]
        multi_rois.append(_out(rois[idx].astype(np.float32), fpn_rois))
        parts.append(idx)
    order = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    restore = np.empty_like(order)
    restore[order] = np.arange(len(order))
    return multi_rois, _out(restore.astype(np.int64), fpn_rois)


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level, post_nms_top_n,
                          rois_num_per_level=None):
    """Merge the levels' proposals and keep the top ``post_nms_top_n`` by
    score, on the host."""
    like = multi_rois[0] if multi_rois else None
    rois = np.concatenate([_host(r, "collect_fpn_proposals").reshape(-1, 4)
                           for r in multi_rois]) if multi_rois else np.zeros((0, 4), np.float32)
    scores = np.concatenate([_host(s, "collect_fpn_proposals").reshape(-1)
                             for s in multi_scores]) if multi_scores else np.zeros(0, np.float32)
    order = np.argsort(-scores)[:post_nms_top_n]
    return _out(rois[order].astype(np.float32), like)


# ------------------------------------------------------------ dense ops
@boundary
def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0, sampling_ratio=-1,
              aligned=True, name=None):
    """Bilinear RoI-Align: one sample at each bin's centre (``sampling_ratio``
    is ignored, as in the reference) -> [R, C, oh, ow]. RoI r reads image
    i where ``boxes_num`` puts it (the first boxes_num[0] RoIs image 0, and
    so on); without ``boxes_num`` every RoI reads image 0, which only one
    image allows."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) else output_size
    n, c, h, w = x.shape
    dev = x.device
    if boxes_num is None:
        if n != 1:
            raise ValueError(f"roi_align over {n} images needs boxes_num")
        bi = torch.zeros(boxes.shape[0], dtype=torch.long, device=dev)
    else:
        counts = torch.as_tensor(boxes_num).reshape(-1).long().cpu()
        if counts.numel() != n or int(counts.sum()) != boxes.shape[0]:
            raise ValueError(f"boxes_num {counts.tolist()} does not split {boxes.shape[0]} "
                             f"RoIs over {n} images")
        bi = torch.repeat_interleave(torch.arange(n, device=dev), counts.to(dev),
                                     output_size=boxes.shape[0])
    off = 0.5 if aligned else 0.0
    scale = float(spatial_scale)
    x1 = boxes[:, 0] * scale - off
    y1 = boxes[:, 1] * scale - off
    x2 = boxes[:, 2] * scale - off
    y2 = boxes[:, 3] * scale - off
    rw = torch.clamp_min(x2 - x1, 1.0)
    rh = torch.clamp_min(y2 - y1, 1.0)
    # divided by a device tensor: torch's CUDA division by a host scalar
    # multiplies by its reciprocal, a last bit off the CPU's quotient, which
    # the bilinear sample then scales by the map's slope
    ys = y1[:, None] + (torch.arange(oh, dtype=_F32, device=dev) + 0.5) * rh[:, None] / \
        torch.tensor(float(oh), device=dev)
    xs = x1[:, None] + (torch.arange(ow, dtype=_F32, device=dev) + 0.5) * rw[:, None] / \
        torch.tensor(float(ow), device=dev)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0, 1)[:, :, None, None]  # [R, oh, 1, 1]
    wx = torch.clamp(xs - x0, 0, 1)[:, None, :, None]  # [R, 1, ow, 1]
    img = bi[:, None, None]

    def at(yi, xi):  # [R, oh, ow, C]
        return x[img, :, yi[:, :, None], xi[:, None, :]]

    top = at(y0, x0) * (1 - wx) + at(y0, x1i) * wx
    bot = at(y1i, x0) * (1 - wx) + at(y1i, x1i) * wx
    return (top * (1 - wy) + bot * wy).permute(0, 3, 1, 2)


@boundary
def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio, clip_bbox=True,
             name=None, scale_x_y=1.0, iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLOv3 head [N, A*(C+5), H, W] -> (boxes [N, H*W*A, 4] xyxy
    in image coordinates, scores [N, H*W*A, C]), anchors in (a, h, w)
    order; a score whose objectness is not above ``conf_thresh`` is 0."""
    dev = x.device
    an = torch.from_numpy(np.asarray(anchors, np.float32).reshape(-1, 2)).to(dev)
    cnum, ds, sxy = int(class_num), float(downsample_ratio), float(scale_x_y)
    n, _, h, w = x.shape
    a = an.shape[0]
    x = x.reshape(n, a, cnum + 5, h, w)
    gx = torch.arange(w, dtype=_F32, device=dev)[None, None, None, :]
    gy = torch.arange(h, dtype=_F32, device=dev)[None, None, :, None]
    bx = (torch.sigmoid(x[:, :, 0]) * sxy - 0.5 * (sxy - 1) + gx) / w
    by = (torch.sigmoid(x[:, :, 1]) * sxy - 0.5 * (sxy - 1) + gy) / h
    bw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] / (w * ds)
    bh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] / (h * ds)
    obj = torch.sigmoid(x[:, :, 4])
    cls = torch.sigmoid(x[:, :, 5:])
    imh = img_size[:, 0].to(_F32)[:, None, None, None]
    imw = img_size[:, 1].to(_F32)[:, None, None, None]
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        x1 = torch.minimum(torch.clamp_min(x1, 0), imw - 1)
        y1 = torch.minimum(torch.clamp_min(y1, 0), imh - 1)
        x2 = torch.minimum(torch.clamp_min(x2, 0), imw - 1)
        y2 = torch.minimum(torch.clamp_min(y2, 0), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, -1, 4)
    scores = obj[..., None] * torch.movedim(cls, 2, -1)
    scores = torch.where(obj[..., None] > float(conf_thresh), scores, 0.0)
    return boxes, scores.reshape(n, -1, cnum)


@boundary
def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False, steps=(0.0, 0.0),
              offset=0.5, min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes -> (boxes [H, W, A, 4] normalized xyxy, variances of
    the same shape)."""
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - e) > 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    mins = [float(m) for m in np.atleast_1d(min_sizes)]
    maxs = [float(m) for m in np.atleast_1d(max_sizes)] if max_sizes is not None else []
    dev = input.device
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    sw = float(steps[0]) or iw / fw
    sh = float(steps[1]) or ih / fh
    cx = (torch.arange(fw, dtype=_F32, device=dev) + float(offset)) * sw
    cy = (torch.arange(fh, dtype=_F32, device=dev) + float(offset)) * sh
    whs = []
    for k, ms in enumerate(mins):
        whs.append((ms, ms))
        if k < len(maxs):
            s = float(np.sqrt(ms * maxs[k]))
            whs.append((s, s))
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
    wh = torch.tensor(whs, dtype=_F32, device=dev)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    x1 = (cxg[..., None] - wh[None, None, :, 0] / 2) / iw
    y1 = (cyg[..., None] - wh[None, None, :, 1] / 2) / ih
    x2 = (cxg[..., None] + wh[None, None, :, 0] / 2) / iw
    y2 = (cyg[..., None] + wh[None, None, :, 1] / 2) / ih
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor([float(v) for v in variance], dtype=_F32, device=dev)
    return boxes, var.expand(boxes.shape).clone()


@boundary
def box_coder(prior_box, prior_box_var, target_box, code_type="encode_center_size",
              box_normalized=True, axis=0, name=None):
    """Encode boxes against priors ([N_target, N_prior, 4]) or decode
    deltas [N, A, 4] into boxes."""
    ct = code_type.lower()
    if ct not in ("encode_center_size", "decode_center_size"):
        raise ValueError(code_type)
    prior, pvar, target = prior_box, prior_box_var, target_box
    off = 0.0 if box_normalized else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    if pvar is None:
        pvar = torch.ones_like(prior)
    if ct == "encode_center_size":
        tw = target[:, 2] - target[:, 0] + off
        th = target[:, 3] - target[:, 1] + off
        tcx = target[:, 0] + tw / 2
        tcy = target[:, 1] + th / 2
        out = torch.stack([(tcx[:, None] - pcx[None, :]) / pw[None, :],
                           (tcy[:, None] - pcy[None, :]) / ph[None, :],
                           torch.log(tw[:, None] / pw[None, :]),
                           torch.log(th[:, None] / ph[None, :])], dim=-1)
        return out / pvar[None, :, :]
    d = target * pvar[None, :, :] if target.dim() == 3 else (target * pvar)[None]
    cx = d[..., 0] * pw + pcx
    cy = d[..., 1] * ph + pcy
    w = torch.exp(d[..., 2]) * pw
    h = torch.exp(d[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - off, cy + h / 2 - off], dim=-1)


@boundary
def anchor_generator(input, anchor_sizes, aspect_ratios=(1.0,),
                     variances=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0), offset=0.5):
    """Dense anchors per feature-map cell, every (ratio, size) centred at
    (w * stride_w + offset * (stride_w - 1), ...) -> (anchors [H, W, A, 4]
    xyxy, variances [H, W, A, 4])."""
    dev = input.device
    H, W = input.shape[2], input.shape[3]
    sw, sh = (float(s) for s in stride)
    xc = torch.arange(W, dtype=_F32, device=dev) * sw + float(offset) * (sw - 1)
    yc = torch.arange(H, dtype=_F32, device=dev) * sh + float(offset) * (sh - 1)
    ws, hs = [], []
    for r in aspect_ratios:
        ar = torch.sqrt(torch.tensor(float(r), dtype=_F32))
        for s in anchor_sizes:
            ws.append(float(s) / ar)
            hs.append(float(s) * ar)
    A = len(ws)
    ws, hs = torch.stack(ws).to(dev), torch.stack(hs).to(dev)
    xg = xc[None, :, None]
    yg = yc[:, None, None]
    out = torch.stack([(xg - 0.5 * ws).expand(H, W, A), (yg - 0.5 * hs).expand(H, W, A),
                       (xg + 0.5 * ws).expand(H, W, A), (yg + 0.5 * hs).expand(H, W, A)],
                      dim=-1)
    var = torch.tensor([float(v) for v in variances], dtype=_F32, device=dev)
    return out, var.expand(H, W, A, 4).clone()


@boundary
def iou_similarity(x, y, box_normalized=True):
    """Pairwise IoU [N, M] of xyxy boxes."""
    off = 0.0 if box_normalized else 1.0
    ax1, ay1, ax2, ay2 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    bx1, by1, bx2, by2 = y[:, 0], y[:, 1], y[:, 2], y[:, 3]
    area_a = (ax2 - ax1 + off) * (ay2 - ay1 + off)
    area_b = (bx2 - bx1 + off) * (by2 - by1 + off)
    ix1 = torch.maximum(ax1[:, None], bx1[None, :])
    iy1 = torch.maximum(ay1[:, None], by1[None, :])
    ix2 = torch.minimum(ax2[:, None], bx2[None, :])
    iy2 = torch.minimum(ay2[:, None], by2[None, :])
    inter = torch.clamp_min(ix2 - ix1 + off, 0) * torch.clamp_min(iy2 - iy1 + off, 0)
    return inter / torch.clamp_min(area_a[:, None] + area_b[None, :] - inter, 1e-10)


@boundary
def box_clip(input, im_info):
    """Clip xyxy boxes to the image: ``im_info`` rows are [height, width,
    scale], h and w rounded before the -1 as the reference rounds."""
    boxes, info = input, im_info
    h = torch.round(info[..., 0:1] / info[..., 2:3]) - 1.0
    w = torch.round(info[..., 1:2] / info[..., 2:3]) - 1.0

    def clip(v, hi):
        return torch.minimum(torch.clamp_min(v, 0.0), hi)

    out = torch.stack([clip(boxes[..., 0::4], w), clip(boxes[..., 1::4], h),
                       clip(boxes[..., 2::4], w), clip(boxes[..., 3::4], h)], dim=-1)
    return out.reshape(boxes.shape)


@boundary
def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False, step=0.0, offset=0.5):
    """SSD density prior boxes: per cell, a density x density grid of
    centres shifted across the stride cell for each (fixed_size, ratio),
    clamped to [0, 1] whatever ``clip`` says (as the reference clamps)."""
    dev = input.device
    H, W = input.shape[2], input.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    step_w = float(step) or img_w / W
    step_h = float(step) or img_h / H
    step_average = int(0.5 * (step_w + step_h))
    boxes = []
    for size, density in zip((float(s) for s in fixed_sizes), (int(d) for d in densities)):
        shift = int(step_average / density)
        for ratio in (float(r) for r in fixed_ratios):
            bw = size * np.sqrt(ratio)
            bh = size / np.sqrt(ratio)
            base = -step_average / 2.0 + shift / 2.0
            for di in range(density):
                for dj in range(density):
                    boxes.append((bw, bh, base + dj * shift, base + di * shift))
    A = len(boxes)
    params = torch.tensor(boxes, dtype=_F32, device=dev)
    xs = (torch.arange(W, dtype=_F32, device=dev) + float(offset)) * step_w
    ys = (torch.arange(H, dtype=_F32, device=dev) + float(offset)) * step_h
    cx = xs[None, :, None] + params[None, None, :, 2]
    cy = ys[:, None, None] + params[None, None, :, 3]
    bw = params[None, None, :, 0].expand(H, W, A)
    bh = params[None, None, :, 1].expand(H, W, A)
    out = torch.stack([(cx - bw / 2.0) / img_w, (cy - bh / 2.0) / img_h,
                       (cx + bw / 2.0) / img_w, (cy + bh / 2.0) / img_h], dim=-1)
    out = torch.clamp(out, 0.0, 1.0)
    var = torch.tensor([float(v) for v in variance], dtype=_F32, device=dev)
    return out, var.expand(H, W, A, 4).clone()


# ------------------------------------------------------------ deformable conv
def _deform_sample(x, py, px, dg):
    """Bilinear samples of x [B, C, H, W] at the fractional coordinates
    py/px [B, dg, K, Ho, Wo] of each deformable group -> [B, C, K, Ho, Wo].
    A corner counts only while it lies inside the map (the reference's
    im2col border rule), so a point sliding off the edge fades to zero.
    The gather index is [B, dg, 1, L], broadcast over the group's
    channels."""
    b, c, h, w = x.shape
    cpg = c // dg
    shape = py.shape
    length = shape[2] * shape[3] * shape[4]
    xf = x.reshape(b, dg, cpg, h * w)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    acc = None
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yc = y0 + dy
        xc = x0 + dx
        wgt = (1 - torch.abs(py - yc)) * (1 - torch.abs(px - xc))
        valid = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
        wgt = torch.where(valid, wgt, 0.0)
        yi = torch.clamp(yc, 0, h - 1).long()
        xi = torch.clamp(xc, 0, w - 1).long()
        flat = (yi * w + xi).reshape(b, dg, 1, length)
        gathered = torch.gather(xf, 3, flat.expand(b, dg, cpg, length))
        part = gathered * wgt.reshape(b, dg, 1, length).to(x.dtype)
        acc = part if acc is None else acc + part
    return acc.reshape(b, c, *shape[2:])


@boundary
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0, dilation=1,
                  deformable_groups=1, groups=1, mask=None, name=None):
    """Deformable convolution, v1 (``mask`` None) and v2 (modulated).
    ``offset`` [B, 2 * dg * K, Ho, Wo] holds (Δy, Δx) per tap:
    offset[:, 2 * (g * K + k)] is Δy of deformable group g, tap k; ``mask``
    [B, dg * K, Ho, Wo]; ``weight`` [out, in / groups, kh, kw]."""
    stride = _pair(stride)
    dilation = _pair(dilation)
    pads = [(p, p) if isinstance(p, int) else tuple(p) for p in _norm_padding(padding, 2)]
    dg = int(deformable_groups)
    groups = int(groups)
    bsz, c, h, wdt = x.shape
    cout, cpg_w, kh, kw = weight.shape
    k = kh * kw
    ho = (h + pads[0][0] + pads[0][1] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (wdt + pads[1][0] + pads[1][1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    dev = x.device
    iy = torch.arange(ho, device=dev) * stride[0] - pads[0][0]
    ix = torch.arange(wo, device=dev) * stride[1] - pads[1][0]
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dilation[0],
                            torch.arange(kw, device=dev) * dilation[1], indexing="ij")
    base_y = iy[None, :, None] + ky.reshape(-1)[:, None, None]  # [K, Ho, 1]
    base_x = ix[None, None, :] + kx.reshape(-1)[:, None, None]  # [K, 1, Wo]
    off = offset.reshape(bsz, dg, k, 2, ho, wo)
    py = base_y[None, None] + off[:, :, :, 0]
    px = base_x[None, None] + off[:, :, :, 1]
    sampled = _deform_sample(x, py, px, dg)  # [B, C, K, Ho, Wo]
    if mask is not None:
        m = mask.reshape(bsz, dg, 1, k, ho, wo).to(sampled.dtype)
        sampled = (sampled.reshape(bsz, dg, c // dg, k, ho, wo) * m)
    # grouped contraction: out group g uses in-channel block g
    sampled = sampled.reshape(bsz, groups, (c // groups) * k, ho * wo)
    wg = weight.reshape(groups, cout // groups, cpg_w * k)
    y = torch.matmul(wg[None], sampled).reshape(bsz, cout, ho, wo)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y


class DeformConv2D(Layer):
    """Deformable conv layer: weight [out, in / groups, kh, kw] (+ bias)
    applied by ``deform_conv2d``; ``forward(x, offset, mask=None)``, None
    for v1, a mask for v2 (modulated)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, deformable_groups=1, groups=1, weight_attr=None, bias_attr=None):
        from ..nn import initializer

        super().__init__()
        ks = tuple(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size, kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        bound = 1.0 / np.sqrt(in_channels // groups * ks[0] * ks[1])
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, ks[0], ks[1]], attr=weight_attr,
            default_initializer=initializer.Uniform(-bound, bound))
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=initializer.Uniform(-bound, bound))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, bias=self.bias, stride=self._stride,
                             padding=self._padding, dilation=self._dilation,
                             deformable_groups=self._deformable_groups, groups=self._groups,
                             mask=mask)
