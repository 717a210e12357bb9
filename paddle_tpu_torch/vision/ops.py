"""Vision ops (``paddle_tpu/vision/ops.py``): ``box_area``, ``box_iou``,
``nms``, ``roi_align``, ``roi_pool``, ``box_coder``, ``yolo_box``,
``deform_conv2d`` and the layers ``DeformConv2D``, ``RoIAlign`` and
``RoIPool``; the rest of the detection ops are in :mod:`.ops_extra`.

Each op is the JAX package's ``jnp`` function written in torch and run
through ``apply_op`` on the tensors' own device, with the same fixed-size
outputs and the same dtypes, so its gradient is torch autograd's:

- ``nms`` sorts by score (stable), builds the IoU matrix and suppresses
  in a loop of n device steps, none of which reads a value on the host;
  the compaction of the kept indices to Paddle's dynamic shape then runs
  on the host, eagerly, as in the JAX package.
- ``roi_align``, ``roi_pool`` and ``deform_conv2d`` sample by gathers over
  the flattened feature map (every roi, channel and tap at once) where the
  JAX package maps a function over rois and channels;
  ``deform_conv2d``'s product is one ``torch.matmul`` over the sampled
  columns.
- A roi's image is found from ``boxes_num`` by a ``searchsorted`` over
  its running sum, on the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import nn
from ..autograd.engine import apply_op
from ..ops._apply import ensure_tensor
from ..tensor import Tensor
from .ops_extra import _clip
from .ops_extra import (  # noqa: F401
    PSRoIPool, decode_jpeg, distribute_fpn_proposals, generate_proposals,
    matrix_nms, prior_box, psroi_pool, read_file, yolo_loss,
)

__all__ = ["yolo_loss", "prior_box", "matrix_nms", "psroi_pool", "PSRoIPool",
           "distribute_fpn_proposals", "generate_proposals", "read_file",
           "decode_jpeg",
           "nms", "roi_align", "roi_pool", "box_coder", "yolo_box", "box_area",
           "box_iou", "deform_conv2d", "DeformConv2D", "RoIAlign", "RoIPool"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def box_area(boxes):
    """Areas of ``[N, 4]`` xyxy boxes."""
    return apply_op(lambda v: (v[:, 2] - v[:, 0]) * (v[:, 3] - v[:, 1]),
                    [ensure_tensor(boxes)], name="box_area")


def _pairwise_iou(a, b):
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = _clip(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-10)


def box_iou(boxes1, boxes2):
    """IoU of every pair of two ``[N, 4]`` and ``[M, 4]`` box sets."""
    return apply_op(_pairwise_iou, [ensure_tensor(boxes1),
                                    ensure_tensor(boxes2)], name="box_iou")


def _nms_order(bv, sv, iou_threshold, cat):
    """The kept indices in score order, then -1 for the suppressed: the
    JAX kernel's fixed-size output, on ``bv``'s device."""
    n = bv.shape[0]
    order = torch.argsort(-sv, stable=True)
    bb = bv[order]
    iou = _pairwise_iou(bb, bb)
    if cat is not None:  # only boxes of one category suppress each other
        cv = cat[order]
        iou = torch.where(cv[:, None] == cv[None, :], iou,
                          torch.zeros((), dtype=iou.dtype, device=iou.device))
    # over[i, j]: a higher-scored j overlaps i (j < i)
    over = torch.tril(iou > iou_threshold, diagonal=-1)
    keep = torch.ones(n, dtype=torch.bool, device=bv.device)
    for i in range(1, n):
        keep[i] = ~(over[i] & keep).any()
    kept = torch.where(keep, order, torch.full_like(order, -1))
    # stable partition: the kept first, in score order
    return kept[torch.argsort((~keep).to(torch.uint8), stable=True)]


def nms(boxes, iou_threshold: float = 0.3, scores=None, category_idxs=None,
        categories=None, top_k: Optional[int] = None):
    """Greedy suppression: the kept indices, sorted by score (descending;
    without ``scores``, in index order). With ``category_idxs`` only boxes
    of one category suppress each other; ``top_k`` keeps the first k."""
    b = ensure_tensor(boxes)
    n = b.shape[0]
    dev = b._value.device
    sv = (torch.arange(n, 0, -1, dtype=torch.float32, device=dev)
          if scores is None else ensure_tensor(scores)._value)
    cat = None if category_idxs is None else \
        ensure_tensor(category_idxs)._value
    with torch.no_grad():
        out = _nms_order(b._value.detach(), sv.detach(), iou_threshold, cat)
    # host-side compaction to Paddle's dynamic shape (eager only)
    vals = out.cpu().numpy()
    vals = vals[vals >= 0]
    if top_k is not None:
        vals = vals[:top_k]
    return Tensor._wrap(torch.from_numpy(vals.astype(np.int64)).to(dev))


def _image_of_roi(rois_num, R):
    """Each of ``R`` rois' image index from the per-image counts."""
    ends = torch.cumsum(rois_num.to(torch.int64), 0)
    r = torch.arange(R, device=rois_num.device)
    return torch.searchsorted(ends, r, right=True).clamp(
        max=rois_num.shape[0] - 1)


def _gather_hw(feat, img, yi, xi):
    """``feat[img[r], :, yi[r, a], xi[r, b]]`` as ``[R, C, A, B]``."""
    N, C, H, W = feat.shape
    flat = feat.reshape(N, C, H * W)
    idx = yi[:, :, None] * W + xi[:, None, :]              # [R, A, B]
    vals = flat[img[:, None, None], :, idx]                # [R, A, B, C]
    return vals.permute(0, 3, 1, 2)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = -1, aligned: bool = True, name=None):
    """Bilinear sampling of box regions to ``[num_rois, C, out_h, out_w]``
    (``sampling_ratio`` samples a bin side, 2 when not positive)."""
    xt, bt = ensure_tensor(x), ensure_tensor(boxes)
    oh, ow = _pair(output_size)
    bn = ensure_tensor(boxes_num)

    def fn(feat, rois, rois_num):
        N, C, H, W = feat.shape
        R = rois.shape[0]
        img = _image_of_roi(rois_num, R)
        off = 0.5 if aligned else 0.0
        x1 = rois[:, 0] * spatial_scale - off
        y1 = rois[:, 1] * spatial_scale - off
        x2 = rois[:, 2] * spatial_scale - off
        y2 = rois[:, 3] * spatial_scale - off
        rw = _clip(x2 - x1, 1e-3 if aligned else 1.0)
        rh = _clip(y2 - y1, 1e-3 if aligned else 1.0)
        sr = sampling_ratio if sampling_ratio > 0 else 2
        ar_y = torch.arange(oh * sr, device=feat.device) + 0.5
        ar_x = torch.arange(ow * sr, device=feat.device) + 0.5
        ys = y1[:, None] + ar_y[None, :] * rh[:, None] / (oh * sr)
        xs = x1[:, None] + ar_x[None, :] * rw[:, None] / (ow * sr)
        y0 = torch.floor(ys).to(torch.int64).clamp(0, H - 1)
        x0 = torch.floor(xs).to(torch.int64).clamp(0, W - 1)
        y1_ = (y0 + 1).clamp(0, H - 1)
        x1_ = (x0 + 1).clamp(0, W - 1)
        wy = _clip(ys - y0, 0.0, 1.0)[:, None, :, None]
        wx = _clip(xs - x0, 0.0, 1.0)[:, None, None, :]
        samp = (_gather_hw(feat, img, y0, x0) * (1 - wy) * (1 - wx)
                + _gather_hw(feat, img, y0, x1_) * (1 - wy) * wx
                + _gather_hw(feat, img, y1_, x0) * wy * (1 - wx)
                + _gather_hw(feat, img, y1_, x1_) * wy * wx)
        return samp.reshape(R, C, oh, sr, ow, sr).mean(dim=(3, 5))

    return apply_op(fn, [xt, bt, Tensor._wrap(bn._value.detach())],
                    name="roi_align")


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
             name=None):
    """Max pooling of box regions over a dense grid of 4 x 4 samples a
    bin, to ``[num_rois, C, out_h, out_w]``."""
    xt, bt = ensure_tensor(x), ensure_tensor(boxes)
    oh, ow = _pair(output_size)
    bn = ensure_tensor(boxes_num)

    def fn(feat, rois, rois_num):
        N, C, H, W = feat.shape
        R = rois.shape[0]
        img = _image_of_roi(rois_num, R)
        sr = 4
        x1 = rois[:, 0] * spatial_scale
        y1 = rois[:, 1] * spatial_scale
        x2 = rois[:, 2] * spatial_scale
        y2 = rois[:, 3] * spatial_scale
        rw = _clip(x2 - x1, 1.0)
        rh = _clip(y2 - y1, 1.0)
        ar_y = torch.arange(oh * sr, device=feat.device) + 0.5
        ar_x = torch.arange(ow * sr, device=feat.device) + 0.5
        ys = y1[:, None] + ar_y[None, :] * rh[:, None] / (oh * sr)
        xs = x1[:, None] + ar_x[None, :] * rw[:, None] / (ow * sr)
        yi = torch.round(ys).to(torch.int64).clamp(0, H - 1)
        xi = torch.round(xs).to(torch.int64).clamp(0, W - 1)
        samp = _gather_hw(feat, img, yi, xi)
        return samp.reshape(R, C, oh, sr, ow, sr).amax(dim=(3, 5))

    return apply_op(fn, [xt, bt, Tensor._wrap(bn._value.detach())],
                    name="roi_pool")


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size",
              box_normalized: bool = True, axis: int = 0, name=None):
    """Encode target boxes against priors as center-size offsets, or decode
    offsets back to xyxy boxes (``decode_center_size``)."""
    pb, tb = ensure_tensor(prior_box), ensure_tensor(target_box)
    pbv = ensure_tensor(prior_box_var) if prior_box_var is not None else None

    def fn(p, t, *v):
        norm = 0.0 if box_normalized else 1.0
        pw = p[:, 2] - p[:, 0] + norm
        ph = p[:, 3] - p[:, 1] + norm
        pcx = p[:, 0] + pw * 0.5
        pcy = p[:, 1] + ph * 0.5
        var = v[0] if v else torch.ones((1, 4), dtype=p.dtype,
                                        device=p.device)
        if code_type == "encode_center_size":
            tw = t[:, 2] - t[:, 0] + norm
            th = t[:, 3] - t[:, 1] + norm
            tcx = t[:, 0] + tw * 0.5
            tcy = t[:, 1] + th * 0.5
            out = torch.stack([
                (tcx[:, None] - pcx[None, :]) / pw[None, :],
                (tcy[:, None] - pcy[None, :]) / ph[None, :],
                torch.log(tw[:, None] / pw[None, :]),
                torch.log(th[:, None] / ph[None, :]),
            ], dim=-1)
            return out / var.reshape(1, -1, 4)
        d = t * var.reshape(1, -1, 4) if v else t
        if axis == 0:
            pw_, ph_, pcx_, pcy_ = (pw[None, :], ph[None, :], pcx[None, :],
                                    pcy[None, :])
        else:
            pw_, ph_, pcx_, pcy_ = (pw[:, None], ph[:, None], pcx[:, None],
                                    pcy[:, None])
        ocx = d[..., 0] * pw_ + pcx_
        ocy = d[..., 1] * ph_ + pcy_
        ow_ = torch.exp(d[..., 2]) * pw_
        oh_ = torch.exp(d[..., 3]) * ph_
        return torch.stack([ocx - ow_ / 2, ocy - oh_ / 2,
                            ocx + ow_ / 2 - norm, ocy + oh_ / 2 - norm],
                           dim=-1)

    ins = [pb, tb] + ([pbv] if pbv is not None else [])
    return apply_op(fn, ins, name="box_coder")


def yolo_box(x, img_size, anchors, class_num: int, conf_thresh: float = 0.01,
             downsample_ratio: int = 32, clip_bbox: bool = True, name=None,
             scale_x_y: float = 1.0, iou_aware: bool = False,
             iou_aware_factor: float = 0.5):
    """Decode a YOLO head's predictions: ``(boxes [N, anchors*H*W, 4],
    scores [N, anchors*H*W, class_num])``, boxes and scores under
    ``conf_thresh`` zeroed. With ``iou_aware`` the first ``anchors``
    channels are IoU logits and conf = obj^(1-f) * iou^f."""
    xt, st = ensure_tensor(x), ensure_tensor(img_size)
    na = len(anchors) // 2
    anc_np = np.asarray(anchors, dtype="float32").reshape(na, 2)

    def fn(v, imgs):
        N, C, H, W = v.shape
        anc = torch.from_numpy(anc_np).to(v.device)
        if iou_aware:
            iou = torch.sigmoid(v[:, :na].reshape(N, na, H, W))
            v = v[:, na:]
        v = v.reshape(N, na, -1, H, W)
        gx = torch.floor(torch.arange(W, dtype=torch.float32,
                                      device=v.device) + 0.5)
        gy = torch.floor(torch.arange(H, dtype=torch.float32,
                                      device=v.device) + 0.5)
        gx = gx[None, None, None, :]
        gy = gy[None, None, :, None]
        sx = torch.sigmoid(v[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
        sy = torch.sigmoid(v[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
        cx = (gx + sx) / W
        cy = (gy + sy) / H
        input_h = downsample_ratio * H
        input_w = downsample_ratio * W
        bw = torch.exp(v[:, :, 2]) * anc[None, :, 0, None, None] / input_w
        bh = torch.exp(v[:, :, 3]) * anc[None, :, 1, None, None] / input_h
        conf = torch.sigmoid(v[:, :, 4])
        if iou_aware:
            f = v.new_full((), iou_aware_factor)
            conf = conf ** (1.0 - f) * iou ** f
        cls = torch.sigmoid(v[:, :, 5:5 + class_num]) * conf[:, :, None]
        imh = imgs[:, 0].to(v.dtype)[:, None, None, None]
        imw = imgs[:, 1].to(v.dtype)[:, None, None, None]
        x1 = (cx - bw / 2) * imw
        y1 = (cy - bh / 2) * imh
        x2 = (cx + bw / 2) * imw
        y2 = (cy + bh / 2) * imh
        if clip_bbox:
            x1 = _clip(x1, 0.0)
            y1 = _clip(y1, 0.0)
            x2 = torch.minimum(x2, imw - 1)
            y2 = torch.minimum(y2, imh - 1)
        mask = (conf > conf_thresh).to(v.dtype)
        boxes = torch.stack([x1, y1, x2, y2], dim=-1) * mask[..., None]
        boxes = boxes.reshape(N, -1, 4)
        scores = (cls * mask[:, :, None]).permute(0, 1, 3, 4, 2).reshape(
            N, -1, class_num)
        return boxes, scores

    return apply_op(fn, [xt, Tensor._wrap(st._value.detach())],
                    name="yolo_box")


def _bilinear_taps(xp, sy, sx, dg):
    """Sample ``xp`` ``[N, C, Hp, Wp]`` at ``(sy, sx)`` ``[N, dg, K, oh,
    ow]`` (channel c reads its deformable group c // (C / dg)): ``[N, C,
    K, oh, ow]``. Corners are clipped into the map and a sample outside
    (-1, Hp) x (-1, Wp) is 0, as in the JAX package."""
    N, C, Hp, Wp = xp.shape
    cpg = C // dg
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = sy - y0
    wx = sx - x0
    y0i = y0.to(torch.int64).clamp(0, Hp - 1)
    x0i = x0.to(torch.int64).clamp(0, Wp - 1)
    y1i = (y0i + 1).clamp(0, Hp - 1)
    x1i = (x0i + 1).clamp(0, Wp - 1)
    ok = (sy > -1) & (sy < Hp) & (sx > -1) & (sx < Wp)
    flat = xp.reshape(N, dg, cpg, Hp * Wp)
    tail = sy.shape[2:]

    def tap(yi, xi):
        idx = (yi * Wp + xi).reshape(N, dg, 1, -1).expand(N, dg, cpg, -1)
        return torch.gather(flat, 3, idx).reshape(N, dg, cpg, *tail)

    e = lambda t: t[:, :, None]  # noqa: E731 - broadcast over cpg
    v = (tap(y0i, x0i) * e((1 - wy) * (1 - wx))
         + tap(y0i, x1i) * e((1 - wy) * wx)
         + tap(y1i, x0i) * e(wy * (1 - wx))
         + tap(y1i, x1i) * e(wy * wx))
    v = torch.where(e(ok), v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))
    return v.reshape(N, C, *tail)


def deform_conv2d(x, offset, weight, mask=None, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, name=None):
    """Deformable convolution, v1 (no ``mask``) and v2 (a modulation
    ``mask``): bilinear samples at the offset taps, then one product with
    the weight over the sampled columns."""
    xt = ensure_tensor(x)
    ot = ensure_tensor(offset)
    wt = ensure_tensor(weight)
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)

    def fn(xv, off, w, *rest):
        N, C, H, W = xv.shape
        Co, Cg, kh, kw = w.shape
        ph, pw = padding
        xp = torch.nn.functional.pad(xv, (pw, pw, ph, ph))
        Hp, Wp = H + 2 * ph, W + 2 * pw
        oh = (Hp - (dilation[0] * (kh - 1) + 1)) // stride[0] + 1
        ow = (Wp - (dilation[1] * (kw - 1) + 1)) // stride[1] + 1
        K = kh * kw
        off = off.reshape(N, deformable_groups, 2, K, oh, ow)
        dev = xv.device
        ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dilation[0],
                                torch.arange(kw, device=dev) * dilation[1],
                                indexing="ij")
        ky, kx = ky.reshape(-1), kx.reshape(-1)
        gy = torch.arange(oh, device=dev) * stride[0]
        gx = torch.arange(ow, device=dev) * stride[1]
        sy = (gy[None, None, None, :, None] + ky[None, None, :, None, None]
              + off[:, :, 0])
        sx = (gx[None, None, None, None, :] + kx[None, None, :, None, None]
              + off[:, :, 1])
        cols = _bilinear_taps(xp, sy, sx, deformable_groups)
        if mask is not None:
            m = rest[0].reshape(N, deformable_groups, 1, K, oh, ow)
            cols = (cols.reshape(N, deformable_groups, -1, K, oh, ow)
                    * m).reshape(N, C, K, oh, ow)
        cols = cols.reshape(N, C * K, oh * ow)
        wmat = w.reshape(Co, Cg * K)
        if groups == 1:
            out = torch.matmul(wmat, cols)
        else:
            cols_g = cols.reshape(N, groups, (C // groups) * K, oh * ow)
            wg = wmat.reshape(groups, Co // groups, Cg * K)
            out = torch.matmul(wg, cols_g).reshape(N, Co, oh * ow)
        out = out.reshape(N, Co, oh, ow)
        if bias is not None:
            out = out + rest[-1].reshape(1, -1, 1, 1)
        return out

    ins = [xt, ot, wt]
    if mask is not None:
        ins.append(ensure_tensor(mask))
    if bias is not None:
        ins.append(ensure_tensor(bias))
    return apply_op(fn, ins, name="deform_conv2d")


class DeformConv2D(nn.Layer):
    """The layer over :func:`deform_conv2d`: ``weight`` ``[out, in //
    groups, kh, kw]`` and ``bias`` ``[out]``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        ks = _pair(kernel_size)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           deformable_groups=deformable_groups, groups=groups)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *ks], attr=weight_attr)
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, mask=mask,
                             bias=self.bias, **self._attrs)


class RoIAlign(nn.Layer):
    """The layer over :func:`roi_align`."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale)


class RoIPool(nn.Layer):
    """The layer over :func:`roi_pool`."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)
