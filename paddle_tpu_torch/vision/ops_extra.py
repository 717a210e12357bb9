"""The rest of the detection ops (``paddle_tpu/vision/ops_extra.py``):
``yolo_loss``, ``prior_box``, ``matrix_nms``, ``psroi_pool`` and
``PSRoIPool``, ``distribute_fpn_proposals``, ``generate_proposals``,
``read_file`` and ``decode_jpeg``.

``yolo_loss`` and ``psroi_pool`` are torch functions of their inputs run
through ``apply_op`` on the inputs' device, so their gradients are torch
autograd's. ``yolo_loss`` builds its dense targets for the whole batch at
once by scatters (``amax`` for the objectness and the box weight, sums for
the offsets and the class targets), in float64 as the JAX package's
targets are, so the loss is float64 as there. The post-processing ops
(``prior_box``, ``matrix_nms``, ``distribute_fpn_proposals``,
``generate_proposals``) run on the host in numpy, as in the JAX package
and the reference's CPU kernels, and return tensors on their input's
device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..autograd.engine import apply_op
from ..device import default_device
from ..ops._apply import ensure_tensor
from ..ops.math import clip_tensor as _clip
from ..tensor import Tensor

__all__ = ["yolo_loss", "prior_box", "matrix_nms", "psroi_pool", "PSRoIPool",
           "distribute_fpn_proposals", "generate_proposals", "read_file",
           "decode_jpeg"]


def _host(x) -> np.ndarray:
    return np.asarray(ensure_tensor(x).numpy())


def _on(arr: np.ndarray, device) -> Tensor:
    return Tensor._wrap(torch.from_numpy(np.ascontiguousarray(arr))
                        .to(device))


def _device(x):
    return ensure_tensor(x)._value.device


def _bce(logits, target):
    return torch.logaddexp(logits, torch.zeros_like(logits)) - target * logits


def _yolo_targets(boxes, labels, scores, best_anchor, gi, gj, gt_valid,
                  anchors_all, mask, class_num, H, W, img_size,
                  use_label_smooth):
    """Dense float64 targets ``[B, na, H, W]`` (``[B, na, C, H, W]`` for
    the classes) by scatters over every image's gt rows at once."""
    B, M = boxes.shape[:2]
    na = len(mask)
    dev = boxes.device
    f64 = torch.float64
    mask_arr = torch.tensor(mask, device=dev)
    hit = best_anchor[..., None] == mask_arr                # [B, M, na]
    ai = hit.to(torch.int64).argmax(-1)                     # first, else 0
    w_ok = gt_valid & hit.any(-1)
    cell = (torch.arange(B, device=dev)[:, None] * na + ai) * (H * W) \
        + gj * W + gi                                       # [B, M]
    cell = cell.reshape(-1)
    n = B * na * H * W
    zero = torch.zeros((), dtype=f64, device=dev)

    def scatter_max(vals):
        out = torch.zeros(n, dtype=f64, device=dev)
        return out.scatter_reduce(0, cell, vals.reshape(-1).to(f64), "amax",
                                  include_self=True).reshape(B, na, H, W)

    def scatter_add(vals):
        out = torch.zeros(n, dtype=f64, device=dev)
        return out.index_add(0, cell, vals.reshape(-1).to(f64)).reshape(
            B, na, H, W)

    obj_t = scatter_max(torch.where(w_ok, scores, zero))
    wgt = scatter_max(torch.where(w_ok, 2.0 - boxes[..., 2] * boxes[..., 3],
                                  zero))
    tx = scatter_add(torch.where(w_ok, boxes[..., 0] * W - gi, zero))
    ty = scatter_add(torch.where(w_ok, boxes[..., 1] * H - gj, zero))
    anchor_wh = anchors_all[best_anchor]                     # [B, M, 2]
    tw = scatter_add(torch.where(w_ok, torch.log(_clip(
        boxes[..., 2] * img_size / anchor_wh[..., 0], 1e-9)), zero))
    th = scatter_add(torch.where(w_ok, torch.log(_clip(
        boxes[..., 3] * img_size / anchor_wh[..., 1], 1e-9)), zero))
    smooth = (1.0 / class_num if use_label_smooth and class_num > 1
              else 0.0)
    # out-of-range labels give a zero row, as jax.nn.one_hot's do
    onehot = (labels.reshape(B, M, 1) == torch.arange(
        class_num, device=dev)).to(f64)
    onehot = onehot * (1.0 - smooth) + smooth / class_num
    tcls = torch.zeros(n, class_num, dtype=f64, device=dev).index_add(
        0, cell, torch.where(w_ok[..., None], onehot, zero).reshape(
            -1, class_num))
    tcls = tcls.reshape(B, na, H, W, class_num).permute(0, 1, 4, 2, 3)
    return obj_t, tx, ty, tw, th, tcls, wgt


def _best_iou(pred, gt, valid):
    """Each predicted xywh box's best IoU over an image's valid gt boxes:
    ``[B, P]`` for ``pred`` ``[B, P, 4]`` and ``gt`` ``[B, M, 4]``."""
    px1 = pred[..., 0] - pred[..., 2] / 2
    py1 = pred[..., 1] - pred[..., 3] / 2
    px2 = pred[..., 0] + pred[..., 2] / 2
    py2 = pred[..., 1] + pred[..., 3] / 2
    gx1 = gt[..., 0] - gt[..., 2] / 2
    gy1 = gt[..., 1] - gt[..., 3] / 2
    gx2 = gt[..., 0] + gt[..., 2] / 2
    gy2 = gt[..., 1] + gt[..., 3] / 2
    iw = _clip(torch.minimum(px2[..., None], gx2[:, None])
               - torch.maximum(px1[..., None], gx1[:, None]), 0.0)
    ih = _clip(torch.minimum(py2[..., None], gy2[:, None])
               - torch.maximum(py1[..., None], gy1[:, None]), 0.0)
    inter = iw * ih
    uni = ((px2 - px1) * (py2 - py1))[..., None] \
        + ((gx2 - gx1) * (gy2 - gy1))[:, None] - inter
    iou = inter / _clip(uni, 1e-9)
    return (iou * valid[:, None]).amax(-1)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 loss per image: coordinate BCE and MSE plus objectness and
    class BCE, each gt assigned to its best anchor by wh-IoU; predictions
    over ``ignore_thresh`` IoU with any gt and no target leave the
    no-object term. ``gt_box`` ``[B, M, 4]`` normalized xywh (rows of
    width 0 are padding)."""
    xt = ensure_tensor(x)
    ins = [xt, ensure_tensor(gt_box), ensure_tensor(gt_label)]
    if gt_score is not None:
        ins.append(ensure_tensor(gt_score))
    an = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask = list(anchor_mask)
    na = len(mask)

    def fn(xv, boxes, labels, *rest):
        B, C, H, W = xv.shape
        dev = xv.device
        xv = xv.reshape(B, na, 5 + class_num, H, W)
        px = torch.sigmoid(xv[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
        py = torch.sigmoid(xv[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
        pw, ph, pobj = xv[:, :, 2], xv[:, :, 3], xv[:, :, 4]
        pcls = xv[:, :, 5:]
        img_size = float(downsample_ratio * H)
        anchors_all = torch.from_numpy(an).to(dev)
        anchors_used = anchors_all[torch.tensor(mask, device=dev)]
        gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None,
                                                              None, :]
        gy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :,
                                                              None]
        bx = (px + gx) / W
        by = (py + gy) / H
        bw = torch.exp(pw) * anchors_used[None, :, 0, None, None] / img_size
        bh = torch.exp(ph) * anchors_used[None, :, 1, None, None] / img_size

        gt_valid = boxes[..., 2] > 0
        gw = boxes[..., 2] * img_size
        gh = boxes[..., 3] * img_size
        inter = (torch.minimum(gw[..., None], anchors_all[:, 0])
                 * torch.minimum(gh[..., None], anchors_all[:, 1]))
        union = (gw * gh)[..., None] + (anchors_all[:, 0]
                                        * anchors_all[:, 1]) - inter
        best_anchor = torch.argmax(inter / _clip(union, 1e-9), -1)
        gi = (boxes[..., 0] * W).to(torch.int32).clamp(0, W - 1)
        gj = (boxes[..., 1] * H).to(torch.int32).clamp(0, H - 1)
        scores = rest[0] if rest else torch.ones(
            boxes.shape[:2], dtype=torch.float64, device=dev)
        obj_t, tx, ty, tw, th, tcls, wgt = _yolo_targets(
            boxes, labels, scores, best_anchor, gi.to(torch.int64),
            gj.to(torch.int64), gt_valid, anchors_all, mask, class_num, H,
            W, img_size, use_label_smooth)

        pos = obj_t > 0
        loss_xy = (wgt * (_bce(xv[:, :, 0], tx) + _bce(xv[:, :, 1], ty))
                   * pos).sum((1, 2, 3))
        loss_wh = (wgt * ((pw - tw) ** 2 + (ph - th) ** 2)
                   * pos * 0.5).sum((1, 2, 3))
        pb = torch.stack([bx, by, bw, bh], -1).reshape(B, -1, 4)
        ignore = (_best_iou(pb, boxes, gt_valid) > ignore_thresh).reshape(
            B, na, H, W)
        noobj = (~pos) & (~ignore)
        loss_obj = (_bce(pobj, obj_t) * (pos | noobj)).sum((1, 2, 3))
        loss_cls = (_bce(pcls, tcls) * pos[:, :, None]).sum((1, 2, 3, 4))
        return loss_xy + loss_wh + loss_obj + loss_cls

    return apply_op(fn, ins, name="yolo_loss")


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes ``[H, W, num_priors, 4]`` (normalized xyxy) and
    their variances."""
    inp = ensure_tensor(input)
    img = ensure_tensor(image)
    H, W = int(inp.shape[2]), int(inp.shape[3])
    img_h, img_w = int(img.shape[2]), int(img.shape[3])
    step_w = steps[0] or img_w / W
    step_h = steps[1] or img_h / H

    ratios = []
    for ar in aspect_ratios:
        ratios.append(ar)
        if flip and ar != 1.0:
            ratios.append(1.0 / ar)

    # prior order per min_size: min box, ratio boxes, max box; with
    # min_max_aspect_ratios_order the max box comes second (SSD's order)
    whs = []
    for i, s in enumerate(min_sizes):
        whs.append((s, s))
        max_wh = None
        if max_sizes:
            m = math.sqrt(s * max_sizes[i])
            max_wh = (m, m)
        ratio_whs = [(s * math.sqrt(ar), s / math.sqrt(ar))
                     for ar in ratios if ar != 1.0]
        if min_max_aspect_ratios_order:
            if max_wh:
                whs.append(max_wh)
            whs.extend(ratio_whs)
        else:
            whs.extend(ratio_whs)
            if max_wh:
                whs.append(max_wh)
    num_priors = len(whs)

    cx = (np.arange(W) + offset) * step_w
    cy = (np.arange(H) + offset) * step_h
    gx, gy = np.meshgrid(cx, cy)
    out = np.zeros((H, W, num_priors, 4), np.float32)
    for k, (bw, bh) in enumerate(whs):
        out[..., k, 0] = (gx - bw / 2) / img_w
        out[..., k, 1] = (gy - bh / 2) / img_h
        out[..., k, 2] = (gx + bw / 2) / img_w
        out[..., k, 3] = (gy + bh / 2) / img_h
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          out.shape).copy()
    dev = inp._value.device
    return _on(out, dev), _on(var, dev)


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2's soft suppression): each box's score decays by
    its overlap with the higher-scored boxes of its class. Rows ``[label,
    score, x1, y1, x2, y2]``."""
    bv = _host(bboxes)                                 # [B, M, 4]
    sv = _host(scores)                                 # [B, C, M]
    dev = _device(bboxes)
    all_out, all_idx, rois_num = [], [], []
    B, C, M = sv.shape
    for b in range(B):
        outs, idxs = [], []
        for c in range(C):
            if c == background_label:
                continue
            sc = sv[b, c]
            keep = sc > score_threshold
            if not keep.any():
                continue
            cand = np.nonzero(keep)[0]
            order = cand[np.argsort(-sc[cand])][:nms_top_k]
            boxes = bv[b, order]
            s = sc[order]
            x1, y1, x2, y2 = boxes.T
            off = 0.0 if normalized else 1.0
            area = (x2 - x1 + off) * (y2 - y1 + off)
            iw = np.maximum(np.minimum(x2[:, None], x2[None])
                            - np.maximum(x1[:, None], x1[None]) + off, 0)
            ih = np.maximum(np.minimum(y2[:, None], y2[None])
                            - np.maximum(y1[:, None], y1[None]) + off, 0)
            inter = iw * ih
            iou = inter / np.maximum(area[:, None] + area[None] - inter,
                                     1e-9)
            iou = np.triu(iou, 1)  # iou[i, j] for suppressor i < candidate j
            # a suppressor's own max overlap with the boxes above it
            comp = iou.max(axis=0)
            if use_gaussian:
                decay_m = np.exp(-(iou ** 2 - comp[:, None] ** 2)
                                 / gaussian_sigma)
            else:
                decay_m = (1 - iou) / np.maximum(1 - comp[:, None], 1e-9)
            # a candidate decays by its worst suppressor (min over i < j)
            decay = np.minimum(decay_m, 1.0).min(axis=0)
            ds = s * decay
            ok = ds > post_threshold
            for i in np.nonzero(ok)[0]:
                outs.append([c, ds[i], *boxes[i]])
                idxs.append(b * M + order[i])
        outs = np.asarray(outs, np.float32).reshape(-1, 6)
        idxs = np.asarray(idxs, np.int64)
        if keep_top_k > 0 and len(outs) > keep_top_k:
            top = np.argsort(-outs[:, 1])[:keep_top_k]
            outs, idxs = outs[top], idxs[top]
        all_out.append(outs)
        all_idx.append(idxs)
        rois_num.append(len(outs))
    out = _on(np.concatenate(all_out) if all_out
              else np.zeros((0, 6), np.float32), dev)
    res = [out]
    if return_index:
        res.append(_on(np.concatenate(all_idx) if all_idx
                       else np.zeros(0, np.int64), dev))
    if return_rois_num:
        res.append(_on(np.asarray(rois_num, np.int32), dev))
    return tuple(res) if len(res) > 1 else out


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (R-FCN): channel group (i, j)
    averages spatial bin (i, j) of the roi, on the first image, as in the
    JAX package. ``[num_rois, C / (oh * ow), oh, ow]``."""
    if isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = output_size
    xt = ensure_tensor(x)
    bt = ensure_tensor(boxes)
    C = int(xt.shape[1])
    if C % (oh * ow):
        raise ValueError(f"channels {C} not divisible by output bins "
                         f"{oh}x{ow}")
    out_c = C // (oh * ow)

    def fn(xv, bx):
        H, W = xv.shape[2], xv.shape[3]
        dev = xv.device
        b = bx * spatial_scale
        x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        rh = _clip(y2 - y1, 0.1) / oh
        rw = _clip(x2 - x1, 0.1) / ow
        ys = torch.arange(H, dtype=torch.float32, device=dev)
        xs = torch.arange(W, dtype=torch.float32, device=dev)
        i = torch.arange(oh, device=dev)
        j = torch.arange(ow, device=dev)
        y_lo = y1[:, None] + i * rh[:, None]
        y_hi = y1[:, None] + (i + 1) * rh[:, None]
        x_lo = x1[:, None] + j * rw[:, None]
        x_hi = x1[:, None] + (j + 1) * rw[:, None]
        my = ((ys >= torch.floor(y_lo)[..., None])
              & (ys < torch.ceil(y_hi)[..., None])).to(xv.dtype)  # [R,oh,H]
        mx = ((xs >= torch.floor(x_lo)[..., None])
              & (xs < torch.ceil(x_hi)[..., None])).to(xv.dtype)  # [R,ow,W]
        m = my[:, :, None, :, None] * mx[:, None, :, None, :]
        denom = _clip(m.sum((3, 4)), 1.0)            # [R,oh,ow]
        grp = xv[0].reshape(oh, ow, out_c, H, W)
        out = torch.einsum("rijhw,ijchw->rcij", m, grp)
        return out / denom[:, None]

    return apply_op(fn, [xt, bt], name="psroi_pool")


class PSRoIPool:
    """The callable form of :func:`psroi_pool`."""

    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Assign rois to FPN levels by scale: level = floor(refer +
    log2(sqrt(area) / refer_scale)), clipped. Returns the rois of each
    level (image-major within a level), the index that restores the input
    order and, with ``rois_num``, each level's count per image."""
    rv = _host(fpn_rois)
    dev = _device(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    w = rv[:, 2] - rv[:, 0] + off
    h = rv[:, 3] - rv[:, 1] + off
    scale = np.sqrt(np.maximum(w * h, 1e-9))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-9)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    if rois_num is not None:
        counts = _host(rois_num).astype(np.int64)
        img_of = np.repeat(np.arange(len(counts)), counts)
    else:
        counts = None
        img_of = np.zeros(len(rv), np.int64)
    multi_rois, order = [], []
    rois_num_per_level = [] if counts is not None else None
    for L in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == L)[0]
        idx = idx[np.argsort(img_of[idx], kind="stable")]
        multi_rois.append(_on(rv[idx], dev))
        order.append(idx)
        if counts is not None:
            per_img = np.asarray(
                [int((img_of[idx] == b).sum()) for b in range(len(counts))],
                np.int32)
            rois_num_per_level.append(_on(per_img, dev))
    order = np.concatenate(order) if order else np.zeros(0, np.int64)
    restore_ind = np.empty_like(order)
    restore_ind[order] = np.arange(len(order))
    out = (multi_rois, _on(restore_ind[:, None], dev))
    if rois_num_per_level is not None:
        out = out + (rois_num_per_level,)
    return out


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False, name=None):
    """RPN proposals: anchors decoded by the deltas, clipped to the image,
    the small ones dropped, then NMS and the top ``post_nms_top_n``."""
    from .ops import nms as _nms

    sv = _host(scores)                                # [B, A, H, W]
    dv = _host(bbox_deltas)                           # [B, 4A, H, W]
    iv = _host(img_size)                              # [B, 2]
    av = _host(anchors).reshape(-1, 4)
    vv = _host(variances).reshape(-1, 4)
    dev = _device(scores)
    B, A, H, W = sv.shape
    off = 1.0 if pixel_offset else 0.0

    all_rois, all_nums, all_scores = [], [], []
    for b in range(B):
        s = sv[b].transpose(1, 2, 0).reshape(-1)          # [H*W*A]
        d = dv[b].reshape(A, 4, H, W).transpose(2, 3, 0, 1).reshape(-1, 4)
        anc = np.broadcast_to(av.reshape(1, 1, A, 4), (H, W, A, 4)
                              ).reshape(-1, 4) if av.shape[0] == A else av
        var = np.broadcast_to(vv.reshape(1, 1, A, 4), (H, W, A, 4)
                              ).reshape(-1, 4) if vv.shape[0] == A else vv
        aw = anc[:, 2] - anc[:, 0] + off
        ah = anc[:, 3] - anc[:, 1] + off
        acx = anc[:, 0] + aw / 2
        acy = anc[:, 1] + ah / 2
        cx = var[:, 0] * d[:, 0] * aw + acx
        cy = var[:, 1] * d[:, 1] * ah + acy
        bw = aw * np.exp(np.minimum(var[:, 2] * d[:, 2], 10.0))
        bh = ah * np.exp(np.minimum(var[:, 3] * d[:, 3], 10.0))
        boxes = np.stack([cx - bw / 2, cy - bh / 2,
                          cx + bw / 2 - off, cy + bh / 2 - off], 1)
        ih, iw = iv[b]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, iw - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ih - off)
        order = np.argsort(-s)[:pre_nms_top_n]
        boxes, s2 = boxes[order], s[order]
        wv2 = boxes[:, 2] - boxes[:, 0] + off
        hv2 = boxes[:, 3] - boxes[:, 1] + off
        ok = (wv2 >= min_size) & (hv2 >= min_size)
        boxes, s2 = boxes[ok], s2[ok]
        if len(boxes):
            keep = np.asarray(_nms(_on(boxes, dev), nms_thresh,
                                   scores=_on(s2, dev)).numpy())
            keep = keep[:post_nms_top_n]
            boxes, s2 = boxes[keep], s2[keep]
        all_rois.append(boxes)
        all_scores.append(s2)
        all_nums.append(len(boxes))
    rois = _on(np.concatenate(all_rois) if all_rois
               else np.zeros((0, 4), np.float32), dev)
    rscores = _on(np.concatenate(all_scores) if all_scores
                  else np.zeros((0,), np.float32), dev)
    if return_rois_num:
        return rois, rscores, _on(np.asarray(all_nums, np.int32), dev)
    return rois, rscores


def read_file(filename: str, name=None) -> Tensor:
    """A file's raw bytes as a uint8 tensor on the default device."""
    with open(filename, "rb") as f:
        data = f.read()
    return _on(np.frombuffer(data, np.uint8).copy(), default_device())


def decode_jpeg(x, mode: str = "unchanged", name=None) -> Tensor:
    """JPEG bytes decoded on the host to a CHW uint8 tensor on the default
    device (``mode`` ``gray``, ``rgb`` or ``unchanged``). Needs Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decode_jpeg needs Pillow, which is not installed; decode "
            "offline and feed .npy arrays instead") from e
    import io as _io

    raw = bytes(np.asarray(_host(x), np.uint8).tobytes())
    img = Image.open(_io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return _on(arr, default_device())
