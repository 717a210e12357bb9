"""PP-YOLOE (``paddle_tpu/vision/models/detection.py``): ``CSPResNet``,
``CSPPAN``, ``PPYOLOEHead``, ``PPYOLOE`` and ``ppyoloe_s``/``_m``/``_l``.

Paddle ``Layer``s over the port's ``nn``, built as the JAX package builds
them, so weights carry across with ``set_state_dict``. The model is
anchor-free with static shapes: every level predicts a dense ``[H * W]``
grid, the loss assigns each anchor the smallest-area gt box containing
its center, and ``predict`` runs :func:`..ops.nms`.

What a CUDA graph needs: the head builds its anchor centers on the
feature map's device from ``torch.arange`` (the JAX package builds them in
numpy on every call; a host-to-device copy cannot run inside a capture),
and the DFL projection ``[0, 1, ..., reg_max]`` is made on the device
inside the op that uses it. The loss is one ``apply_op`` a level under the
JAX package's op names (``dfl_project``, ``dfl_decode``,
``ppyoloe_loss``), so ``auto_cast`` casts the same inputs, and it keeps
the JAX function's dtypes: the class target is float64 (``one_hot`` under
``jax_enable_x64``), the candidate areas float32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ... import nn
from ...autograd.engine import apply_op
from ...nn import functional as F
from ...ops._apply import ensure_tensor
from ...ops.manipulation import concat
from ...tensor import Tensor
from ..ops_extra import _clip

__all__ = ["CSPResNet", "CSPPAN", "PPYOLOEHead", "PPYOLOE",
           "ppyoloe_s", "ppyoloe_m", "ppyoloe_l"]


class ConvBNAct(nn.Layer):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, act="silu"):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=stride,
                              padding=(k - 1) // 2, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act == "silu" else x


class CSPBlock(nn.Layer):
    """CSPResNet block: split, residual convs, concat, fuse."""

    def __init__(self, ch, n=1):
        super().__init__()
        mid = ch // 2
        self.left = ConvBNAct(ch, mid, 1)
        self.right = ConvBNAct(ch, mid, 1)
        self.blocks = nn.LayerList([
            nn.Sequential(ConvBNAct(mid, mid, 3), ConvBNAct(mid, mid, 3))
            for _ in range(n)])
        self.fuse = ConvBNAct(2 * mid, ch, 1)

    def forward(self, x):
        left = self.left(x)
        y = self.right(x)
        for b in self.blocks:
            y = y + b(y)
        return self.fuse(concat([left, y], axis=1))


class CSPResNet(nn.Layer):
    """Backbone emitting the stride 8, 16 and 32 feature maps."""

    def __init__(self, width=0.50, depth=0.33, in_channels=3):
        super().__init__()
        chs = [int(c * width) for c in (64, 128, 256, 512, 1024)]
        n = max(1, round(3 * depth))
        self.stem = nn.Sequential(
            ConvBNAct(in_channels, chs[0], 3, stride=2),
            ConvBNAct(chs[0], chs[0], 3))
        self.stages = nn.LayerList()
        for i in range(4):
            self.stages.append(nn.Sequential(
                ConvBNAct(chs[i], chs[i + 1], 3, stride=2),
                CSPBlock(chs[i + 1], n)))
        self.out_channels = chs[2:]

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i >= 1:
                outs.append(x)
        return outs  # [C3/8, C4/16, C5/32]


class CSPPAN(nn.Layer):
    """PAN neck: top-down, then bottom-up fusion."""

    def __init__(self, in_channels: Sequence[int]):
        super().__init__()
        c3, c4, c5 = in_channels
        self.reduce5 = ConvBNAct(c5, c4, 1)
        self.td4 = CSPBlock(2 * c4)
        self.merge4 = ConvBNAct(2 * c4, c4, 1)
        self.reduce4 = ConvBNAct(c4, c3, 1)
        self.td3 = CSPBlock(2 * c3)
        self.merge3 = ConvBNAct(2 * c3, c3, 1)
        self.down3 = ConvBNAct(c3, c3, 3, stride=2)
        self.bu4 = ConvBNAct(c3 + c4, c4, 1)
        self.down4 = ConvBNAct(c4, c4, 3, stride=2)
        self.bu5 = ConvBNAct(c4 + c4, c4, 1)
        self.out_channels = [c3, c4, c4]

    def forward(self, feats):
        c3, c4, c5 = feats
        p5 = self.reduce5(c5)
        up5 = F.interpolate(p5, scale_factor=2, mode="nearest")
        p4 = self.merge4(self.td4(concat([up5, c4], axis=1)))
        p4r = self.reduce4(p4)
        up4 = F.interpolate(p4r, scale_factor=2, mode="nearest")
        p3 = self.merge3(self.td3(concat([up4, c3], axis=1)))
        n4 = self.bu4(concat([self.down3(p3), p4], axis=1))
        n5 = self.bu5(concat([self.down4(n4), p5], axis=1))
        return [p3, n4, n5]


def _centers(H: int, W: int, stride: int, device) -> Tensor:
    """Anchor centers ``[H * W, 2]`` (x, y) of a level, row-major, built
    on ``device``."""
    ys = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) * stride
    xs = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) * stride
    return Tensor._wrap(torch.stack([xs[None, :].expand(H, W).reshape(-1),
                                     ys[:, None].expand(H, W).reshape(-1)],
                                    dim=-1))


class PPYOLOEHead(nn.Layer):
    """Anchor-free decoupled head with DFL regression (ESE attention
    dropped, as in the JAX package)."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 reg_max: int = 16, strides=(8, 16, 32)):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.strides = list(strides)
        self.stem_cls = nn.LayerList(
            [ConvBNAct(c, c, 1) for c in in_channels])
        self.stem_reg = nn.LayerList(
            [ConvBNAct(c, c, 1) for c in in_channels])
        self.pred_cls = nn.LayerList(
            [nn.Conv2D(c, num_classes, 3, padding=1) for c in in_channels])
        self.pred_reg = nn.LayerList(
            [nn.Conv2D(c, 4 * (reg_max + 1), 3, padding=1)
             for c in in_channels])

    def forward(self, feats):
        """Per level ``(cls_logits [B, HW, C], reg_logits [B, HW, 4,
        reg_max + 1], anchor centers [HW, 2], stride)``."""
        outs = []
        for i, f in enumerate(feats):
            B = f.shape[0]
            H, W = f.shape[2], f.shape[3]
            cls = self.pred_cls[i](self.stem_cls[i](f) + f)
            reg = self.pred_reg[i](self.stem_reg[i](f))
            cls = cls.transpose([0, 2, 3, 1]).reshape([B, H * W,
                                                       self.num_classes])
            reg = reg.transpose([0, 2, 3, 1]).reshape(
                [B, H * W, 4, self.reg_max + 1])
            s = self.strides[i]
            outs.append((cls, reg, _centers(H, W, s, f._value.device), s))
        return outs

    def decode(self, reg, centers, stride):
        """DFL expectation -> ltrb distances -> xyxy boxes."""
        probs = F.softmax(reg, axis=-1)
        n_bins = self.reg_max + 1

        def project(p):
            proj = torch.arange(n_bins, dtype=torch.float32,
                                device=p.device).to(p.dtype)
            return torch.einsum("bnkr,r->bnk", p, proj)

        dist = apply_op(project, [probs], name="dfl_project")  # [B, HW, 4]

        def mk(dv, cv):
            lt, rb = dv[..., :2], dv[..., 2:]
            return torch.cat([cv[None] - lt * stride,
                              cv[None] + rb * stride], dim=-1)

        return apply_op(mk, [dist, centers], name="dfl_decode")


def _giou(a, b):
    """GIoU between xyxy box arrays of one shape ``[..., 4]``."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = _clip(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = _clip(a[..., 2] - a[..., 0], 0.0) * \
        _clip(a[..., 3] - a[..., 1], 0.0)
    area_b = _clip(b[..., 2] - b[..., 0], 0.0) * \
        _clip(b[..., 3] - b[..., 1], 0.0)
    union = area_a + area_b - inter
    iou = inter / _clip(union, 1e-9)
    clt = torch.minimum(a[..., :2], b[..., :2])
    crb = torch.maximum(a[..., 2:], b[..., 2:])
    cwh = _clip(crb - clt, 0.0)
    chull = _clip(cwh[..., 0] * cwh[..., 1], 1e-9)
    return iou - (chull - union) / chull


class PPYOLOE(nn.Layer):
    """PP-YOLOE: CSPResNet + CSPPAN + the head.

    ``forward(images)`` -> per-level raw predictions;
    ``loss(preds, gt_boxes, gt_labels, gt_mask)`` -> the scalar training
    loss; ``predict(images, ...)`` -> ``(boxes [N, 4], scores [N], labels
    [N])`` as numpy, through :func:`..ops.nms`.
    """

    def __init__(self, num_classes: int = 80, width: float = 0.50,
                 depth: float = 0.33, reg_max: int = 16):
        super().__init__()
        self.backbone = CSPResNet(width=width, depth=depth)
        self.neck = CSPPAN(self.backbone.out_channels)
        self.head = PPYOLOEHead(self.neck.out_channels, num_classes,
                                reg_max=reg_max)
        self.num_classes = num_classes

    def forward(self, images):
        return self.head(self.neck(self.backbone(images)))

    def loss(self, preds, gt_boxes, gt_labels, gt_mask):
        """``gt_boxes`` ``[B, M, 4]`` xyxy, ``gt_labels`` ``[B, M]`` int,
        ``gt_mask`` ``[B, M]`` (1 a real box, 0 padding); each anchor is
        positive for the smallest gt box containing its center."""
        gt_boxes = ensure_tensor(gt_boxes)
        gt_labels = ensure_tensor(gt_labels)
        gt_mask = ensure_tensor(gt_mask)
        total = None
        for cls, reg, centers, stride in preds:
            boxes = self.head.decode(reg, centers, stride)
            lvl = apply_op(
                lambda c, r, bx, gb, gl, gm, _centers=centers._value,
                _stride=stride: _ppyoloe_level_loss(
                    c, r, bx, gb, gl, gm, _centers, _stride,
                    self.num_classes, self.head.reg_max),
                [cls, reg, boxes, gt_boxes, gt_labels, gt_mask],
                name="ppyoloe_loss")
            total = lvl if total is None else total + lvl
        return total

    def predict(self, images, score_thresh: float = 0.3,
                iou_thresh: float = 0.5, top_k: Optional[int] = 100):
        from ..ops import nms

        preds = self.forward(images)
        all_boxes, all_scores = [], []
        for cls, reg, centers, stride in preds:
            all_boxes.append(self.head.decode(reg, centers, stride))
            all_scores.append(F.sigmoid(cls))
        boxes = concat(all_boxes, axis=1)[0]          # [N, 4]
        scores = concat(all_scores, axis=1)[0]        # [N, C]
        best = scores.max(axis=-1)
        label = scores.argmax(axis=-1)
        keepable = np.asarray((best > score_thresh).numpy())
        idx = np.nonzero(keepable)[0]
        if idx.size == 0:
            return (np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        sel = torch.from_numpy(idx).to(boxes._value.device)
        b = Tensor._wrap(boxes._value[sel])
        s = Tensor._wrap(best._value[sel])
        kept = nms(b, iou_threshold=iou_thresh, scores=s, top_k=top_k)
        ki = np.asarray(kept.numpy())
        return (np.asarray(b.numpy())[ki], np.asarray(s.numpy())[ki],
                np.asarray(label.numpy())[idx][ki])


def _ppyoloe_level_loss(cls_logits, reg_logits, boxes, gt_boxes, gt_labels,
                        gt_mask, centers, stride, num_classes, reg_max):
    """One level's loss on torch values (run under ``apply_op``)."""
    B, N, C = cls_logits.shape
    cx = centers[None, None, :, 0]                       # [1, 1, N]
    cy = centers[None, None, :, 1]
    inside = ((cx >= gt_boxes[..., 0:1]) & (cx <= gt_boxes[..., 2:3])
              & (cy >= gt_boxes[..., 1:2]) & (cy <= gt_boxes[..., 3:4]))
    inside = inside & (gt_mask[..., None] > 0)           # [B, M, N]
    # each anchor takes the smallest-area gt containing it (the first of
    # equal ones, as jnp.argmin); anchors with none read 1e12 throughout
    area = ((gt_boxes[..., 2] - gt_boxes[..., 0])
            * (gt_boxes[..., 3] - gt_boxes[..., 1]))     # [B, M]
    big = torch.full((), 1e12, dtype=torch.float32, device=area.device)
    dt = torch.promote_types(area.dtype, torch.float32)
    cand = torch.where(inside, area[..., None].to(dt), big.to(dt))
    gt_idx = torch.argmin(cand, dim=1)                   # [B, N]
    pos = cand.amin(dim=1) < big

    tgt_box = torch.gather(gt_boxes, 1,
                           gt_idx[..., None].expand(B, N, 4))      # [B, N, 4]
    tgt_lab = torch.gather(gt_labels, 1, gt_idx)                   # [B, N]

    # classification: BCE against IoU-weighted one-hot positives
    giou = _giou(boxes, tgt_box)
    iou = (giou * 0.5 + 0.5).detach()
    onehot = (tgt_lab[..., None] == torch.arange(
        C, device=tgt_lab.device)).to(torch.float64)
    onehot = onehot * torch.where(
        pos, iou, torch.zeros((), dtype=iou.dtype, device=iou.device)
    )[..., None]
    p = torch.sigmoid(cls_logits)
    bce = -(onehot * torch.log(_clip(p, 1e-9))
            + (1 - onehot) * torch.log(_clip(1 - p, 1e-9)))
    n_pos = torch.clamp(pos.sum(), min=1)
    cls_loss = bce.sum() / n_pos

    zero = torch.zeros((), dtype=giou.dtype, device=giou.device)
    giou_loss = torch.where(pos, 1.0 - giou, zero).sum() / n_pos
    # DFL: ltrb distance targets in bins; li + 1 <= reg_max by the clip
    c0x, c0y = cx[0, 0], cy[0, 0]
    lt = torch.stack([(c0x - tgt_box[..., 0]) / stride,
                      (c0y - tgt_box[..., 1]) / stride,
                      (tgt_box[..., 2] - c0x) / stride,
                      (tgt_box[..., 3] - c0y) / stride], dim=-1)
    tgt = _clip(lt, 0.0, reg_max - 0.01)                # [B, N, 4]
    tl = torch.floor(tgt)
    wr = tgt - tl
    logp = torch.log_softmax(reg_logits, dim=-1)
    li = tl.to(torch.int64)
    dfl = -(torch.gather(logp, -1, li[..., None])[..., 0] * (1 - wr)
            + torch.gather(logp, -1, (li + 1)[..., None])[..., 0] * wr)
    dfl_loss = torch.where(pos[..., None], dfl, torch.zeros(
        (), dtype=dfl.dtype, device=dfl.device)).sum() \
        / torch.clamp(pos.sum() * 4, min=1)
    return cls_loss + 2.0 * giou_loss + 0.5 * dfl_loss


def ppyoloe_s(num_classes: int = 80, **kw) -> PPYOLOE:
    return PPYOLOE(num_classes, width=0.50, depth=0.33, **kw)


def ppyoloe_m(num_classes: int = 80, **kw) -> PPYOLOE:
    return PPYOLOE(num_classes, width=0.75, depth=0.67, **kw)


def ppyoloe_l(num_classes: int = 80, **kw) -> PPYOLOE:
    return PPYOLOE(num_classes, width=1.0, depth=1.0, **kw)
