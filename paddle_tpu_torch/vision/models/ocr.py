"""PP-OCR (``paddle_tpu/vision/models/ocr.py``): the DBNet text detector
(``_DetBackbone``, ``_DBFPN``, ``DBHead``, ``db_loss``, the host-side
``postprocess``) and the CRNN recognizer trained with CTC.

Paddle ``Layer``s over the port's ``nn``, built as the JAX package builds
them, so weights carry across with ``set_state_dict``. DB's maps are
dense and its binarization elementwise; CRNN runs its bidirectional LSTM
through ``nn.LSTM`` and its loss through ``F.ctc_loss`` (blank 0), whose
time loop a CUDA graph captures once per width bucket. ``CRNN.loss``
builds its input lengths on the log-probs' device (the JAX package uses
``jnp.full``; a host-to-device copy cannot run inside a capture).
Polygon extraction stays on the host, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

import torch

from ... import nn
from ...autograd.engine import apply_op
from ...nn import functional as F
from ...ops._apply import ensure_tensor
from ...ops.manipulation import concat as paddle_concat
from ...tensor import Tensor

__all__ = ["DBNet", "DBHead", "CRNN", "db_mobilenet_v3", "crnn_ctc",
           "db_loss"]


class _ConvBNAct(nn.Layer):
    def __init__(self, cin, cout, k=3, stride=1, act=True):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=stride,
                              padding=(k - 1) // 2, bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class _DetBackbone(nn.Layer):
    """Compact MobileNetV3-style detector backbone → strides 4/8/16/32
    (ppocr backbones/det_mobilenet_v3.py, depthwise-separable blocks)."""

    def __init__(self, scale: float = 0.5):
        super().__init__()
        c = [int(16 * scale * m) for m in (1, 2, 4, 8, 12)]
        c = [max(8, v) for v in c]

        def dw_block(cin, cout, stride):
            return nn.Sequential(
                _ConvBNAct(cin, cin, 3, stride=stride),
                _ConvBNAct(cin, cout, 1))

        self.stem = _ConvBNAct(3, c[0], 3, stride=2)
        self.s4 = dw_block(c[0], c[1], 2)
        self.s8 = dw_block(c[1], c[2], 2)
        self.s16 = dw_block(c[2], c[3], 2)
        self.s32 = dw_block(c[3], c[4], 2)
        self.out_channels = c[1:]

    def forward(self, x):
        x = self.stem(x)
        f4 = self.s4(x)
        f8 = self.s8(f4)
        f16 = self.s16(f8)
        f32 = self.s32(f16)
        return [f4, f8, f16, f32]


class _DBFPN(nn.Layer):
    """DB-FPN: unify channels, top-down fusion, concat at stride 4
    (ppocr necks/db_fpn.py)."""

    def __init__(self, in_channels: Sequence[int], out_ch: int = 96):
        super().__init__()
        self.lateral = nn.LayerList(
            [nn.Conv2D(c, out_ch, 1, bias_attr=False) for c in in_channels])
        self.smooth = nn.LayerList(
            [nn.Conv2D(out_ch, out_ch // 4, 3, padding=1, bias_attr=False)
             for _ in in_channels])
        self.out_channels = out_ch

    def forward(self, feats):
        lat = [l(f) for l, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + F.interpolate(lat[i + 1], scale_factor=2,
                                            mode="nearest")
        outs = []
        for i, (s, f) in enumerate(zip(self.smooth, lat)):
            o = s(f)
            if i > 0:
                o = F.interpolate(o, scale_factor=2 ** i, mode="nearest")
            outs.append(o)
        return paddle_concat(outs, axis=1)  # [B, out_ch, H/4, W/4]


class DBHead(nn.Layer):
    """Differentiable Binarization head: probability map P, threshold map T,
    approximate binary map B = sigmoid(k·(P − T))
    (ppocr heads/det_db_head.py; paper: Liao et al., DB, AAAI 2020)."""

    def __init__(self, in_ch: int, k: float = 50.0):
        super().__init__()
        self.k = k

        def branch():
            return nn.Sequential(
                _ConvBNAct(in_ch, in_ch // 4, 3),
                nn.Conv2DTranspose(in_ch // 4, in_ch // 4, 2, stride=2),
                nn.BatchNorm2D(in_ch // 4), nn.ReLU(),
                nn.Conv2DTranspose(in_ch // 4, 1, 2, stride=2))

        self.prob = branch()
        self.thresh = branch()

    def forward(self, x):
        p = F.sigmoid(self.prob(x))
        t = F.sigmoid(self.thresh(x))
        k = self.k
        binary = apply_op(
            lambda pv, tv: 1.0 / (1.0 + torch.exp(-k * (pv - tv))),
            [p, t], name="db_binarize")
        return p, t, binary


class DBNet(nn.Layer):
    """DB text detector: backbone + DB-FPN + DB head. forward(images) →
    (prob_map, thresh_map, binary_map), each [B, 1, H, W]."""

    def __init__(self, scale: float = 0.5, fpn_ch: int = 96):
        super().__init__()
        self.backbone = _DetBackbone(scale)
        self.neck = _DBFPN(self.backbone.out_channels, fpn_ch)
        self.head = DBHead(fpn_ch)

    def forward(self, images):
        return self.head(self.neck(self.backbone(images)))

    def postprocess(self, prob_map, thresh: float = 0.3,
                    min_area: int = 4) -> List[np.ndarray]:
        """Host-side box extraction: connected components of the binarized
        probability map → axis-aligned boxes [x0, y0, x1, y1] per image
        (the reference's db_postprocess.py is CPU-side too)."""
        pm = np.asarray(ensure_tensor(prob_map).numpy())[:, 0]
        out = []
        for img in pm > thresh:
            boxes = []
            seen = np.zeros_like(img, bool)
            H, W = img.shape
            for y in range(H):
                for x in range(W):
                    if img[y, x] and not seen[y, x]:
                        stack = [(y, x)]
                        seen[y, x] = True
                        ys, xs = [], []
                        while stack:
                            cy, cx = stack.pop()
                            ys.append(cy)
                            xs.append(cx)
                            for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                                ny, nx = cy + dy, cx + dx
                                if (0 <= ny < H and 0 <= nx < W
                                        and img[ny, nx]
                                        and not seen[ny, nx]):
                                    seen[ny, nx] = True
                                    stack.append((ny, nx))
                        if len(ys) >= min_area:
                            boxes.append([min(xs), min(ys),
                                          max(xs) + 1, max(ys) + 1])
            out.append(np.asarray(boxes, np.float32).reshape(-1, 4))
        return out


def db_loss(prob, thresh, binary, gt_shrink, gt_thresh, gt_mask,
            alpha: float = 5.0, beta: float = 10.0):
    """DB training loss: BCE(prob) + dice(binary) + masked L1(thresh)
    (ppocr losses/det_db_loss.py, compact — no OHEM)."""
    def fn(p, t, b, gs, gt, gm):
        p, t, b = p[:, 0], t[:, 0], b[:, 0]
        eps = 1e-6
        bce = -(gs * torch.log(p + eps) + (1 - gs) * torch.log(1 - p + eps))
        bce = bce.mean()
        inter = (b * gs).sum()
        dice = 1 - 2 * inter / (b.sum() + gs.sum() + eps)
        l1 = (torch.abs(t - gt) * gm).sum() / (gm.sum() + eps)
        return alpha * bce + dice + beta * l1

    return apply_op(fn, [ensure_tensor(prob), ensure_tensor(thresh),
                         ensure_tensor(binary), ensure_tensor(gt_shrink),
                         ensure_tensor(gt_thresh), ensure_tensor(gt_mask)],
                    name="db_loss")


class CRNN(nn.Layer):
    """CRNN recognizer: conv feature extractor → squeeze height → BiLSTM →
    per-timestep vocabulary logits, trained with CTC
    (ppocr rec architectures: backbone + SequenceEncoder + CTCHead)."""

    def __init__(self, num_classes: int, in_channels: int = 3,
                 hidden: int = 96):
        super().__init__()
        self.convs = nn.Sequential(
            _ConvBNAct(in_channels, 32, 3), nn.MaxPool2D(2, 2),
            _ConvBNAct(32, 64, 3), nn.MaxPool2D(2, 2),
            _ConvBNAct(64, hidden, 3),
            nn.MaxPool2D(kernel_size=(2, 1), stride=(2, 1)),
        )
        self.rnn = nn.LSTM(hidden, hidden, direction="bidirect")
        self.fc = nn.Linear(2 * hidden, num_classes)
        self.num_classes = num_classes

    def forward(self, images):
        """images [B, C, H, W] → log-probs [T, B, num_classes] (CTC layout,
        T = W/4 timesteps)."""
        f = self.convs(images)              # [B, ch, H', W']
        f = f.mean(axis=2)                  # squeeze height → [B, ch, W']
        f = f.transpose([0, 2, 1])          # [B, T, ch]
        seq, _ = self.rnn(f)
        logits = self.fc(seq)               # [B, T, C]
        return F.log_softmax(logits, axis=-1).transpose([1, 0, 2])

    def loss(self, log_probs, labels, label_lengths):
        """CTC loss over the [T, B, C] log-probs (blank = 0)."""
        T, B = log_probs.shape[0], log_probs.shape[1]
        dev = ensure_tensor(log_probs)._value.device
        input_lengths = Tensor._wrap(torch.full((B,), T, dtype=torch.int32,
                                                device=dev))
        return F.ctc_loss(log_probs, labels, input_lengths,
                          ensure_tensor(label_lengths), blank=0)


def db_mobilenet_v3(scale: float = 0.5, **kw) -> DBNet:
    return DBNet(scale=scale, **kw)


def crnn_ctc(num_classes: int, **kw) -> CRNN:
    return CRNN(num_classes, **kw)
