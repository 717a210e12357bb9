"""paddle.metric — training-loop metrics (``paddle_tpu/metric``).

Reference parity: python/paddle/metric/metrics.py — ``Metric`` ABC (:33,
reset/update/accumulate/name/compute), ``Accuracy`` (:187, device-side
``compute`` producing a correct-matrix + host-side ``update``), ``Precision``
(:338), ``Recall`` (:468), ``Auc`` (:601, threshold-bucket statistics).

``compute`` runs on the prediction's device (torch ops, no host read);
``update`` / ``accumulate`` keep python/numpy state on the host exactly
like the reference — a metric reads the device only in ``update``.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

from ..ops._apply import ensure_tensor
from ..tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _to_np(x) -> np.ndarray:
    if isinstance(x, Tensor):
        return np.asarray(x.numpy())
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x.detach()).numpy()
    return np.asarray(x)


class Metric(metaclass=abc.ABCMeta):
    """reference: metrics.py:33."""

    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        raise NotImplementedError(
            f"function 'reset' not implemented in {self.__class__.__name__}")

    @abc.abstractmethod
    def update(self, *args):
        raise NotImplementedError(
            f"function 'update' not implemented in {self.__class__.__name__}")

    @abc.abstractmethod
    def accumulate(self):
        raise NotImplementedError(
            f"function 'accumulate' not implemented in "
            f"{self.__class__.__name__}")

    @abc.abstractmethod
    def name(self):
        raise NotImplementedError(
            f"function 'name' not implemented in {self.__class__.__name__}")

    def compute(self, *args):
        """Device-side preprocessing of (pred, label) — default identity."""
        return args


class Accuracy(Metric):
    """reference: metrics.py:187 — top-k accuracy.

    Examples:
        >>> m = paddle.metric.Accuracy()
        >>> logits = paddle.to_tensor([[0.1, 0.9], [0.8, 0.2]])
        >>> labels = paddle.to_tensor([[1], [1]])
        >>> _ = m.update(m.compute(logits, labels))
        >>> float(m.accumulate())
        0.5
    """

    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._init_name(name)
        self.reset()

    def compute(self, pred, label, *args):
        """[N, C] pred + [N] or [N, 1] (or one-hot) label → bool correct
        matrix [N, maxk], on the prediction's device (no host read)."""
        pv = ensure_tensor(pred)._value.detach()
        lv = ensure_tensor(label)._value.detach().to(pv.device)
        idx = torch.topk(pv, self.maxk, dim=-1).indices
        if lv.dim() == 1:
            lv = lv.reshape(-1, 1)
        elif lv.shape[-1] != 1:
            lv = lv.argmax(dim=-1).reshape(-1, 1)  # one-hot → index
        return Tensor._wrap(idx == lv.to(idx.dtype))

    def update(self, correct, *args):
        correct = _to_np(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num_corrects = correct[:, :k].any(axis=-1).sum()
            num_samples = correct.shape[0]
            accs.append(float(num_corrects) / max(num_samples, 1))
            self.total[i] += float(num_corrects)
            self.count[i] += num_samples
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def _init_name(self, name):
        name = name or "acc"
        if self.maxk != 1:
            self._name = [f"{name}_top{k}" for k in self.topk]
        else:
            self._name = [name]

    def name(self):
        return self._name


class Precision(Metric):
    """reference: metrics.py:338 — binary precision tp/(tp+fp)."""

    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels)
        pred_pos = np.rint(preds).astype(bool).reshape(-1)
        actual = labels.astype(bool).reshape(-1)
        self.tp += int(np.sum(pred_pos & actual))
        self.fp += int(np.sum(pred_pos & ~actual))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """reference: metrics.py:468 — binary recall tp/(tp+fn)."""

    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels)
        pred_pos = np.rint(preds).astype(bool).reshape(-1)
        actual = labels.astype(bool).reshape(-1)
        self.tp += int(np.sum(pred_pos & actual))
        self.fn += int(np.sum(~pred_pos & actual))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """reference: metrics.py:601 — ROC AUC via threshold-bucket stats.
    ``preds`` [N, 2]: probability of each sample being positive in column 1."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        super().__init__()
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels).reshape(-1)
        if preds.ndim == 2:
            pos_prob = preds[:, -1]
        else:
            pos_prob = preds.reshape(-1)
        bins = np.clip(
            (pos_prob * self._num_thresholds).astype(np.int64),
            0, self._num_thresholds)
        np.add.at(self._stat_pos, bins[labels.astype(bool)], 1)
        np.add.at(self._stat_neg, bins[~labels.astype(bool)], 1)

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self._num_thresholds + 1, np.int64)

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            prev_pos, prev_neg = tot_pos, tot_neg
            tot_pos += float(self._stat_pos[i])
            tot_neg += float(self._stat_neg[i])
            auc += self.trapezoid_area(prev_neg, tot_neg, prev_pos, tot_pos)
        denom = tot_pos * tot_neg
        return auc / denom if denom > 0 else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k: int = 1, correct=None, total=None, name=None):
    """Functional top-k accuracy (reference: python/paddle/metric/metrics.py
    accuracy): fraction of rows whose label is among the top-k logits, a
    [1] f32 Tensor on the input's device."""
    xv = ensure_tensor(input)._value.detach()
    yv = ensure_tensor(label)._value.detach().to(xv.device)
    idx = torch.topk(xv, k, dim=-1).indices
    hit = (idx == yv.reshape(-1, 1).to(idx.dtype)).any(dim=1)
    return Tensor._wrap(hit.float().mean().reshape(1))


__all__.append("accuracy")
