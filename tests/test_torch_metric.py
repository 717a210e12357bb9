"""``paddle_tpu_torch.metric`` against ``paddle_tpu.metric``, on the CPU.

Every metric takes the same seeded predictions and labels in both
packages, batch by batch: ``Accuracy`` (top-1, top-(1, 3), one-hot and
column labels, a custom name), ``Precision``, ``Recall``, ``Auc`` (ROC
over 4095 thresholds, two-column and one-column predictions) and the
functional ``accuracy``. ``compute``'s correct matrices must be equal,
and each ``update`` and ``accumulate`` equal to 1e-12 (both accumulate
the same integers in Python floats; only the division order could
differ).
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.metric as jmetric
import paddle_tpu_torch as paddle
import paddle_tpu_torch.metric as tmetric
from torch_facade_common import on_cpu  # noqa: F401 (autouse)

TOL = 1e-12


def _batches(n=4, B=16, C=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, C)).astype("float32"),
             rng.integers(0, C, (B,)).astype("int64")) for _ in range(n)]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=TOL, atol=TOL)


def _accuracy_run(metric_mod, P, label_form, **kw):
    m = metric_mod.Accuracy(**kw)
    outs = []
    for x, y in _batches():
        if label_form == "column":
            y = y.reshape(-1, 1)
        elif label_form == "onehot":
            y = np.eye(6, dtype="float32")[y]
        correct = m.compute(P.to_tensor(x), P.to_tensor(y))
        c = np.asarray(correct.numpy())
        outs.append((c.tolist(), m.update(correct)))
    return outs, m.accumulate(), m.name()


@pytest.mark.parametrize("label_form", ["flat", "column", "onehot"])
@pytest.mark.parametrize("kw", [{}, {"topk": (1, 3), "name": "top"}],
                         ids=["top1", "top1_3"])
def test_accuracy_matches(label_form, kw):
    want = _accuracy_run(jmetric, pt, label_form, **kw)
    got = _accuracy_run(tmetric, paddle, label_form, **kw)
    assert [c for c, _ in got[0]] == [c for c, _ in want[0]]
    for (_, a), (_, b) in zip(got[0], want[0]):
        _close(a, b)
    _close(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_match(cls):
    rng = np.random.default_rng(3)
    ms = [getattr(mod, cls)() for mod in (jmetric, tmetric)]
    for _ in range(5):
        preds = rng.random((20, 1)).astype("float32")
        labels = rng.integers(0, 2, (20, 1)).astype("int64")
        for m, P in zip(ms, (pt, paddle)):
            m.update(P.to_tensor(preds), P.to_tensor(labels))
    _close(ms[1].accumulate(), ms[0].accumulate())
    assert ms[1].name() == ms[0].name()
    for m in ms:
        m.reset()
    assert ms[1].accumulate() == ms[0].accumulate() == 0.0


@pytest.mark.parametrize("cols", [2, 1])
def test_auc_matches(cols):
    rng = np.random.default_rng(4)
    ms = [mod.Auc() for mod in (jmetric, tmetric)]
    for _ in range(4):
        p = rng.random((32,)).astype("float32")
        preds = np.stack([1 - p, p], 1) if cols == 2 else p[:, None]
        labels = (rng.random(32) < p).astype("int64")
        for m, P in zip(ms, (pt, paddle)):
            m.update(P.to_tensor(preds), P.to_tensor(labels))
    assert 0.5 < ms[1].accumulate()
    _close(ms[1].accumulate(), ms[0].accumulate())
    np.testing.assert_array_equal(ms[1]._stat_pos, ms[0]._stat_pos)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_functional_accuracy_matches(k):
    for x, y in _batches(2):
        a = pt.metric.accuracy(pt.to_tensor(x), pt.to_tensor(y), k=k)
        b = paddle.metric.accuracy(paddle.to_tensor(x), paddle.to_tensor(y),
                                   k=k)
        assert b.shape == a.shape == [1]
        _close(b.numpy(), a.numpy())
        assert str(b._value.dtype) == "torch.float32"
