"""Helpers of the PP-YOLOE and PP-OCR twins
(``tests/test_torch_detection_ocr.py``, ``tests/test_torch_ocr.py``)."""
import numpy as np

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_nn_common import state_of

TOL = 1e-5
GRAD_TOL = 1e-4


def np_(x):
    return np.asarray(x.numpy())


def pair(make):
    """``make(P)`` in both packages, the port's carrying the JAX model's
    weights (strict)."""
    pt.seed(0)
    jm = make(pt)
    tm = make(paddle)
    missing, unexpected = tm.set_state_dict(state_of(jm))
    assert not missing and not unexpected
    return jm, tm


def by_max(b, a, tol, what):
    """``b``'s largest difference from ``a`` within ``tol`` of ``a``'s
    largest magnitude."""
    diff, scale = np.abs(b - a).max(), np.abs(a).max()
    assert diff <= tol * scale, (what, diff, scale)


def model_grads(model, x):
    """Every parameter's grad and the input ``x``'s, as numpy."""
    g = {n: np_(p.grad) for n, p in model.named_parameters()
         if p.grad is not None}
    g["input"] = np_(x.grad)
    return g
