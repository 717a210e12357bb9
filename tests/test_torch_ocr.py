"""The port's DBNet and CRNN against the JAX package's, on the CPU
(``paddle_tpu_torch/vision/models/ocr.py``), at small widths with the
JAX model's weights carried across (``set_state_dict``, strict);
PP-YOLOE is in ``tests/test_torch_detection_ocr.py``.

- DBNet (scale 0.5, FPN 32 channels, 64 x 64, B 2), eval: its three maps
  at f32 1e-5, ``db_loss`` at rtol 1e-5; ``postprocess`` gives the same
  boxes (and two known blobs two boxes).
- CRNN (10 classes, hidden 16, 32 x 48 crops, B 2), eval: log-probs at
  1e-5, the CTC loss at rtol 1e-5, its grads by largest magnitude at
  1e-4.
"""
import numpy as np

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import R, one_thread  # noqa: F401
from torch_zoo_common import (GRAD_TOL, TOL, by_max, model_grads, np_,
                              pair)

def _db(P):
    return P.vision.models.db_mobilenet_v3(scale=0.5, fpn_ch=32)


def test_dbnet_maps_loss_and_postprocess():
    jm, tm = pair(_db)
    x = R(2, 3, 64, 64, seed=5)
    rng = np.random.default_rng(6)
    gts = [(rng.random((2, 1, 64, 64)) > 0.7).astype("f4"),
           rng.random((2, 1, 64, 64)).astype("f4"),
           (rng.random((2, 1, 64, 64)) > 0.3).astype("f4")]
    res = {}
    for P, m in ((pt, jm), (paddle, tm)):
        m.eval()
        maps = m(P.to_tensor(x))
        loss = P.vision.models.db_loss(*maps, *(P.to_tensor(g) for g in gts))
        res[P.__name__] = ([np_(t) for t in maps], float(np_(loss)),
                           m.postprocess(maps[0], thresh=0.5))
    (jo, jl, jp), (to, tl, tp) = res["paddle_tpu"], res["paddle_tpu_torch"]
    for a, b in zip(jo, to):
        assert a.shape == b.shape == (2, 1, 64, 64)
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert len(tp) == len(jp) == 2
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b, a)
    # a map with two blobs: two boxes in both
    pm = np.zeros((1, 1, 12, 12), "f4")
    pm[0, 0, 1:4, 2:5] = 0.9
    pm[0, 0, 7:11, 6:8] = 0.8
    for P, m in ((pt, jm), (paddle, tm)):
        (boxes,) = m.postprocess(P.to_tensor(pm))
        np.testing.assert_array_equal(boxes, [[2, 1, 5, 4], [6, 7, 8, 11]])


def test_crnn_log_probs_ctc_and_grads():
    jm, tm = pair(lambda P: P.vision.models.crnn_ctc(10, hidden=16))
    x = R(2, 3, 32, 48, seed=7)
    labels = np.asarray([[1, 2, 3, 0], [4, 4, 5, 6]])
    lengths = np.asarray([3, 4])
    res = {}
    for P, m in ((pt, jm), (paddle, tm)):
        m.eval()
        xt = P.to_tensor(x, stop_gradient=False)
        lp = m(xt)
        loss = m.loss(lp, P.to_tensor(labels), P.to_tensor(lengths))
        loss.backward()
        res[P.__name__] = (np_(lp), float(np_(loss)), model_grads(m, xt))
    (jo, jl, jg), (to, tl, tg) = res["paddle_tpu"], res["paddle_tpu_torch"]
    assert to.shape == jo.shape == (12, 2, 10)
    np.testing.assert_allclose(to, jo, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert jg.keys() == tg.keys()
    for k in jg:
        by_max(tg[k], jg[k], GRAD_TOL, k)
