"""The port's PP-YOLOE against the JAX package's, on the CPU
(``paddle_tpu_torch/vision/models/detection.py``), at a small width with
the JAX model's weights carried across (``set_state_dict``, strict).

- PP-YOLOE (``PPYOLOE(4, width=0.25)``, 64 x 64, B 2, 3 gt boxes an
  image), eval: every level's class and box logits and anchor centers at
  f32 1e-5; the loss (float64 in both) at rtol 1e-5; the input's grad and
  every parameter's grad within 1e-4 of each array's largest magnitude;
  under ``auto_cast`` O2 the loss is bf16 in both, at rtol 2e-2;
  ``predict``'s boxes and scores at 1e-5 and its labels exactly (the kept
  order by ``nms``); four AdamW steps in training, the losses at rtol
  1e-3 step by step (BatchNorm's batch statistics amplify the packages'
  summation-order differences, as in the ResNet twins).
- The bucketed PP-YOLOE step: boxes padded with mask-0 rows onto the
  ladder give the unpadded loss (rtol 1e-6), in both packages.

DBNet and CRNN are in ``tests/test_torch_ocr.py``.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import R, one_thread  # noqa: F401
from torch_zoo_common import (GRAD_TOL, TOL, by_max, model_grads, np_,
                              pair)

def _yolo_data(B=2, M=3, side=64, seed=1):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, side * 0.6, (B, M, 2))
    wh = rng.uniform(8, side * 0.4, (B, M, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype("f4")
    return (R(B, 3, side, side, seed=seed), boxes,
            rng.integers(0, 4, (B, M)), np.ones((B, M), "f4"))


def _yoloe(P):
    return P.vision.models.PPYOLOE(4, width=0.25, depth=0.33)


@pytest.fixture(scope="module")
def yoloe_pair():
    prev = paddle.get_device() if paddle.device._current is not None \
        else None
    paddle.set_device("cpu")  # before the autouse on_cpu of each test
    try:
        return pair(_yoloe)
    finally:
        paddle.set_device(prev)


def _yoloe_run(P, model, data):
    model.eval()
    x = P.to_tensor(data[0], stop_gradient=False)
    preds = model(x)
    loss = model.loss(preds, *(P.to_tensor(a) for a in data[1:]))
    loss.backward()
    out = [np_(t) for cls, reg, c, s in preds for t in (cls, reg, c)]
    g = model_grads(model, x)
    model.clear_gradients()
    return out, float(np_(loss)), str(loss.dtype), g


def test_ppyoloe_predictions_loss_and_grads(yoloe_pair):
    jm, tm = yoloe_pair
    data = _yolo_data()
    jo, jl, jdt, jg = _yoloe_run(pt, jm, data)
    to, tl, tdt, tg = _yoloe_run(paddle, tm, data)
    assert len(jo) == len(to) == 9
    for i, (a, b) in enumerate(zip(jo, to)):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                   err_msg=f"prediction {i}")
    assert "float64" in jdt and "float64" in tdt
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert jg.keys() == tg.keys() and len(tg) > 100
    for k in jg:
        by_max(tg[k], jg[k], GRAD_TOL, k)
    # under auto_cast O2 the level losses take bf16 logits and the sum of
    # the levels is bf16 in both (the facade add casts its f64 inputs)
    o2 = {}
    for P, m in ((pt, jm), (paddle, tm)):
        with P.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = m.loss(m(P.to_tensor(data[0])),
                          *(P.to_tensor(a) for a in data[1:]))
        o2[P.__name__] = (str(loss.dtype), float(np_(loss)))
    assert "bfloat16" in o2["paddle_tpu"][0] and \
        "bfloat16" in o2["paddle_tpu_torch"][0]
    np.testing.assert_allclose(o2["paddle_tpu_torch"][1],
                               o2["paddle_tpu"][1], rtol=2e-2)


def test_ppyoloe_predict(yoloe_pair):
    jm, tm = yoloe_pair
    x = R(1, 3, 64, 64, seed=2)
    jm.eval()
    tm.eval()
    jb, js, jlab = jm.predict(pt.to_tensor(x), score_thresh=0.3,
                              iou_thresh=0.5, top_k=20)
    tb, ts, tlab = tm.predict(paddle.to_tensor(x), score_thresh=0.3,
                              iou_thresh=0.5, top_k=20)
    assert 0 < len(tb) == len(jb) <= 20
    np.testing.assert_allclose(tb, jb, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts, js, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tlab, jlab)


def test_bucketed_ppyoloe_step_with_padded_boxes(yoloe_pair):
    """Mask-0 padding rows on the box axis change no anchor's target."""
    data = _yolo_data(seed=4)
    for P, m in zip((pt, paddle), yoloe_pair):
        m.eval()

        def loss_fn(imgs, boxes, labels, mask, m=m):
            return m.loss(m(imgs), boxes, labels, mask)

        args = [P.to_tensor(a) for a in data]
        plain = float(np_(loss_fn(*args)))
        step = P.jit.BucketedFunction(
            loss_fn, axes={1: {1: [8]}, 2: {1: [8]}, 3: {1: [8]}},
            pad_values={1: 0.0, 2: 0, 3: 0.0}, jit=False)
        np.testing.assert_allclose(float(np_(step(*args))), plain,
                                   rtol=1e-6)


def test_ppyoloe_adamw_steps_track(yoloe_pair):
    """Last: it trains the module's pair."""
    jm, tm = yoloe_pair
    data = _yolo_data(seed=3)
    losses = {}
    for P, m in ((pt, jm), (paddle, tm)):
        m.train()
        opt = P.optimizer.AdamW(learning_rate=1e-3,
                                parameters=m.parameters())
        args = [P.to_tensor(a) for a in data]
        out = []
        for _ in range(4):
            loss = m.loss(m(args[0]), *args[1:])
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(np_(loss)))
        losses[P.__name__] = out
    np.testing.assert_allclose(losses["paddle_tpu_torch"],
                               losses["paddle_tpu"], rtol=1e-3)
    assert losses["paddle_tpu_torch"][-1] < losses["paddle_tpu_torch"][0]
