"""The port's detection ops against the JAX package's, on the CPU
(``paddle_tpu_torch/vision/ops.py``, ``ops_extra.py``).

Every op runs in both packages on the same seeded numpy inputs; float
outputs are held at f32 atol = rtol = 1e-5, integer outputs (``nms``'s
kept indices, ``distribute_fpn_proposals``' restore index, the counts)
exactly. ``roi_align``, ``deform_conv2d`` and ``yolo_loss`` also hold
the float inputs' grads (under one seeded cotangent an output) at 1e-5;
an input the output does not depend on differentiably would get a zero
grad in the JAX package and none in torch: both count as zeros.
``yolo_loss`` is float64 in both, as the JAX package's targets are.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import R, one_thread  # noqa: F401

TOL = 1e-5


def _np(x):
    return np.asarray(x.numpy())


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def grads_of(fn, *arrays, seed=7):
    """A case: ``fn(P, *tensors)``'s outputs, then every float input's
    grad (zeros where it got none) under a seeded cotangent on each float
    output."""
    def case(P):
        ts = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f")
              for a in arrays]
        out = fn(P, *ts)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        rng = np.random.default_rng(seed)
        loss = None
        for o in outs:
            if o.stop_gradient:
                continue
            term = (o * P.to_tensor(rng.standard_normal(o.shape)
                                    .astype("f4"))).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        return outs + [P.zeros(t.shape, t.dtype) if t.grad is None
                       else t.grad for t in ts if not t.stop_gradient]
    return case


def both(case, tol=TOL):
    """``case(P)`` in both packages: every output equal in shape and dtype
    kind and within ``tol`` (exact for integers)."""
    jo = [_np(o) for o in _flat(case(pt))]
    to = [_np(o) for o in _flat(case(paddle))]
    assert len(jo) == len(to)
    for i, (a, b) in enumerate(zip(jo, to)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        assert a.dtype == b.dtype, (i, a.dtype, b.dtype)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=f"output {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       err_msg=f"output {i}")
    return to


def _boxes(n, size=32.0, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(2, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype("f4")


def test_box_area_and_iou():
    a, b = _boxes(6), _boxes(4, seed=1)
    both(lambda P: P.vision.ops.box_area(P.to_tensor(a)))
    both(lambda P: P.vision.ops.box_iou(P.to_tensor(a), P.to_tensor(b)))


@pytest.mark.parametrize("kind", ["scores", "index_order", "categories",
                                  "top_k", "ties"])
def test_nms(kind):
    boxes = _boxes(40, seed=2)
    rng = np.random.default_rng(3)
    scores = rng.random(40).astype("f4")
    if kind == "ties":  # equal scores keep the lower index first
        scores = np.round(scores * 4).astype("f4") / 4
    cats = rng.integers(0, 3, 40)

    def case(P):
        kw = {}
        if kind != "index_order":
            kw["scores"] = P.to_tensor(scores)
        if kind == "categories":
            kw.update(category_idxs=P.to_tensor(cats), categories=[0, 1, 2])
        if kind == "top_k":
            kw["top_k"] = 5
        return P.vision.ops.nms(P.to_tensor(boxes), 0.3, **kw)

    out = both(case)[0]
    assert out.dtype == np.int64 and 0 < len(out) < 40


@pytest.mark.parametrize("aligned,ratio", [(True, -1), (False, 2)])
def test_roi_align_and_grads(aligned, ratio):
    feat = R(2, 3, 8, 8)
    boxes = np.asarray([[1, 1, 5, 5], [0.5, 2, 7, 6.5], [2, 2, 4, 7]], "f4")
    num = np.asarray([2, 1], "int32")
    both(grads_of(lambda P, x, b, n: P.vision.ops.roi_align(
        x, b, n, (2, 3), spatial_scale=0.9, sampling_ratio=ratio,
        aligned=aligned), feat, boxes, num))
    both(grads_of(lambda P, x, b, n: P.vision.ops.RoIAlign(2, 1.0)(x, b, n),
                  feat, boxes, num))


def test_roi_pool():
    feat = R(2, 3, 8, 8)
    boxes = np.asarray([[1, 1, 5, 5], [0.5, 2, 7, 6.5], [2, 2, 4, 7]], "f4")
    num = np.asarray([1, 2], "int32")
    both(lambda P: P.vision.ops.roi_pool(
        P.to_tensor(feat), P.to_tensor(boxes), P.to_tensor(num), 2,
        spatial_scale=0.5))
    both(lambda P: P.vision.ops.RoIPool(3)(
        P.to_tensor(feat), P.to_tensor(boxes), P.to_tensor(num)))


def test_box_coder():
    prior = _boxes(5, seed=4)
    target = _boxes(3, seed=5)
    var = np.full((5, 4), 0.2, "f4")
    T = lambda P, *a: [P.to_tensor(x) for x in a]  # noqa: E731
    both(lambda P: P.vision.ops.box_coder(*T(P, prior, var, target)))
    both(lambda P: P.vision.ops.box_coder(
        *T(P, prior), None, *T(P, target), box_normalized=False))
    for axis, d, v in ((0, R(3, 5, 4, seed=6) * 0.1, var),
                       (1, R(5, 3, 4, seed=6) * 0.1,
                        np.full((3, 4), 0.2, "f4"))):
        both(lambda P: P.vision.ops.box_coder(
            *T(P, prior, v, d), code_type="decode_center_size", axis=axis))


@pytest.mark.parametrize("iou_aware", [False, True])
def test_yolo_box(iou_aware):
    na, cls = 2, 3
    x = R(2, na * (5 + cls) + (na if iou_aware else 0), 4, 4)
    img = np.asarray([[64, 48], [40, 64]], "int32")
    both(lambda P: P.vision.ops.yolo_box(
        P.to_tensor(x), P.to_tensor(img), [10, 13, 16, 30], cls,
        conf_thresh=0.4, downsample_ratio=16, scale_x_y=1.1,
        iou_aware=iou_aware, iou_aware_factor=0.4))


@pytest.mark.parametrize("variant", ["v1", "v2_groups"])
def test_deform_conv2d_and_grads(variant):
    rng = np.random.default_rng(7)
    if variant == "v1":
        x, w = R(2, 4, 7, 7), R(3, 4, 3, 3, seed=1)
        kw = dict(stride=1, padding=1)
        dg, oh = 1, 7
    else:
        x, w = R(1, 4, 8, 8), R(4, 2, 3, 3, seed=1)
        kw = dict(stride=2, padding=1, dilation=1, groups=2,
                  deformable_groups=2)
        dg, oh = 2, 4
    off = (rng.standard_normal((x.shape[0], dg * 18, oh, oh)) * 1.5
           ).astype("f4")
    if variant == "v1":
        both(grads_of(lambda P, a, o, ww: P.vision.ops.deform_conv2d(
            a, o, ww, **kw), x, off, w))
    else:
        mask = rng.random((1, dg * 9, oh, oh)).astype("f4")
        bias = R(4, seed=2)
        both(grads_of(lambda P, a, o, ww, m, b: P.vision.ops.deform_conv2d(
            a, o, ww, mask=m, bias=b, **kw), x, off, w, mask, bias))


def test_deform_conv2d_layer():
    x = R(1, 2, 6, 6)
    off = (R(1, 18, 6, 6, seed=3) * 0.7)
    jl = pt.vision.ops.DeformConv2D(2, 3, 3, padding=1)
    tl = paddle.vision.ops.DeformConv2D(2, 3, 3, padding=1)
    state = {k: _np(v) for k, v in jl.state_dict().items()}
    assert {k: v.shape for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in tl.state_dict().items()}
    tl.set_state_dict(state)
    np.testing.assert_allclose(
        _np(tl(paddle.to_tensor(x), paddle.to_tensor(off))),
        _np(jl(pt.to_tensor(x), pt.to_tensor(off))), rtol=TOL, atol=TOL)


def _yolo_gt(B=2, M=4, seed=8):
    rng = np.random.default_rng(seed)
    gt = np.zeros((B, M, 4), "f4")
    gt[:, :3, :2] = rng.uniform(0.1, 0.9, (B, 3, 2))
    gt[:, :3, 2:] = rng.uniform(0.05, 0.5, (B, 3, 2))
    return gt, rng.integers(0, 4, (B, M)), rng.random((B, M)).astype("f4")


@pytest.mark.parametrize("score,smooth", [(False, True), (True, False)])
def test_yolo_loss_and_grads(score, smooth):
    x = R(2, 3 * (5 + 4), 5, 5) * 0.5
    gt, lab, sc = _yolo_gt()
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]

    def fn(P, xx, g, lb, *s):
        return P.vision.ops.yolo_loss(
            xx, g, lb, anchors, [3, 4, 5], 4, 0.5, 8,
            gt_score=s[0] if s else None, use_label_smooth=smooth,
            scale_x_y=1.05)

    arrays = (x, gt, lab) + ((sc,) if score else ())
    out = both(grads_of(fn, *arrays, seed=9))
    assert out[0].dtype == np.float64


def test_prior_box():
    feat, img = R(1, 4, 3, 5), R(1, 3, 30, 50)
    for order in (False, True):
        both(lambda P: P.vision.ops.prior_box(
            P.to_tensor(feat), P.to_tensor(img), [4.0, 8.0], [9.0, 16.0],
            aspect_ratios=(1.0, 2.0), flip=True, clip=True,
            min_max_aspect_ratios_order=order))


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms(gaussian):
    rng = np.random.default_rng(10)
    xy = rng.uniform(0, 0.7, (2, 12, 2))
    bb = np.concatenate([xy, xy + rng.uniform(0.05, 0.4, (2, 12, 2))],
                        -1).astype("f4")
    sc = rng.random((2, 3, 12)).astype("f4")
    both(lambda P: P.vision.ops.matrix_nms(
        P.to_tensor(bb), P.to_tensor(sc), 0.2, 0.1, 8, 10,
        use_gaussian=gaussian, return_index=True))


def test_psroi_pool():
    x = R(1, 2 * 4, 6, 6)
    boxes = np.asarray([[0.5, 0.5, 5, 4], [1, 2, 5.5, 5.5]], "f4")
    num = np.asarray([2], "int32")
    both(lambda P: P.vision.ops.psroi_pool(
        P.to_tensor(x), P.to_tensor(boxes), P.to_tensor(num), 2,
        spatial_scale=0.9))
    both(lambda P: P.vision.ops.PSRoIPool(2)(
        P.to_tensor(x), P.to_tensor(boxes), P.to_tensor(num)))


def test_distribute_fpn_proposals():
    rois = np.concatenate([_boxes(5, 200.0, seed=13),
                           _boxes(4, 60.0, seed=14)])
    num = np.asarray([5, 4], "int32")
    both(lambda P: P.vision.ops.distribute_fpn_proposals(
        P.to_tensor(rois), 2, 5, 4, 56, rois_num=P.to_tensor(num)))
    both(lambda P: P.vision.ops.distribute_fpn_proposals(
        P.to_tensor(rois), 2, 5, 4, 56, pixel_offset=True))


def test_generate_proposals():
    rng = np.random.default_rng(15)
    A, H, W = 3, 4, 5
    scores = rng.random((2, A, H, W)).astype("f4")
    deltas = (rng.standard_normal((2, 4 * A, H, W)) * 0.3).astype("f4")
    img = np.asarray([[40, 50], [36, 44]], "f4")
    anchors = np.concatenate([_boxes(A, 16.0, seed=16)])
    var = np.full((A, 4), 0.5, "f4")
    both(lambda P: P.vision.ops.generate_proposals(
        P.to_tensor(scores), P.to_tensor(deltas), P.to_tensor(img),
        P.to_tensor(anchors), P.to_tensor(var), pre_nms_top_n=40,
        post_nms_top_n=12, nms_thresh=0.5, min_size=1.0,
        return_rois_num=True))


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(17)
    path = tmp_path / "img.jpg"
    Image.fromarray(rng.integers(0, 255, (12, 10, 3)).astype("uint8")).save(
        path, quality=90)
    for mode in ("unchanged", "gray", "rgb"):
        both(lambda P: P.vision.ops.decode_jpeg(
            P.vision.ops.read_file(str(path)), mode=mode))


def test_decode_jpeg_without_pillow(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow"):
        paddle.vision.ops.decode_jpeg(np.zeros(4, "uint8"))
