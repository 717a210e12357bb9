"""The conv and pooling functional cases, as the CPU twins and
``chip_smoke.py`` run them.

``CASES[name] = (fn, arrays)``: ``fn(P, *tensors)`` calls
``P.nn.functional`` of a Paddle namespace ``P`` (the port, or in the
tests the JAX package too) on tensors made from ``arrays``, numpy
arrays drawn from fixed seeds, and returns an output or a list of them.
The tests hold each case's outputs and the grads of its float inputs
against the JAX package's on the CPU (``tests/test_torch_nn_conv_pool.py``,
``tests/test_torch_nn_pool_masks.py``); ``chip_smoke.py`` holds them on
``cuda`` against the CPU. ``MASKS`` names the ``return_mask``,
unpooling and adaptive cases (the second test file's). Numpy only: it
runs where neither JAX nor the tests are.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CASES", "MASKS", "R", "ties"]


def R(*shape, seed=0):
    """Seeded standard-normal f32."""
    return np.random.default_rng(seed).standard_normal(shape).astype("f4")


def ties(seed=0, shape=(2, 3, 9, 9)):
    """A ReLU'd map: many equal zeros, small integers tying too."""
    rng = np.random.default_rng(seed)
    return np.maximum(rng.integers(-2, 3, shape), 0).astype("f4")


def _f(name, **kw):
    """``F.<name>(*tensors, **kw)``."""
    def call(P, *ts):
        return getattr(P.nn.functional, name)(*ts, **kw)
    return call


CASES = {}

# conv2d: every padding form (x [2, 4, 9, 8], w [6, 4, 3, 3], bias)
for _name, _kw in {
        "int": dict(padding=1),
        "pair": dict(padding=[1, 2]),
        "paddle_order": dict(padding=[1, 0, 2, 1]),
        "nested": dict(padding=[[0, 1], [2, 1]]),
        "valid": dict(padding="VALID", stride=2),
        "same_s2": dict(padding="SAME", stride=2),
        "same_s3_lower": dict(padding="same", stride=3),
        "same_dilated": dict(padding="SAME", dilation=2),
        "dilation": dict(padding=2, dilation=2),
        "stride_asym": dict(padding=[2, 0, 1, 1], stride=[2, 1])}.items():
    CASES[f"conv2d_{_name}"] = (_f("conv2d", **_kw), [
        R(2, 4, 9, 8), R(6, 4, 3, 3, seed=1), R(6, seed=2)])

CASES.update({
    "conv2d_depthwise": (lambda P, x, w: P.nn.functional.conv2d(
        x, w, None, 2, 1, 1, 6), [R(2, 6, 8, 8), R(6, 1, 3, 3, seed=1)]),
    "conv2d_groups2": (_f("conv2d", padding=1, groups=2),
                       [R(2, 6, 8, 8), R(8, 3, 3, 3, seed=2)]),
    "conv2d_nhwc_same_s2": (_f("conv2d", stride=2, padding="SAME",
                               data_format="NHWC"),
                            [R(2, 7, 6, 4, seed=3), R(5, 4, 3, 3, seed=5),
                             R(5, seed=4)]),
    "conv1d_same_s2": (_f("conv1d", stride=2, padding="SAME"),
                       [R(2, 3, 11), R(4, 3, 4, seed=1), R(4, seed=2)]),
    "conv1d_nlc_dilated": (_f("conv1d", padding=[2, 1], dilation=2,
                              data_format="NLC"),
                           [R(2, 9, 3), R(5, 3, 3, seed=1)]),
    "conv3d_strided_asym": (_f("conv3d", stride=[1, 2, 2],
                               padding=[1, 0, 1, 1, 0, 1]),
                            [R(1, 2, 5, 6, 6), R(3, 2, 3, 3, 3, seed=1),
                             R(3, seed=2)]),
    "conv3d_ndhwc_same_groups": (_f("conv3d", padding="SAME", groups=2,
                                    data_format="NDHWC"),
                                 [R(1, 4, 5, 5, 4),
                                  R(4, 2, 2, 3, 3, seed=1)]),
})

# conv2d_transpose (x [2, 4, 8, 7], w [4, 3, 3, 3], bias)
for _name, _kw in {
        "plain": dict(stride=2, padding=1),
        "output_padding": dict(stride=3, padding=1, output_padding=[1, 2]),
        "output_size": dict(stride=2, padding=1, output_size=[16, 15]),
        "groups": dict(stride=2, padding=0, groups=2),
        "dilation": dict(stride=1, padding=2, dilation=2),
        "same": dict(stride=2, padding="SAME"),
        "asym": dict(stride=2, padding=[1, 0, 0, 2])}.items():
    CASES[f"conv2d_transpose_{_name}"] = (
        _f("conv2d_transpose", **_kw),
        [R(2, 4, 8, 7), R(4, 3, 3, 3, seed=1),
         R(6 if _name == "groups" else 3, seed=2)])

CASES.update({
    "conv2d_transpose_nhwc_output_size": (
        _f("conv2d_transpose", stride=2, padding=1, output_size=[12, 12],
           data_format="NHWC"), [R(2, 6, 6, 3), R(3, 2, 3, 3, seed=1)]),
    "conv1d_transpose_output_padding": (
        _f("conv1d_transpose", stride=2, padding=1, output_padding=1),
        [R(2, 3, 7), R(3, 4, 3, seed=1), R(4, seed=2)]),
    "conv3d_transpose_groups": (
        _f("conv3d_transpose", stride=2, padding=[0, 1, 1], groups=2),
        [R(1, 4, 3, 4, 4), R(4, 1, 2, 3, 3, seed=1)]),
})

# pools (x [2, 3, 8, 7], or [2, 8, 7, 3] channels last)
for _name, (_fn, _kw) in {
        "max_k3s2p1": ("max_pool2d", dict(kernel_size=3, stride=2,
                                          padding=1)),
        "max_ceil": ("max_pool2d", dict(kernel_size=3, stride=2, padding=1,
                                        ceil_mode=True)),
        "max_ceil_window_in_pad": ("max_pool2d", dict(
            kernel_size=2, stride=3, padding=1, ceil_mode=True)),
        "max_asym": ("max_pool2d", dict(kernel_size=[3, 2], stride=[2, 1],
                                        padding=[0, 2, 1, 0])),
        "max_same": ("max_pool2d", dict(kernel_size=3, stride=2,
                                        padding="SAME")),
        "max_nhwc": ("max_pool2d", dict(kernel_size=2, padding=1,
                                        data_format="NHWC")),
        "avg_exclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                             padding=1)),
        "avg_inclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                             padding=1, exclusive=False)),
        "avg_ceil_exclusive": ("avg_pool2d", dict(
            kernel_size=2, stride=3, padding=1, ceil_mode=True)),
        "avg_ceil_inclusive": ("avg_pool2d", dict(
            kernel_size=2, stride=3, padding=1, ceil_mode=True,
            exclusive=False)),
        "avg_divisor": ("avg_pool2d", dict(kernel_size=3, padding=1,
                                           divisor_override=5)),
        "avg_same": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                        padding="SAME")),
        "avg_valid_nhwc": ("avg_pool2d", dict(kernel_size=2, padding="VALID",
                                              data_format="NHWC"))}.items():
    CASES[f"pool2d_{_name}"] = (_f(_fn, **_kw), [
        R(2, 8, 7, 3) if "nhwc" in _name else R(2, 3, 8, 7)])

CASES.update({
    "max_pool1d_ceil": (_f("max_pool1d", kernel_size=3, stride=2, padding=1,
                           ceil_mode=True), [R(2, 3, 10)]),
    "avg_pool1d_ceil": (_f("avg_pool1d", kernel_size=3, stride=2, padding=1,
                           ceil_mode=True), [R(2, 3, 10)]),
    "max_pool1d_nlc": (_f("max_pool1d", kernel_size=2, data_format="NLC"),
                       [R(2, 10, 3)]),
    "max_pool3d_asym": (_f("max_pool3d", kernel_size=2, stride=2,
                           padding=[1, 0, 0, 1, 1, 0]), [R(1, 2, 5, 4, 5)]),
    "avg_pool3d_ceil_inclusive": (_f("avg_pool3d", kernel_size=3, stride=2,
                                     padding=1, ceil_mode=True,
                                     exclusive=False), [R(1, 2, 5, 6, 5)]),
    # the max pool's gradient over ties: k 3, stride 2 windows overlap
    "max_pool2d_ties": (_f("max_pool2d", kernel_size=3, stride=2,
                           padding=1), [ties()]),
    "max_pool2d_ties_ceil": (_f("max_pool2d", kernel_size=3, stride=2,
                                padding=1, ceil_mode=True),
                             [ties(1)[..., :8]]),
})


def _round_trip(P, x):
    F = P.nn.functional
    out, mask = F.max_pool2d(x, 2, return_mask=True)
    back = F.max_unpool2d(out, mask, 2, output_size=[8, 7])
    out1, m1 = F.max_pool1d(x.reshape([2, 3, 56]), 4, return_mask=True)
    return [back, F.max_unpool1d(out1, m1, 4), m1]


def _unpool3d(P, x):
    F = P.nn.functional
    return F.max_unpool3d(*F.max_pool3d(x, 2, return_mask=True), 2)


MASK_CASES = {
    "return_mask_ceil_ties": (_f("max_pool2d", kernel_size=3, stride=2,
                                 padding=1, return_mask=True,
                                 ceil_mode=True), [ties(2)[..., :8]]),
    "unpool_round_trip": (_round_trip, [R(2, 3, 8, 7)]),
    "unpool3d": (_unpool3d, [R(1, 2, 4, 4, 4)]),
    "adaptive_max_mask": (_f("adaptive_max_pool2d", output_size=[2, 3],
                             return_mask=True), [R(2, 3, 5, 7)]),
    # ties: the adaptive max shares its gradient among them, per axis
    "adaptive_max_ties": (_f("adaptive_max_pool2d", output_size=[2, 3]),
                          [ties(3)[..., :5, :7]]),
    "adaptive_avg_nhwc": (_f("adaptive_avg_pool2d", output_size=[3, 4],
                             data_format="NHWC"), [R(2, 7, 10, 3)]),
    "adaptive_1d": (lambda P, x: [
        P.nn.functional.adaptive_avg_pool1d(x, 4),
        *P.nn.functional.adaptive_max_pool1d(x, 3, True)], [R(2, 3, 11)]),
    "adaptive_3d": (lambda P, x: [
        P.nn.functional.adaptive_avg_pool3d(x, [2, 1, 2]),
        P.nn.functional.adaptive_max_pool3d(x, [1, 2, 1])],
        [R(1, 2, 5, 7, 4)]),
}
for _fn in ("adaptive_avg_pool2d", "adaptive_max_pool2d"):
    for _size in (1, [2, 3], [5, 7]):
        _tag = "x".join(map(str, _size)) if isinstance(_size, list) \
            else str(_size)
        MASK_CASES[f"{_fn}_{_tag}"] = (_f(_fn, output_size=_size),
                                       [R(2, 3, 5, 7)])
CASES.update(MASK_CASES)
MASKS = frozenset(MASK_CASES)
