"""Gradients exactly on the kinks, in both packages.

Each case puts inputs exactly on a bound, a zero or a tie (seeded numpy
elsewhere), runs ``y.sum().backward()`` in the JAX package and in the
port on the same f32 inputs, and holds the input gradients equal
(``assert_array_equal``: the values are halves, ones and zeros, so any
difference is a rule, not rounding; NaN and inf must sit at the same
places). The port's values of ``abs`` stay bit for bit ``torch.abs``'s.

- The clamp family (``clip``, ``clip_``, ``hardtanh``, ``hardsigmoid``,
  ``hardswish``, the bounds of ``binary_cross_entropy``, ``logit``'s
  ``eps``, ``margin_cross_entropy``'s cosine) passes half the gradient
  at a bound, as ``jnp.clip`` does; ``relu6`` none at 0 and 6, as
  ``jax.nn.relu6``.
- ``abs`` has gradient 1 at 0 (and at -0.0), -1 at NaN, as ``jnp.abs``;
  ``l1_loss``, ``binary_cross_entropy_with_logits`` and
  ``sigmoid_focal_loss`` follow. Kept by the port, as in the JAX
  package: at logit 0 the two logit losses are smooth, and their true
  derivative sigmoid(0) - y = 0.5 - y differs from both packages' by 0.5
  (pinned below).
- Fixed in the port: ``norm`` over an axis and ``renorm`` on a zero row
  give finite gradients (0, and 1.0 for ``renorm``) where the JAX
  package gives NaN (pinned below).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(21)


def _grad(P, fn, x, *consts):
    """The input gradient of ``fn(x, *consts).sum()`` in package ``P``."""
    xt = P.to_tensor(x, stop_gradient=False)
    cs = [P.to_tensor(c) for c in consts]
    fn(P, xt, *cs).sum().backward()
    return np.asarray(xt.grad.numpy())


def _both(fn, x, *consts):
    x = np.asarray(x, np.float32)
    return (_grad(pt, fn, x, *consts), _grad(paddle, fn, x, *consts))


def _mixed(*kinks):
    """The kinks, then three seeded values between them."""
    return np.concatenate([np.asarray(kinks, np.float32),
                           RNG.uniform(-0.9, 0.9, 3).astype(np.float32)])


def _clip_(P, x):
    y = x * 1.0
    P.clip_(y, 0.0, 1.0)
    return y


CASES = {
    "clip": (lambda P, x: P.clip(x, 0.0, 1.0), _mixed(0.0, 1.0, 2.0, -1.0)),
    "clip_tensor_bounds": (
        lambda P, x: P.clip(x, P.to_tensor(np.float32(-0.5)),
                            P.to_tensor(np.float32(0.5))),
        _mixed(-0.5, 0.5)),
    "clip_": (_clip_, _mixed(0.0, 1.0)),
    "hardtanh_0_1": (lambda P, x: P.nn.functional.hardtanh(x, 0.0, 1.0),
                     _mixed(0.0, 1.0)),
    "hardtanh": (lambda P, x: P.nn.functional.hardtanh(x),
                 _mixed(-1.0, 1.0)),
    "Hardtanh_layer": (lambda P, x: P.nn.Hardtanh()(x), _mixed(-1.0, 1.0)),
    "relu6": (lambda P, x: P.nn.functional.relu6(x),
              np.asarray([0.0, 6.0, 3.0, -1.0, 7.0], np.float32)),
    "ReLU6_layer": (lambda P, x: P.nn.ReLU6()(x),
                    np.asarray([0.0, 6.0, 2.5], np.float32)),
    "hardsigmoid": (lambda P, x: P.nn.functional.hardsigmoid(x, 0.25, 0.5),
                    _mixed(-2.0, 2.0, 0.0, -3.0, 3.0)),
    "hardswish": (lambda P, x: P.nn.functional.hardswish(x),
                  _mixed(-3.0, 3.0, 0.0)),
    "Hardswish_layer": (lambda P, x: P.nn.Hardswish()(x),
                        _mixed(-3.0, 3.0)),
    "abs": (lambda P, x: P.abs(x),
            np.asarray([0.0, -0.0, 2.0, -2.0, np.nan], np.float32)),
    "abs_method": (lambda P, x: x.abs(), _mixed(0.0, -0.0)),
    "logit_eps": (lambda P, x: P.logit(x, eps=0.25),
                  np.asarray([0.25, 0.75, 0.5, 0.1, 0.9], np.float32)),
    "bce_bounds": (
        lambda P, x, y: P.nn.functional.binary_cross_entropy(
            x, y, reduction="sum"),
        np.asarray([np.float32(1.0 - 1e-7), np.float32(1e-12), 0.5],
                   np.float32),
        np.asarray([1.0, 0.0, 1.0], np.float32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_at_the_kinks_equals_the_jax_packages(name):
    fn, x, *consts = CASES[name]
    want, got = _both(fn, x, *consts)
    np.testing.assert_array_equal(got, want)


def test_values_of_abs_stay_torchs_bit_for_bit():
    x = np.asarray([0.0, -0.0, np.nan, -np.nan, -np.inf, -3.5], np.float32)
    got = paddle.abs(paddle.to_tensor(x, stop_gradient=False)).numpy()
    want = torch.abs(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()
    assert paddle.abs(paddle.to_tensor(np.asarray([-3, 0, 2]))).numpy(
        ).tolist() == [3, 0, 2]


def test_clip_values_stay_clamps():
    """Values equal ``torch.clamp``'s (a NaN's sign bit may differ)."""
    x = RNG.standard_normal(64).astype(np.float32) * 3
    x[:4] = [0.0, 1.0, np.nan, -np.inf]
    got = paddle.clip(paddle.to_tensor(x), 0.0, 1.0).numpy()
    want = torch.clamp(torch.from_numpy(x), 0.0, 1.0).numpy()
    np.testing.assert_array_equal(got, want)  # NaN where clamp has it
    relu6 = paddle.nn.functional.relu6(paddle.to_tensor(x * 3)).numpy()
    np.testing.assert_array_equal(relu6, torch.clamp(
        torch.from_numpy(x * 3), 0.0, 6.0).numpy())


def test_l1_loss_at_a_zero_residual():
    x = RNG.standard_normal((2, 3)).astype(np.float32)
    y = x.copy()
    y[1] += 0.5
    want, got = _both(lambda P, a, b: P.nn.functional.l1_loss(
        a, b, reduction="sum"), x, y)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], 1.0)


@pytest.mark.parametrize("pos_weight", [False, True])
def test_logit_losses_at_logit_zero(pos_weight):
    """BCE with logits (with and without ``pos_weight``) and the focal
    loss at logit 0: equal to the JAX package's (the values ROADMAP
    Queue 3 item 2 observed there), and both 0.5 off the true
    derivative 0.5 - y without ``pos_weight`` (kept by the port)."""
    z = np.zeros(2, np.float32)
    y = np.asarray([0.0, 1.0], np.float32)
    pw = (np.asarray([2.0, 2.0], np.float32),) if pos_weight else ()

    def bce(P, a, b, *w):
        return P.nn.functional.binary_cross_entropy_with_logits(
            a, b, reduction="sum", pos_weight=w[0] if w else None)

    want, got = _both(bce, z, y, *pw)
    np.testing.assert_array_equal(got, want)
    if not pos_weight:
        np.testing.assert_array_equal(got, [0.0, -1.0])
        np.testing.assert_array_equal(got - (0.5 - y), [-0.5, -0.5])
    want, got = _both(lambda P, a, b: P.nn.functional.sigmoid_focal_loss(
        a, b, reduction="sum"), z, y)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, [0.13, -0.1058], atol=1e-4)


def test_margin_cross_entropy_at_the_cosine_bounds():
    """Target cosines exactly at 1 and -1: the same gradient (inf where
    arccos' is) in both. Past a bound (1.5) the clip passes none, and
    arccos' at the clipped 1 is -inf: the JAX package multiplies, 0 x
    -inf = NaN on that row; the port's ``maximum``/``minimum`` mask it,
    giving 0 (fixed in the port, pinned here)."""
    lv = RNG.uniform(-0.5, 0.5, (4, 5)).astype(np.float32)
    label = np.asarray([0, 1, 2, 3], np.int64)
    lv[0, 0], lv[1, 1], lv[2, 2] = 1.0, -1.0, 1.5

    def f(P, a, lab):
        return P.nn.functional.margin_cross_entropy(
            a, lab, margin2=0.5, scale=4.0, reduction="sum")

    want, got = _both(f, lv, label)
    rows = [0, 1, 3]
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-5, atol=1e-6)
    assert np.isinf(got[0, 0]) and np.isinf(got[1, 1])
    assert np.isnan(want[2, 2]) and got[2, 2] == 0.0
    others = [j for j in range(5) if j != 2]
    np.testing.assert_allclose(got[2, others], want[2, others], rtol=1e-5,
                               atol=1e-6)


def _zero_row():
    x = RNG.standard_normal((3, 4)).astype(np.float32)
    x[1] = 0.0
    return x


@pytest.mark.parametrize("which", ["norm", "linalg_norm"])
def test_norm_over_an_axis_on_a_zero_row_is_fixed_in_the_port(which):
    """Fixed in the port: 0 on the zero row, where the JAX package's
    ``jnp.linalg.norm`` gives NaN; the other rows agree."""
    def f(P, a):
        return (P.norm(a, axis=1) if which == "norm"
                else P.linalg.norm(a, axis=1))

    want, got = _both(f, _zero_row())
    assert np.isnan(want[1]).all()
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=1e-6)


def test_renorm_on_a_zero_row_is_fixed_in_the_port():
    """Fixed in the port: 1.0 on the zero row (its scale is 1), where
    the JAX package gives NaN; the clamped rows agree."""
    want, got = _both(lambda P, a: P.renorm(a, 2.0, 0, 1.0), _zero_row())
    assert np.isnan(want[1]).all()
    np.testing.assert_array_equal(got[1], 1.0)
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=1e-5,
                               atol=1e-6)
