"""The port's conv and pooling functionals against the JAX package's, on
the CPU (``paddle_tpu_torch/nn/functional/{conv,pooling}.py``).

Each case of ``paddle_tpu_torch/tools/vision_cases.py`` (the ones
``chip_smoke.py`` also runs on the card) runs one call in both packages
on the same seeded numpy inputs, and the output and the grads of the
float inputs (under a seeded cotangent) are held equal at f32 atol =
rtol = 1e-5 (``TOL``), dtypes by name:

- convolutions: every padding form (an int, ``n`` values, ``2n`` values
  in Paddle's order, ``[[lo, hi], ...]`` with and without the batch and
  channel pairs, ``"VALID"``, ``"SAME"`` at stride 2 and with dilation),
  asymmetric pads, dilation, depthwise ``groups``, NHWC/NLC/NDHWC, 1-D
  and 3-D, a bias;
- transposes: ``output_padding``, ``output_size`` (and its range check),
  ``groups``, dilation, ``"SAME"``, asymmetric pads, NHWC;
- pools: ``ceil_mode`` with and without ``exclusive`` (a last window
  that starts in the padding), ``divisor_override``, string padding,
  channels last, 1-D and 3-D; the max pool's gradient over tied values
  (ReLU-like zeros, k 3 stride 2: overlapping windows);
- under ``auto_cast`` O2: the ops' bf16 dtypes;
- ``padding_mode="reflect"`` on a ``Conv2D`` changes nothing in either
  package: both pad with zeros (ROADMAP Queue 3).

``return_mask``, ``max_unpool`` and the adaptive pools are in
``tests/test_torch_nn_pool_masks.py``.

The reference reads ``[[lo, hi]] * 4`` at n = 2 as four flat values and
raises; the port takes it, and equals the reference's ``[[lo, hi]] * 2``
form (ROADMAP Queue 3).
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.tools.vision_cases import CASES, MASKS, R
from torch_facade_common import both, on_cpu  # noqa: F401
from torch_nn_common import grads_of, one_thread, state_of  # noqa: F401

TOL = 1e-5


@pytest.mark.parametrize("name", sorted(set(CASES) - MASKS))
def test_case(name):
    fn, arrays = CASES[name]
    both(grads_of(fn, *arrays), TOL)


def test_max_pool_gradient_over_ties_goes_to_one_element():
    """Each window's gradient goes to its first maximum (row-major) and
    overlapping windows add: the reference's VJP of ``reduce_window``
    max, not a share among the tied values. Under the sum of the outputs
    every grad is a whole count of windows, and they add up to the
    windows' number."""
    x = CASES["max_pool2d_ties"][1][0]

    def case(P):
        t = P.to_tensor(x, stop_gradient=False)
        out = P.nn.functional.max_pool2d(t, 3, 2, 1)
        out.sum().backward()
        return out, t.grad
    got = both(case, TOL)
    g = got[1][2]
    np.testing.assert_array_equal(g, np.round(g))
    assert g.sum() == got[0][2].size and g.max() > 1


def test_conv2d_nested_with_batch_and_channel_pairs():
    """The port takes ``[[0, 0], [0, 0], [lo, hi], [lo, hi]]``; it equals
    the reference's ``[[lo, hi], [lo, hi]]``, which is all the reference
    takes at n = 2."""
    x, w = R(2, 3, 7, 7), R(4, 3, 3, 3, seed=1)
    F = pt.nn.functional
    want = F.conv2d(pt.to_tensor(x), pt.to_tensor(w),
                    padding=[[1, 2], [0, 1]]).numpy()
    with pytest.raises(TypeError):
        F.conv2d(pt.to_tensor(x), pt.to_tensor(w),
                 padding=[[0, 0], [0, 0], [1, 2], [0, 1]])
    got = paddle.nn.functional.conv2d(
        paddle.to_tensor(x), paddle.to_tensor(w),
        padding=[[0, 0], [0, 0], [1, 2], [0, 1]]).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_conv_transpose_output_size_out_of_range_raises():
    for P in (pt, paddle):
        with pytest.raises(ValueError):
            P.nn.functional.conv2d_transpose(
                P.to_tensor(R(1, 2, 4, 4)), P.to_tensor(R(2, 2, 3, 3)),
                stride=2, padding=1, output_size=[12, 12])


def test_padding_mode_is_ignored_in_both():
    """``Conv2D(padding_mode="reflect")`` stores the mode and pads with
    zeros, in the reference and in the port."""
    x = R(2, 4, 6, 6)

    def case(P):
        pt.seed(0)
        conv = P.nn.Conv2D(4, 3, 3, padding=1, padding_mode="reflect")
        if P is pt:
            case.w = state_of(conv)
        else:
            conv.set_state_dict(case.w)
        xt = P.to_tensor(x)
        zeros = P.nn.functional.conv2d(xt, conv.weight, conv.bias,
                                       padding=1)
        return conv(xt), zeros, conv._padding_mode
    got = both(case, TOL)
    np.testing.assert_array_equal(got[0][2], got[1][2])
    assert got[2] == "reflect"


def test_o2_dtypes():
    """Under ``auto_cast`` O2 every conv and pool runs in bf16, as the
    reference's ops do (none is on the black list)."""
    x, w = R(2, 4, 8, 8), R(4, 4, 3, 3, seed=1)

    def case(P):
        F = P.nn.functional
        with P.amp.auto_cast(level="O2", dtype="bfloat16"):
            y = F.conv2d(P.to_tensor(x), P.to_tensor(w), padding=1)
            return [y, F.max_pool2d(y, 3, 2, 1),
                    F.avg_pool2d(y, 2), F.adaptive_avg_pool2d(y, 1),
                    F.conv2d_transpose(y, P.to_tensor(w), stride=2)]
    got = both(case, 1e-2)
    assert [g[1] for g in got] == ["bfloat16"] * 5
