"""The port's ``return_mask``, ``max_unpool`` and adaptive pools against
the JAX package's, on the CPU, as ``tests/test_torch_nn_conv_pool.py``
holds the other pools (same runner and tolerance, f32 1e-5; the cases
are ``vision_cases.MASKS``):

- ``return_mask`` (int32, the flat unpadded index of each window's first
  maximum) with ``ceil_mode`` over tied values, and the ``max_unpool``
  round trip in 1-D, 2-D and 3-D; the mask refuses string padding and a
  channel-last layout in both packages;
- adaptive average and max pools with sizes that do not divide, the
  adaptive max's gradient over ties (shared among them, axis by axis),
  its mask, NHWC, 1-D and 3-D, and ``None`` keeping a size (which the
  reference's ``_tuplize`` refuses).
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.tools.vision_cases import CASES, MASKS, R
from torch_facade_common import both, on_cpu  # noqa: F401
from torch_nn_common import grads_of, one_thread  # noqa: F401

TOL = 1e-5


@pytest.mark.parametrize("name", sorted(MASKS))
def test_case(name):
    fn, arrays = CASES[name]
    got = both(grads_of(fn, *arrays), TOL)
    if name == "return_mask_ceil_ties":
        assert got[1][1] == "int32"
    if name == "unpool_round_trip":
        x = arrays[0]
        kept = got[0][2] != 0
        np.testing.assert_array_equal(got[0][2][kept], x[kept])


def test_mask_refuses_string_padding_and_channels_last():
    x = R(2, 3, 8, 7)
    for P in (pt, paddle):
        for kw in (dict(padding="SAME"), dict(data_format="NHWC")):
            with pytest.raises(NotImplementedError):
                P.nn.functional.max_pool2d(P.to_tensor(x), 2,
                                           return_mask=True, **kw)


def test_adaptive_pool_none_keeps_the_size():
    """``None`` keeps a size (the reference's ``_tuplize`` refuses it)."""
    x = R(2, 3, 7, 10)
    F = paddle.nn.functional
    got = F.adaptive_avg_pool2d(paddle.to_tensor(x), [None, 5]).numpy()
    want = pt.nn.functional.adaptive_avg_pool2d(pt.to_tensor(x),
                                                [7, 5]).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(TypeError):
        pt.nn.functional.adaptive_avg_pool2d(pt.to_tensor(x), [None, 5])
