"""``paddle_tpu_torch.create_parameter`` against the JAX package's
(``paddle_tpu/framework/core_api.py:139-157``): Xavier-normal fans from
``[in, out]`` or ``[out, in, k...]`` times the receptive field, zeros
for a bias, ``attr=``'s initializer and name honoured. The draws differ
(each package its own generator), so the std is held per shape within
10% of the JAX one's and of the formula's."""
import math

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle


@pytest.fixture(autouse=True)
def on_cpu():
    paddle.set_device("cpu")
    yield
    paddle.set_device(None)


@pytest.mark.parametrize("shape,fans", [
    ([64, 3, 7, 7], (3 * 49, 64 * 49)), ([256, 512], (256, 512)),
    ([128, 64, 3, 3], (64 * 9, 128 * 9)), ([1024, 64], (1024, 64))])
def test_xavier_std_per_shape(shape, fans):
    paddle.seed(0)
    pt.seed(0)
    got = paddle.create_parameter(shape, "float32")
    want = pt.create_parameter(shape, "float32")
    std = math.sqrt(2.0 / sum(fans))
    g = float(got._value.detach().std())
    j = float(np.asarray(want.numpy()).std())
    assert abs(g - std) < 0.1 * std and abs(g - j) < 0.1 * j
    assert tuple(got.shape) == tuple(shape) and not got.stop_gradient


def test_the_conv_weight_of_the_old_fault():
    """``[64, 3, 7, 7]`` drew a std of 0.1732 before (fans 64 and 3);
    the reference's is 0.0247."""
    paddle.seed(0)
    g = float(paddle.create_parameter([64, 3, 7, 7],
                                      "float32")._value.detach().std())
    assert abs(g - 0.0247) < 0.1 * 0.0247


def test_bias_attr_and_default_initializer():
    I = paddle.nn.initializer
    b = paddle.create_parameter([5], "float32", is_bias=True)
    assert not b._value.detach().any()
    a = paddle.create_parameter(
        [4, 5], "float32", attr=paddle.nn.ParamAttr(
            name="w0", initializer=I.Constant(3.0)))
    ja = pt.create_parameter([4, 5], "float32", attr=pt.nn.ParamAttr(
        initializer=pt.nn.initializer.Constant(3.0)))
    np.testing.assert_array_equal(a._value.detach().numpy(), ja.numpy())
    assert a.name == "w0"
    d = paddle.create_parameter([2, 3], "float32",
                                default_initializer=I.Constant(-1.0))
    np.testing.assert_array_equal(d._value.detach().numpy(), -1.0)
    # attr's initializer wins over default_initializer, as in the JAX one
    e = paddle.create_parameter([2], "float32", attr=I.Constant(2.0),
                                default_initializer=I.Constant(-1.0))
    np.testing.assert_array_equal(e._value.detach().numpy(), 2.0)
    frozen = paddle.create_parameter(
        [2], "float32", attr=paddle.nn.ParamAttr(trainable=False))
    assert frozen.stop_gradient
