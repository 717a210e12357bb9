"""The port's initializers and ``ParamAttr`` on the CPU.

The draws are not the JAX package's (module docstring of
``paddle_tpu_torch/nn/initializer``): each initializer is held to its
formula instead, at n >= 1e5 draws (mean, std and bounds within a few
standard errors), and to the JAX package's fans, gains and
deterministic values exactly. ``paddle.seed(n)`` repeats the draws.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.nn import initializer as I
from torch_facade_common import on_cpu  # noqa: F401

N = (400, 300)  # 1.2e5 draws


def draw(init, shape=N, dtype="float32"):
    t = init(shape, dtype)
    assert t.device.type == "cpu" and tuple(t.shape) == tuple(shape)
    return t.float().numpy()


@pytest.mark.parametrize("init,mean,std,lo,hi", [
    (I.Normal(0.5, 2.0), 0.5, 2.0, None, None),
    (I.TruncatedNormal(-1.0, 0.5), -1.0, 0.5 * 0.87962566, -2.0, 0.0),
    (I.Uniform(-0.3, 0.7), 0.2, 1.0 / math.sqrt(12), -0.3, 0.7),
    (I.XavierNormal(), 0.0, math.sqrt(2.0 / 700), None, None),
    (I.XavierUniform(), 0.0, math.sqrt(6.0 / 700) / math.sqrt(3),
     -math.sqrt(6.0 / 700), math.sqrt(6.0 / 700)),
    (I.KaimingNormal(), 0.0, math.sqrt(2.0) / math.sqrt(400), None, None),
    (I.KaimingUniform(nonlinearity="leaky_relu", negative_slope=0.2), 0.0,
     math.sqrt(2.0 / 1.04) * math.sqrt(3.0 / 400) / math.sqrt(3),
     -math.sqrt(2.0 / 1.04) * math.sqrt(3.0 / 400),
     math.sqrt(2.0 / 1.04) * math.sqrt(3.0 / 400)),
    (I.XavierUniform(fan_in=10, fan_out=20, gain=2.0), 0.0,
     2.0 * math.sqrt(6.0 / 30) / math.sqrt(3), -2.0 * math.sqrt(0.2),
     2.0 * math.sqrt(0.2)),
])
def test_random_initializers_follow_their_formula(init, mean, std, lo, hi):
    a = draw(init)
    se = std / math.sqrt(a.size)
    assert abs(a.mean() - mean) < 5 * se + 1e-7, (a.mean(), mean)
    assert abs(a.std() - std) < 0.02 * std, (a.std(), std)
    if lo is not None:
        assert a.min() >= lo - 1e-6 and a.max() <= hi + 1e-6
        assert a.min() < lo + 0.01 * (hi - lo)
        assert a.max() > hi - 0.01 * (hi - lo)


def test_fans_gains_and_bf16():
    """The JAX package's fans and gains; a bf16 parameter is the f32 draw
    cast."""
    from paddle_tpu.nn import initializer as JI

    for shape in [(5,), (4, 3), (8, 2, 3, 3), (6, 4, 5)]:
        assert I._fan_in_out(shape) == JI._fan_in_out(shape)
    for nl, p in [("relu", None), ("tanh", None), ("leaky_relu", 0.3),
                  ("selu", None), ("conv2d", None)]:
        assert I.calculate_gain(nl, p) == JI.calculate_gain(nl, p)
    with pytest.raises(ValueError):
        I.calculate_gain("swish")
    paddle.seed(3)
    a = draw(I.Normal(), (64, 64))
    paddle.seed(3)
    b = I.Normal()((64, 64), "bfloat16")
    assert b.dtype == torch.bfloat16
    np.testing.assert_array_equal(b.float().numpy(),
                                  torch.from_numpy(a).bfloat16().float())


@pytest.mark.parametrize("name,make,shape", [
    ("Constant", lambda M: M.Constant(0.25), (3, 4)),
    ("Assign", lambda M: M.Assign(np.arange(12.0).reshape(3, 4)), (3, 4)),
    ("Dirac", lambda M: M.Dirac(groups=2), (4, 3, 3, 3)),
    ("Bilinear", lambda M: M.Bilinear(), (2, 3, 4, 4)),
])
def test_deterministic_initializers_equal_the_jax_package(name, make, shape):
    from paddle_tpu.nn import initializer as JI

    want = np.asarray(make(JI)(shape, "float32"))
    np.testing.assert_array_equal(make(I)(shape, "float32").numpy(), want)


def test_orthogonal_and_assign_errors():
    q = draw(I.Orthogonal(gain=2.0), (6, 10))
    np.testing.assert_allclose(q @ q.T, 4.0 * np.eye(6), atol=1e-5)
    q = draw(I.Orthogonal(), (12, 2, 2))
    m = q.reshape(12, 4)
    np.testing.assert_allclose(m.T @ m, np.eye(4), atol=1e-5)
    with pytest.raises(ValueError):
        I.Orthogonal()((5,), "float32")
    with pytest.raises(ValueError):
        I.Assign(np.zeros(3))((4,), "float32")
    with pytest.raises(ValueError):
        I.Dirac()((3, 3), "float32")


def test_seed_repeats_the_draws():
    def layer():
        return paddle.nn.Sequential(paddle.nn.Linear(8, 6),
                                    paddle.nn.Embedding(10, 4),
                                    paddle.nn.PReLU())
    paddle.seed(7)
    a = [p.numpy() for p in layer().parameters()]
    paddle.seed(7)
    b = [p.numpy() for p in layer().parameters()]
    paddle.seed(8)
    c = [p.numpy() for p in layer().parameters()]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    for init in (I.TruncatedNormal(), I.Uniform(), I.Orthogonal()):
        paddle.seed(1)
        x = draw(init, (5, 5))
        paddle.seed(1)
        np.testing.assert_array_equal(draw(init, (5, 5)), x)


def test_param_attr_reaches_the_parameter():
    """``ParamAttr``'s initializer, name, trainable flag, learning rate
    and ``need_clip`` reach the Parameter in both packages; ``False``
    makes none; the defaults are XavierUniform weights and zero biases."""
    def case(P):
        attr = P.nn.ParamAttr(name="w0", initializer=P.nn.initializer.Constant(
            0.5), learning_rate=0.1, trainable=False, need_clip=False)
        lin = P.nn.Linear(3, 2, weight_attr=attr, bias_attr=False)
        w = lin.weight
        return (w.name, float(np.asarray(w.numpy()).mean()), w.stop_gradient,
                w.trainable, w.optimize_attr["learning_rate"], lin.bias is None,
                [n for n, _ in lin.named_parameters()])
    assert case(pt)[:-1] == case(paddle)[:-1] == (
        "w0", 0.5, True, False, 0.1, True)
    assert case(paddle)[-1] == case(pt)[-1] == ["weight"]
    lin = paddle.nn.Linear(3, 2, weight_attr=paddle.nn.ParamAttr(
        need_clip=False))
    assert lin.weight.need_clip is False and lin.bias.need_clip is True
    np.testing.assert_array_equal(lin.bias.numpy(), np.zeros(2))
    lim = math.sqrt(6.0 / 5)
    assert np.all(np.abs(lin.weight.numpy()) <= lim)
    # a string attr names the parameter; an initializer attr initializes it
    lin = paddle.nn.Linear(2, 2, weight_attr="named",
                           bias_attr=I.Constant(3.0))
    assert lin.weight.name == "named"
    np.testing.assert_array_equal(lin.bias.numpy(), [3.0, 3.0])


def test_global_initializer():
    I.set_global_initializer(I.Constant(2.0), I.Constant(-1.0))
    try:
        lin = paddle.nn.Linear(2, 3)
        np.testing.assert_array_equal(lin.weight.numpy(), np.full((2, 3), 2.0))
        np.testing.assert_array_equal(lin.bias.numpy(), -np.ones(3))
        lin = paddle.nn.Linear(2, 3, weight_attr=paddle.nn.ParamAttr(
            initializer=I.Constant(0.5)))
        np.testing.assert_array_equal(lin.weight.numpy(), np.full((2, 3), 0.5))
    finally:
        I.set_global_initializer(None, None)
    assert not np.all(paddle.nn.Linear(2, 3).weight.numpy() == 2.0)
