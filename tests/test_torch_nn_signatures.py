"""The port's ``paddle.nn.functional`` takes the JAX package's positional
signatures and Paddle's layouts.

Each case calls the reference and the port with the same positional
arguments and holds the results equal at f32 1e-5:

- ``F.linear(x, w, b)`` with a non-square ``[in, out]`` weight (the
  port's ``linear`` once took torch's ``[out, in]`` and computed
  ``x @ w.T``: a shape error here, and the transposed product for a
  square weight);
- ``F.dropout(x, p, axis, training, mode)``: the third positional
  parameter is ``axis`` (it was ``training``), and ``mode`` exists;
- ``F.cross_entropy(x, y, weight)``: the third positional parameter is
  the class weight (it was ``ignore_index``);
- ``F.embedding(x, w, padding_idx)`` and ``F.layer_norm`` with all its
  parameters by position, ``name`` included.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import both, on_cpu  # noqa: F401

TOL = 1e-5


def R(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype("f4")


def test_linear_takes_an_in_out_weight():
    x, w, b = R(2, 3), R(3, 5, seed=1), R(5, seed=2)
    got = both(lambda P: P.nn.functional.linear(
        P.to_tensor(x), P.to_tensor(w), P.to_tensor(b)), TOL)
    np.testing.assert_allclose(got[2], x @ w + b, rtol=TOL, atol=TOL)
    sq = R(3, 3, seed=3)
    both(lambda P: P.nn.functional.linear(P.to_tensor(x), P.to_tensor(sq)),
         TOL)


def test_dropout_positional_axis_training_mode():
    x = np.ones((64, 32), "f4")
    # axis=None, training=False: the input as it is
    both(lambda P: P.nn.functional.dropout(P.to_tensor(x), 0.4, None,
                                           False), TOL)
    # downscale_in_infer at inference scales by 1 - p
    got = both(lambda P: P.nn.functional.dropout(
        P.to_tensor(x), 0.4, None, False, "downscale_in_infer"), TOL)
    np.testing.assert_allclose(got[2], 0.6 * x)
    # axis=None, training=True by position: both drop (different bits)
    for P in (pt, paddle):
        y = np.asarray(P.nn.functional.dropout(P.to_tensor(x), 0.5, None,
                                               True).numpy())
        assert 0.4 < (y == 0).mean() < 0.6, P.__name__
        # axis 0 by position: whole rows kept or dropped
        y = np.asarray(P.nn.functional.dropout(P.to_tensor(x), 0.5, 0,
                                               True).numpy())
        assert np.all(y.std(1) == 0), P.__name__


def test_cross_entropy_third_positional_is_the_class_weight():
    x = R(6, 4)
    y = np.array([0, 3, 1, 2, 3, 1])
    w = np.array([0.5, 2.0, 1.0, 3.0], "f4")
    both(lambda P: P.nn.functional.cross_entropy(
        P.to_tensor(x), P.to_tensor(y), P.to_tensor(w)), TOL)
    both(lambda P: P.nn.functional.cross_entropy(
        P.to_tensor(x), P.to_tensor(y), None, 3, "none"), TOL)


def test_embedding_and_layer_norm_take_every_parameter_by_position():
    ids = np.array([[0, 2, 4], [4, 1, 0]])
    table = R(5, 3)
    got = both(lambda P: P.nn.functional.embedding(
        P.to_tensor(ids), P.to_tensor(table), 4, False, None), TOL)
    assert np.all(got[2][0, 2] == 0)
    x, g, b = R(2, 3, 4), R(4, seed=1), R(4, seed=2)
    both(lambda P: P.nn.functional.layer_norm(
        P.to_tensor(x), 4, P.to_tensor(g), P.to_tensor(b), 1e-3, None), TOL)


def _functionals():
    import paddle_tpu_torch.nn.functional as TF

    return sorted(TF.__all__)


@pytest.mark.parametrize("name", _functionals())
def test_functional_signatures_equal_the_jax_package(name):
    """Each functional of the port has the JAX package's parameter names,
    order and defaults."""
    import inspect

    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF

    def sig(f):
        return [(p.name, p.default) for p in
                inspect.signature(f).parameters.values()]
    assert sig(getattr(TF, name)) == sig(getattr(JF, name))


def test_nn_exports_the_names_of_the_ported_modules():
    """``paddle.nn`` holds every class of the JAX package's
    ``nn/layer/{activation,common,container,conv,extended,loss,norm,
    pooling,rnn,transformer}.py`` and its ``quant`` module (``Stub``);
    ``nn.functional`` every functional of its ``activation``, ``common``,
    ``conv``, ``extended``, ``loss``, ``norm`` and ``pooling``."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu.nn.layer import (activation, common, container, conv,
                                     extended, loss, norm, pooling, rnn,
                                     transformer)

    mods = (activation, common, container, conv, extended, loss, norm,
            pooling, rnn, transformer)
    want = set().union(*(m.__all__ for m in mods))
    base = {"functional", "initializer", "utils", "clip", "Layer",
            "ParamAttr", "ClipGradByValue", "ClipGradByNorm",
            "ClipGradByGlobalNorm"}
    assert set(paddle.nn.__all__) == want | base
    assert all(hasattr(paddle.nn, n) for n in want | base)
    assert pt.nn.quant.__all__ == paddle.nn.quant.__all__ == ["Stub"]
    fwant = set().union(*(getattr(JF, m).__all__ for m in
                          ("activation", "common", "conv", "extended",
                           "loss", "norm", "pooling")))
    assert fwant <= set(paddle.nn.functional.__all__)
    assert hasattr(paddle.nn.functional, "grid_sample")
