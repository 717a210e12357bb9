"""paddle_tpu_torch.static's legacy tail against the JAX package's: twins
of the static part of ``tests/test_legacy_tail.py``.

Each twin runs the JAX test's scenario in both packages from the same
numpy inputs and holds the results equal (f32 within 1e-6, the JAX
test's tolerance; shapes, lengths and error types exactly). The parity
gate reads the reference checkout, which is absent: its twin holds the
port's ``static.__all__`` to the JAX package's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import static as jstatic
from paddle_tpu_torch import static
from torch_facade_common import on_cpu  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _S(P):
    return jstatic if P is pt else static


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _set(P, param, arr):
    if P is pt:
        import jax.numpy as jnp

        param._set_value(jnp.asarray(arr))
    else:
        with torch.no_grad():
            param._value.copy_(torch.as_tensor(np.asarray(arr)))


@pytest.mark.parametrize("P", [pt, paddle], ids=["jax", "port"])
def test_gradients_and_append_backward(P):
    x = P.to_tensor(np.array([3.0], np.float32))
    x.stop_gradient = False
    y = (x ** 2).sum()
    (g,) = _S(P).gradients(y, [x])
    np.testing.assert_allclose(_np(g), [6.0], **TOL)
    lin = P.nn.Linear(2, 1)
    _set(P, lin.weight, np.array([[1.0], [2.0]], np.float32))
    loss = lin(P.to_tensor(np.ones((1, 2), np.float32))).sum()
    pairs = _S(P).append_backward(loss, parameter_list=[lin.weight])
    np.testing.assert_allclose(_np(pairs[0][1]), [[1.0], [1.0]], **TOL)


def test_static_all_matches_the_jax_package():
    """The reference checkout is absent: the port's ``static.__all__`` is
    the JAX package's (which holds the reference's less the IPU names)."""
    assert sorted(static.__all__) == sorted(jstatic.__all__)
    assert all(hasattr(static, n) for n in jstatic.__all__)


@pytest.mark.parametrize("P", [pt, paddle], ids=["jax", "port"])
def test_scope_and_name_scope_and_compiled_program(P):
    S = _S(P)
    with S.scope_guard(S.legacy._Scope()):
        with S.name_scope("block1"):
            pass
    prog = S.Program()
    cp = S.CompiledProgram(prog, S.BuildStrategy())
    assert cp.global_block() is prog


def test_print_and_py_func(capsys):
    got = []
    for P in (pt, paddle):
        x = P.to_tensor(np.array([1.0, 2.0], np.float32))
        y = _S(P).Print(x, message="dbg")
        out = capsys.readouterr().out
        assert "dbg" in out and "shape=[2]" in out

        class _Spec:
            shape = (2,)
            dtype = "float32"

        r = _S(P).py_func(lambda v: v * 3, x, _Spec())
        got.append((_np(y), _np(r)))
    for a, b in zip(*got):
        np.testing.assert_allclose(b, a, **TOL)
    np.testing.assert_allclose(got[1][1], [3.0, 6.0])


def test_exponential_moving_average():
    out = []
    for P in (pt, paddle):
        lin = P.nn.Linear(2, 2, bias_attr=False)
        _set(P, lin.weight, np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
        ema = _S(P).ExponentialMovingAverage(decay=0.5)
        ema.update(list(lin.parameters()))
        _set(P, lin.weight, np.zeros((2, 2), np.float32))
        ema.update()
        trained = _np(lin.weight).copy()
        with ema.apply():
            ema_w = _np(lin.weight).copy()
        out.append((trained, ema_w, _np(lin.weight).copy()))
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, **TOL)
    trained, ema_w, after = out[1]
    np.testing.assert_allclose(ema_w, [[0.5, 1.0], [1.5, 2.0]])
    np.testing.assert_array_equal(after, trained)


@pytest.mark.parametrize("P", [pt, paddle], ids=["jax", "port"])
def test_create_global_var_and_device_guard(P):
    v = _S(P).create_global_var([2, 3], 1.5, "float32", name="gv")
    np.testing.assert_array_equal(_np(v), np.full((2, 3), 1.5))
    with _S(P).device_guard("cpu"):
        w = P.ones([2])
    np.testing.assert_array_equal(_np(w), [1, 1])


@pytest.mark.parametrize("P", [pt, paddle], ids=["jax", "port"])
def test_static_save_load_roundtrip(P, tmp_path):
    S = _S(P)
    with S.program_guard(S.Program()):
        x = S.data("x", [4, 2], "float32")
        lin = P.nn.Linear(2, 1)
        loss = (lin(x) ** 2).mean()
        P.optimizer.SGD(learning_rate=0.1,
                        parameters=lin.parameters()).minimize(loss)
        prog = S.default_main_program()
        before = _np(lin.weight).copy()
        S.save(prog, str(tmp_path / "m"))
        _set(P, lin.weight, before * 0.0)
        S.load(prog, str(tmp_path / "m"))
        np.testing.assert_array_equal(_np(lin.weight), before)
        state = S.load_program_state(str(tmp_path / "m"))
        assert len(state) == len(list(lin.parameters()))
        state["not_a_param"] = np.zeros((1,), np.float32)
        with pytest.raises(ValueError, match="not matched"):
            S.set_program_state(prog, state)


def test_static_accuracy_auc_metric_bundle():
    out = []
    for P in (pt, paddle):
        S = _S(P)
        t = P.to_tensor
        pred = t(np.array([[0.1, 0.9], [0.8, 0.2]], np.float32))
        acc = S.accuracy(pred, t(np.array([[1], [0]])))
        scores = t(np.array([0.9, 0.1, 0.8, 0.2], np.float32))
        labels = t(np.array([1, 0, 1, 0], np.int64))
        bundle = S.ctr_metric_bundle(scores, labels)
        out.append([_np(acc).item(), _np(S.auc(scores, labels)).item()]
                   + [_np(b).item() for b in bundle])
    np.testing.assert_allclose(out[1], out[0], **TOL)
    assert out[1][0] == 1.0 and out[1][1] == pytest.approx(1.0, abs=1e-3)
    assert len(out[1]) == 2 + 7
