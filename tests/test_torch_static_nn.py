"""paddle_tpu_torch.static.nn against the JAX package's: twins of
``tests/test_static_nn.py``.

Each twin runs one scenario in both packages from the same numpy inputs
(parameters the scenario makes are written from seeded numpy arrays in
both) and holds the results equal: f32 values within 1e-5 (1e-3 where
the JAX test's own tolerance is looser: ``spectral_norm``'s unit
sigma), shapes, program counts and error types exactly. The JAX
package's "compiled" cases trace under ``jax.jit``; on the CPU the
port's ``StaticFunction`` runs them eagerly, so they hold its concrete
regime against the JAX package's traced one (the captured regime, the
conditional nodes, runs on the card: ``chip_smoke.py`` phase 27).

- The parity gate reads the reference checkout, which is absent: the
  twin holds the port's ``static.nn`` to the JAX package's ``__all__``.
- ``cond``'s branch-structure check runs in the JAX package's traced
  regime; the port's runs where both branches are built, a ``cond``
  recorded in a static program (and under capture).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import static as jstatic
from paddle_tpu_torch import jit, static
from torch_facade_common import on_cpu  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _S(P):
    return jstatic if P is pt else static


def _J(P):
    return jjit if P is pt else jit


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _same(got, want, tol=TOL):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), \
            (got, want)
        for g, w in zip(got, want):
            _same(g, w, tol)
    elif isinstance(want, (np.ndarray, np.generic, float)):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), **tol)
    else:
        assert got == want, (got, want)


def _params(P, out_params, seed):
    """Write seeded numpy values into parameters of package ``P``."""
    rng = np.random.default_rng(seed)
    for p in out_params:
        arr = (rng.standard_normal(tuple(p.shape)) * 0.3).astype("float32")
        if P is pt:
            import jax.numpy as jnp

            p._set_value(jnp.asarray(arr))
        else:
            with torch.no_grad():
                p._value.copy_(torch.as_tensor(arr))


# ------------------------------------------------------------ scenarios
def _cond_eager_and_grad(P):
    t = P.to_tensor
    x = t(np.array([2.0], np.float32))
    x.stop_gradient = False
    nn = _S(P).nn
    out = nn.cond(t(np.array(True)), lambda: x * 2, lambda: x * 3)
    out.backward()
    out2 = nn.cond(t(np.array(False)), lambda: x * 2, lambda: x * 3)
    return _np(out), _np(x.grad), _np(out2)


def _cond_compiled_with_gradients(P):
    t = P.to_tensor
    nn = _S(P).nn
    w = t(np.array([2.0, 3.0], np.float32))
    w.stop_gradient = False
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=[w])

    def step(x):
        pred = x.sum() > 0
        loss = nn.cond(pred, lambda: (x * w).sum(), lambda: (x - w).sum())
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    sf = _J(P).to_static(step, warmup=False)
    loss = sf(t(np.array([1.0, 2.0], np.float32)))
    w1 = _np(w).copy()
    sf(t(np.array([-1.0, -2.0], np.float32)))
    return float(_np(loss)), w1, _np(w)


def _cond_both_branches(P):
    t = P.to_tensor
    nn = _S(P).nn
    sf = _J(P).to_static(
        lambda x: nn.cond(x.sum() > 0, lambda: x * 10.0, lambda: x * 100.0),
        warmup=False)
    a = _np(sf(t(np.array([1.0], np.float32))))
    b = _np(sf(t(np.array([-1.0], np.float32))))
    return a, b, len(sf._cache)


def _while_eager_grad(P):
    t = P.to_tensor
    nn = _S(P).nn
    x = t(np.array([1.5], np.float32))
    x.stop_gradient = False
    iv, v = nn.while_loop(lambda i, v: i < 3, lambda i, v: [i + 1, v * x],
                          [t(np.array(0, np.int64)),
                           t(np.array([1.0], np.float32))])
    v.sum().backward()
    return _np(v), _np(x.grad), int(_np(iv))


def _while_compiled(P):
    t = P.to_tensor
    nn = _S(P).nn

    def fn(x, n):
        i0 = P.to_tensor(np.array(0, np.int32))
        _, v = nn.while_loop(lambda i, v: i < n,
                             lambda i, v: [i + 1, v * 1.5], [i0, x])
        return v

    sf = _J(P).to_static(fn, warmup=False)
    a = _np(sf(t(np.array([1.0], np.float32)), t(np.array(5, np.int32))))
    b = _np(sf(t(np.array([1.0], np.float32)), t(np.array(2, np.int32))))
    return a, b, len(sf._cache)


def _while_errors(P):
    t = P.to_tensor
    nn = _S(P).nn
    got = []
    for args in ((None, lambda i: [i], [t(np.array(0))]),
                 (lambda: True, lambda: [], [])):
        try:
            nn.while_loop(*args)
            got.append(None)
        except (TypeError, ValueError) as e:
            got.append(type(e).__name__)
    return got


def _case_eager(P):
    t = P.to_tensor
    nn = _S(P).nn
    x = t(np.array([1.0], np.float32))
    T_, F_ = t(np.array(True)), t(np.array(False))
    return [_np(nn.case([(T_, lambda: x + 1), (T_, lambda: x + 2)],
                        default=lambda: x)),
            _np(nn.case([(F_, lambda: x + 1), (F_, lambda: x + 2)],
                        default=lambda: x + 9)),
            _np(nn.case([(F_, lambda: x + 1), (F_, lambda: x + 2)]))]


def _case_compiled(P):
    t = P.to_tensor
    nn = _S(P).nn

    def fn(a, x):
        return nn.case([(a > 3, lambda: x + 100.0),
                        (a > 1, lambda: x + 10.0)], default=lambda: x)

    sf = _J(P).to_static(fn, warmup=False)
    got = [_np(sf(t(np.array(av, np.float32)),
                  t(np.array([1.0], np.float32)))) for av in (2.0, 5.0, 0.0)]
    return got, len(sf._cache)


def _switch_case(P):
    t = P.to_tensor
    nn = _S(P).nn
    x = t(np.array([2.0], np.float32))
    fns = {0: lambda: x * 1.0, 1: lambda: x * 10.0, 3: lambda: x * 30.0}
    eager = [_np(nn.switch_case(t(np.array(1)), fns)),
             _np(nn.switch_case(t(np.array(7)), fns))]

    def fn(idx, v):
        return nn.switch_case(idx, [lambda: v * 1.0, lambda: v * 10.0,
                                    lambda: v * 20.0])

    sf = _J(P).to_static(fn, warmup=False)
    comp = [_np(sf(t(np.array(i)), t(np.array([1.0], np.float32))))
            for i in (2, 0)]
    return eager, comp, len(sf._cache)


def _switch_duplicate(P):
    try:
        _S(P).nn.switch_case(P.to_tensor(np.array(0)),
                             [(0, lambda: None), (0, lambda: None)])
    except ValueError:
        return "ValueError"
    return None


def _fc_minimize(P):
    S = _S(P)
    with S.program_guard(S.Program()):
        x = S.data("x", [None, 4], "float32")
        y = S.nn.fc(x, 3, activation="relu")
        loss = y.sum()
        opt = P.optimizer.SGD(learning_rate=0.1)
        opt.minimize(loss)
        _params(P, opt._parameter_list, 0)
        exe = S.Executor()
        feed = {"x": np.random.RandomState(0).randn(5, 4).astype(np.float32)}
        l0 = float(exe.run(feed=feed, fetch_list=[loss])[0])
        for _ in range(5):
            l1 = float(exe.run(feed=feed, fetch_list=[loss])[0])
    return len(opt._parameter_list), l0, l1


def _layer_shapes(P):
    nn = _S(P).nn
    t = P.to_tensor
    rng = np.random.RandomState(0)
    img = t(rng.randn(2, 3, 8, 8).astype(np.float32))
    vol = t(rng.randn(2, 3, 4, 8, 8).astype(np.float32))
    x2 = t(rng.randn(4, 6).astype(np.float32))
    return [
        nn.conv2d(img, 4, 3, padding=1).shape, nn.batch_norm(img).shape,
        nn.group_norm(img, 3).shape, nn.instance_norm(img).shape,
        nn.prelu(img, "channel").shape,
        nn.conv2d_transpose(img, 4, filter_size=2, stride=2).shape,
        nn.conv3d(vol, 4, 3, padding=1).shape, nn.layer_norm(x2).shape,
        nn.data_norm(t(np.abs(rng.randn(4, 6)).astype(np.float32))).shape,
        nn.fc(img, 10).shape,
        nn.embedding(t(np.array([[1, 2]])), (10, 6)).shape,
        nn.sparse_embedding(t(np.array([[1, 2]])), (10, 6)).shape,
        nn.bilinear_tensor_product(t(rng.randn(2, 3).astype(np.float32)),
                                   t(rng.randn(2, 4).astype(np.float32)),
                                   5).shape,
        nn.row_conv(t(rng.randn(2, 6, 4).astype(np.float32)), 2).shape,
        nn.nce(t(rng.randn(4, 8).astype(np.float32)),
               t(np.array([[1], [2], [3], [0]])), 20,
               num_neg_samples=5).shape,
        nn.continuous_value_model(t(rng.randn(4, 6).astype(np.float32)),
                                  None, use_cvm=False).shape]


def _spectral_norm(P):
    w = P.to_tensor(np.random.RandomState(0).randn(6, 4).astype(np.float32))
    wn = _np(_S(P).nn.spectral_norm(w, power_iters=20))
    return wn, np.linalg.svd(wn, compute_uv=False)[0]


def _sequence_ops(P):
    nn = _S(P).nn
    t = P.to_tensor
    xv = np.random.RandomState(0).randn(2, 5, 3).astype(np.float32)
    s = t(xv)
    padded, lens = nn.sequence_pad(s, t(np.float32(0)), maxlen=7)
    up = nn.sequence_unpad(padded, t(np.array([3, 5])))
    return [_np(nn.sequence_pool(s, "sum")), _np(nn.sequence_pool(s, "sqrt")),
            _np(nn.sequence_first_step(s)), _np(nn.sequence_last_step(s)),
            _np(nn.sequence_reverse(s)), _np(nn.sequence_softmax(s)),
            _np(padded), _np(lens), _np(up), up.shape]


def _sequence_conv(P):
    xv = np.random.RandomState(1).randn(1, 4, 2).astype(np.float32)
    return _S(P).nn.sequence_conv(P.to_tensor(xv), 3, filter_size=3,
                                  bias_attr=False).shape


def _static_rnn_cumsum(P):
    nn = _S(P).nn
    xv = np.random.RandomState(0).randn(5, 3, 4).astype(np.float32)
    x = P.to_tensor(xv)
    x.stop_gradient = False
    rnn = nn.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        prev = rnn.memory(shape=[-1, 4], batch_ref=xt, init_value=0.0)
        h = prev + xt
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    out = rnn()
    out.sum().backward()
    return _np(out), _np(x.grad)


def _static_rnn_params(P):
    nn = _S(P).nn
    x = P.to_tensor(np.random.RandomState(0).randn(4, 2, 3).astype(
        np.float32))
    rnn = nn.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        prev = rnn.memory(shape=[-1, 6], batch_ref=xt, init_value=0.0)
        h = nn.fc(P.concat([xt, prev], axis=-1), 6, activation="tanh")
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    out = rnn()
    loss = (out * out).sum()
    loss.backward()
    params = _S(P)._collect_parameters(loss)
    return (out.shape, len(params),
            all(p.grad is not None for p in params))


def _static_rnn_misuse(P):
    got = []
    rnn = _S(P).nn.StaticRNN()
    for call in (lambda: rnn.step_input(P.to_tensor(np.zeros((2, 2),
                                                              np.float32))),
                 lambda: rnn()):
        try:
            call()
            got.append(None)
        except RuntimeError:
            got.append("RuntimeError")
    return got


def _sequence_conv_window(P):
    xv = np.arange(8, dtype=np.float32).reshape(1, 8, 1)
    out = _S(P).nn.sequence_conv(
        P.to_tensor(xv), 1, filter_size=1, padding_start=1, bias_attr=False,
        param_attr=P.ParamAttr(initializer=P.nn.initializer.Constant(1.0)))
    return _np(out)[0, :, 0]


def _static_rnn_no_grad(P):
    nn = _S(P).nn
    xv = np.random.RandomState(0).randn(5, 3, 4).astype(np.float32)
    with P.no_grad():
        rnn = nn.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(P.to_tensor(xv))
            prev = rnn.memory(shape=[-1, 4], batch_ref=xt, init_value=0.0)
            h = prev + xt
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()
    return _np(out)


def _passthrough_carry(P):
    nn = _S(P).nn

    def fn(n):
        h = P.to_tensor(np.int32(0))
        s = P.to_tensor(np.float32(0.0))
        i = P.to_tensor(np.int32(0))
        _, s2, i2 = nn.while_loop(lambda h, s, i: h < n,
                                  lambda h, s, i: (h + 1, s + 1.0, h),
                                  (h, s, i))
        return s2 + 0, i2 + 0

    f = _J(P).StaticFunction(fn, warmup=False)
    return [tuple(float(_np(v)) for v in f(P.to_tensor(np.int64(4))))
            for _ in range(2)]


def _carry_aliased(P):
    import importlib

    mod = importlib.import_module(
        "paddle_tpu.jit.dy2static" if P is pt
        else "paddle_tpu_torch.jit.dy2static")

    x = P.to_tensor(np.array([1.0], np.float32))
    n = P.to_tensor(np.int64(4))
    eager = _np(mod.ast_transform(_aliased_loop)(x, n, P)).item()
    sf = _J(P).StaticFunction(mod.ast_transform(_aliased_loop),
                              warmup=False)
    return eager, _np(sf(x, n, P)).item()


def _aliased_loop(x, n, P):
    s = x            # s IS x (the same Tensor) at loop entry
    i = P.to_tensor(np.int64(0))
    while i < n:
        s = s + x    # the closure read of x stays the initial x
        i = i + 1
    return s


SCENARIOS = {
    "cond_eager": _cond_eager_and_grad,
    "cond_grad": _cond_compiled_with_gradients,
    "cond_both": _cond_both_branches, "while_eager": _while_eager_grad,
    "while_compiled": _while_compiled, "while_errors": _while_errors,
    "case_eager": _case_eager, "case_compiled": _case_compiled,
    "switch": _switch_case, "switch_dup": _switch_duplicate,
    "fc": _fc_minimize, "shapes": _layer_shapes,
    "spectral": _spectral_norm, "sequence": _sequence_ops,
    "seq_conv": _sequence_conv, "rnn_cumsum": _static_rnn_cumsum,
    "rnn_params": _static_rnn_params, "rnn_misuse": _static_rnn_misuse,
    "seq_window": _sequence_conv_window, "rnn_no_grad": _static_rnn_no_grad,
    "passthrough": _passthrough_carry, "aliased": _carry_aliased,
}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's results of every scenario, computed once."""
    return {name: fn(pt) for name, fn in SCENARIOS.items()}


def _twin(jax_ref, name, tol=TOL):
    got = SCENARIOS[name](paddle)
    _same(got, jax_ref[name], tol)
    return got


# ---------------------------------------------------------------- twins
def test_static_nn_parity_gate():
    """The reference checkout is absent: the port's ``static.nn`` holds
    every name of the JAX package's ``static.nn.__all__``."""
    missing = [n for n in jstatic.nn.__all__ if not hasattr(static.nn, n)]
    assert missing == [], missing
    assert sorted(static.nn.__all__) == sorted(jstatic.nn.__all__)


def test_cond_eager_and_grad(jax_ref):
    out, g, out2 = _twin(jax_ref, "cond_eager")
    np.testing.assert_allclose(out, [4.0])
    np.testing.assert_allclose(g, [2.0])
    np.testing.assert_allclose(out2, [6.0])


def test_cond_structure_mismatch_raises():
    """The JAX package raises under its trace; the port where both
    branches are built: a ``cond`` recorded in a program."""
    t = pt.to_tensor
    x = t(np.array([1.0], np.float32))
    with pytest.raises(ValueError, match="same structure"):
        jjit.to_static(lambda p: jstatic.nn.cond(
            p > 0, lambda: (x, x), lambda: x), warmup=False)(
                t(np.array(1.0, np.float32)))
    with static.program_guard(static.Program()):
        p = static.data("p", [], "float32")
        y = paddle.to_tensor(np.array([1.0], np.float32))
        with pytest.raises(ValueError, match="same structure"):
            static.nn.cond(p > 0, lambda: (y, y), lambda: y)


def test_cond_compiled_with_gradients(jax_ref):
    loss, w1, w2 = _twin(jax_ref, "cond_grad")
    assert loss == 8.0
    np.testing.assert_allclose(w1, [1.9, 2.8], rtol=1e-5)
    np.testing.assert_allclose(w2, w1 + 0.1, rtol=1e-5)


def test_cond_compiled_both_branches_in_one_program(jax_ref):
    a, b, n = _twin(jax_ref, "cond_both")
    np.testing.assert_allclose(a, [10.0])
    np.testing.assert_allclose(b, [-100.0])
    assert n == 1


def test_while_loop_eager_grad_through_dynamic_trip_count(jax_ref):
    v, g, i = _twin(jax_ref, "while_eager")
    np.testing.assert_allclose(v, [1.5 ** 3], rtol=1e-6)
    np.testing.assert_allclose(g, [3 * 1.5 ** 2], rtol=1e-5)
    assert i == 3


def test_while_loop_compiled(jax_ref):
    a, b, n = _twin(jax_ref, "while_compiled")
    np.testing.assert_allclose(a, [1.5 ** 5], rtol=1e-6)
    np.testing.assert_allclose(b, [1.5 ** 2], rtol=1e-6)
    assert n == 1


def test_while_loop_errors(jax_ref):
    assert _twin(jax_ref, "while_errors") == ["TypeError", "ValueError"]


def test_case_eager_first_true_wins(jax_ref):
    got = _twin(jax_ref, "case_eager")
    np.testing.assert_allclose(np.concatenate(got), [2.0, 10.0, 3.0])


def test_case_compiled(jax_ref):
    got, n = _twin(jax_ref, "case_compiled")
    np.testing.assert_allclose(np.concatenate(got), [11.0, 101.0, 1.0])
    assert n == 1


def test_switch_case_eager_and_compiled(jax_ref):
    eager, comp, n = _twin(jax_ref, "switch")
    np.testing.assert_allclose(np.concatenate(eager), [20.0, 60.0])
    np.testing.assert_allclose(np.concatenate(comp), [20.0, 1.0])
    assert n == 1


def test_switch_case_duplicate_index_raises(jax_ref):
    assert _twin(jax_ref, "switch_dup") == "ValueError"


def test_fc_and_minimize_collects_params(jax_ref):
    n, l0, l1 = _twin(jax_ref, "fc")
    assert n == 2 and l1 <= l0 + 1e-6


def test_layers_shapes(jax_ref):
    shapes = _twin(jax_ref, "shapes")
    assert shapes[0] == [2, 4, 8, 8] and shapes[5] == [2, 4, 16, 16]


def test_spectral_norm_unit_sigma(jax_ref):
    _, sigma = _twin(jax_ref, "spectral", tol=dict(rtol=1e-3, atol=1e-3))
    np.testing.assert_allclose(sigma, 1.0, rtol=1e-3)


def test_sequence_ops_numerics(jax_ref):
    got = _twin(jax_ref, "sequence")
    assert got[-1] == [2, 5, 3]


def test_sequence_conv_matches_manual(jax_ref):
    assert _twin(jax_ref, "seq_conv") == [1, 4, 3]


def test_static_rnn_cumsum_and_grad(jax_ref):
    out, g = _twin(jax_ref, "rnn_cumsum")
    xv = np.random.RandomState(0).randn(5, 3, 4).astype(np.float32)
    np.testing.assert_allclose(out, np.cumsum(xv, axis=0), rtol=1e-5)
    np.testing.assert_allclose(g[0], np.full((3, 4), 5.0), rtol=1e-6)


def test_static_rnn_with_parameters_trains(jax_ref):
    shape, n, all_grads = _twin(jax_ref, "rnn_params")
    assert shape == [4, 2, 6] and n > 0 and all_grads


def test_static_rnn_misuse_raises(jax_ref):
    assert _twin(jax_ref, "rnn_misuse") == ["RuntimeError", "RuntimeError"]


def test_sequence_conv_padding_start_window(jax_ref):
    got = _twin(jax_ref, "seq_window")
    np.testing.assert_allclose(got, list(range(1, 8)) + [0.0])


def test_static_rnn_correct_under_no_grad(jax_ref):
    got = _twin(jax_ref, "rnn_no_grad")
    xv = np.random.RandomState(0).randn(5, 3, 4).astype(np.float32)
    np.testing.assert_allclose(got, np.cumsum(xv, axis=0), rtol=1e-5)


def test_while_loop_passthrough_carry_slot(jax_ref):
    assert _twin(jax_ref, "passthrough") == [(4.0, 3.0), (4.0, 3.0)]


def test_while_loop_carry_aliased_with_closure_capture(jax_ref):
    assert _twin(jax_ref, "aliased") == (5.0, 5.0)
