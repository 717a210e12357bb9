"""paddle_tpu_torch.static against the JAX package's: twins of
``tests/test_static.py``, GPT training through an Executor, the
feed-changes-every-fetch contract of the port's program record, and the
two findings the port fixes.

Each twin runs one scenario in both packages from the same numpy inputs
and weights (the JAX package's Linear weights copied into the port's):
feeds, fetches and losses within f32 1e-5 (the JAX test's rtol, as an
atol too), errors of the same type, program counts equal. On the CPU the
port's ``Executor`` replays its record eagerly (the graph exists only on
the card). The JAX references of a file's scenarios are computed once
(module-scoped fixtures).

- ``gpt_tiny`` trained three ``Executor.run`` steps in both packages, the
  JAX model's weights carried by ``load_reference_state_dict``: losses
  and parameters within 1e-5 (``tests/test_torch_facade_train.py``'s f32
  tolerance).
- The findings: the JAX package's Executor replays the branch the
  build-time zeros took for a ``cond`` on a placeholder, unrolls a
  ``while_loop`` to the build-time trip count, and drops the amp casts
  a program recorded; the port takes the fed predicate's branch, the fed
  trip count and the recorded casts (the JAX package's values are held
  beside the port's).
- ``Executor()`` and a tensor ``while`` under ``to_static`` default to the
  card and raise without one.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import static as jstatic
from paddle_tpu_torch import static
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _S(P):
    return jstatic if P is pt else static


def _set(P, param, arr):
    """Write ``arr`` into a parameter of package ``P``."""
    if P is pt:
        import jax.numpy as jnp

        param._set_value(jnp.asarray(arr))
    else:
        with torch.no_grad():
            param._value.copy_(torch.as_tensor(np.asarray(arr)))


def _linear(P, n_in, n_out, seed):
    """A Linear of package ``P`` with seeded numpy weights."""
    rng = np.random.default_rng(seed)
    lin = P.nn.Linear(n_in, n_out)
    _set(P, lin.weight, rng.standard_normal((n_in, n_out)).astype("f4")
         * 0.5)
    _set(P, lin.bias, rng.standard_normal((n_out,)).astype("f4") * 0.1)
    return lin


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


# ------------------------------------------------------------ scenarios
def _guard_scoping(P):
    S = _S(P)
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        inside = (S.default_main_program() is main,
                  S.default_startup_program() is startup)
        S.data("x", [None, 4])
    return inside + ("x" in main.placeholders,
                     S.default_main_program() is not main)


def _forward_feed_fetch(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [None, 4], "float32")
        y = _linear(P, 4, 2, 0)(x)
    exe = S.Executor()
    xv = np.random.default_rng(0).standard_normal((3, 4)).astype("float32")
    (out,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    xv8 = np.random.default_rng(1).standard_normal((8, 4)).astype("float32")
    (out8,) = exe.run(main, feed={"x": xv8}, fetch_list=[y])
    return out, out8, len(exe._cache)


def _training(P):
    S = _S(P)
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        x = S.data("x", [None, 8], "float32")
        lab = S.data("y", [None], "int64")
        l1, l2 = _linear(P, 8, 16, 1), _linear(P, 16, 4, 2)
        net = P.nn.Sequential(l1, P.nn.ReLU(), l2)
        loss = P.nn.functional.cross_entropy(net(x), lab)
        opt = P.optimizer.SGD(learning_rate=0.2,
                              parameters=net.parameters())
        opt.minimize(loss)
    registered = main.loss is loss and main.optimizer is opt
    exe = S.Executor()
    exe.run(startup)
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 4)).astype("float32")
    xv = rng.standard_normal((64, 8)).astype("float32")
    yv = (xv @ w).argmax(-1)
    losses = [float(exe.run(main, feed={"x": xv, "y": yv},
                            fetch_list=[loss])[0]) for _ in range(15)]
    return registered, np.asarray(losses), _np(l1.weight)


def _training_eager(P):
    """:func:`_training`'s steps as an eager loop: the JAX package's
    reference for them (its Executor replays an integer placeholder's
    build-time zeros, :func:`test_jax_executor_replays_build_time_labels`).
    """
    l1, l2 = _linear(P, 8, 16, 1), _linear(P, 16, 4, 2)
    net = P.nn.Sequential(l1, P.nn.ReLU(), l2)
    opt = P.optimizer.SGD(learning_rate=0.2, parameters=net.parameters())
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 4)).astype("float32")
    xv = rng.standard_normal((64, 8)).astype("float32")
    yv = (xv @ w).argmax(-1)
    x, y = P.to_tensor(xv), P.to_tensor(yv)
    losses = []
    for _ in range(15):
        loss = P.nn.functional.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(np.asarray(loss.numpy())))
    return True, np.asarray(losses), _np(l1.weight)


def _labels_replayed(P):
    """An Executor's cross entropy on fed integer labels, and the eager
    ones on the fed labels and on zeros."""
    S = _S(P)
    rng = np.random.default_rng(13)
    xv = rng.standard_normal((16, 8)).astype("float32")
    yv = rng.integers(1, 4, 16)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [16, 8], "float32")
        lab = S.data("y", [16], "int64")
        lin = _linear(P, 8, 4, 14)
        loss = P.nn.functional.cross_entropy(lin(x), lab)
    got = float(S.Executor().run(main, feed={"x": xv, "y": yv},
                                 fetch_list=[loss])[0])
    ce = P.nn.functional.cross_entropy
    fed = float(np.asarray(ce(lin(P.to_tensor(xv)),
                              P.to_tensor(yv)).numpy()))
    zeros = float(np.asarray(ce(lin(P.to_tensor(xv)),
                                P.to_tensor(np.zeros(16, np.int64))).numpy()))
    return got, fed, zeros


def _clone_for_test(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [2, 2])
        lin = _linear(P, 2, 2, 3)
        loss = lin(x).sum()
        P.optimizer.SGD(learning_rate=0.1,
                        parameters=lin.parameters()).minimize(loss)
    test_prog = main.clone(for_test=True)
    return (test_prog.optimizer is None, test_prog.loss is None,
            "x" in test_prog.placeholders)


def _eager_minimize(P):
    lin = _linear(P, 4, 2, 4)
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    x = P.to_tensor(np.ones((2, 4), "float32"))
    loss = lin(x).sum()
    loss.backward()
    opt.minimize(loss)  # applies the grads backward made
    opt.clear_grad()
    try:
        opt.minimize(lin(x).sum())
        raised = None
    except RuntimeError:
        raised = "RuntimeError"
    return _np(lin.weight), raised


def _save_load_inference(P, path):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [4, 6], "float32")
        y = _linear(P, 6, 3, 5)(x)
    exe = S.Executor()
    S.save_inference_model(path, [x], [y], exe)
    layer, _, _ = S.load_inference_model(path, exe)
    xv = np.random.default_rng(5).standard_normal((4, 6)).astype("float32")
    got = layer(P.to_tensor(xv))
    return _np(got[0] if isinstance(got, (list, tuple)) else got)


def _parameter_free(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [2, 2], "float32")
        y = x * 2.0 + 1.0
    (out,) = S.Executor().run(main, feed={"x": np.full((2, 2), 3.0, "f4")},
                              fetch_list=[y])
    return out


def _loss_position(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [None, 4], "float32")
        lin = _linear(P, 4, 2, 6)
        logits = lin(x)
        loss = logits.sum()
        P.optimizer.SGD(learning_rate=0.01,
                        parameters=lin.parameters()).minimize(loss)
    lv, lg = S.Executor().run(main, feed={"x": np.ones((2, 4), "float32")},
                              fetch_list=[loss, logits])
    return lv, lg


def _minimize_collects(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [None, 4], "float32")
        lin = _linear(P, 4, 2, 7)
        loss = (lin(x) ** 2).sum()
        opt = P.optimizer.SGD(learning_rate=0.01)
        opt.minimize(loss)
    exe = S.Executor()
    xv = np.random.default_rng(8).standard_normal((8, 4)).astype("float32")
    l0 = float(exe.run(main, feed={"x": xv}, fetch_list=[loss])[0])
    for _ in range(5):
        l1 = float(exe.run(main, feed={"x": xv}, fetch_list=[loss])[0])
    return len(opt._parameter_list), l0, l1


def _missing_feed(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        a = S.data("a", [2], "float32")
        b = S.data("b", [2], "float32")
        c = a + b
    try:
        S.Executor().run(main, feed={"a": np.ones(2, "float32")},
                         fetch_list=[c])
    except KeyError as e:
        return "KeyError", str(e)
    return None


def _fetch_by_name(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        S.data("x", [2], "float32")
    return S.Executor().run(main, feed={"x": np.array([1.0, 2.0], "f4")},
                            fetch_list=["x"])[0]


def _caches(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [2], "float32")
        y = x * 3.0
    exe = S.Executor()
    feed = {"x": np.ones(2, "float32")}
    exe.run(main, feed=feed, fetch_list=[y])
    exe.run(main, feed=feed, fetch_list=[y])
    return len(exe._cache)


def _feed_order(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        a = S.data("a", [2], "float32")
        b = S.data("b", [2], "float32")
        c = a - b
    exe = S.Executor()
    av, bv = np.full(2, 5.0, "float32"), np.full(2, 1.0, "float32")
    (r1,) = exe.run(main, feed={"a": av, "b": bv}, fetch_list=[c])
    (r2,) = exe.run(main, feed={"b": bv, "a": av}, fetch_list=[c])
    return r1, r2


def _eval_sees_updates(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [2, 4], "float32")
        lin = _linear(P, 4, 2, 9)
        y = lin(x)
    exe = S.Executor()
    feed = {"x": np.ones((2, 4), "float32")}
    (r1,) = exe.run(main, feed=feed, fetch_list=[y])
    _set(P, lin.weight, _np(lin.weight) + 1.0)
    (r2,) = exe.run(main, feed=feed, fetch_list=[y])
    return r2 - r1


def _save_polymorphic(P, path):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [None, 6], "float32")
        y = _linear(P, 6, 3, 10)(x)
    S.save_inference_model(path, [x], [y], S.Executor())
    layer, _, _ = S.load_inference_model(path, S.Executor())
    xv = np.random.default_rng(11).standard_normal((4, 6)).astype("f4")
    got = layer(P.to_tensor(xv))
    got = got[0] if isinstance(got, (list, tuple)) else got
    return tuple(got.shape), _np(got)


def _parameters_subset(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [None, 4], "float32")
        lin = _linear(P, 4, 2, 12)
        loss = (lin(x) ** 2).sum()
        opt = P.optimizer.SGD(learning_rate=0.5)
        opt.minimize(loss, parameters=[lin.weight])
    subset = opt._parameter_list == [lin.weight]
    b0 = _np(lin.bias).copy()
    S.Executor().run(main, feed={"x": np.ones((2, 4), "float32")},
                     fetch_list=[loss])
    return subset, _np(lin.bias) - b0, _np(lin.weight)


SCENARIOS = {
    "guard": _guard_scoping, "forward": _forward_feed_fetch,
    "training": _training, "clone": _clone_for_test,
    "eager_minimize": _eager_minimize, "parameter_free": _parameter_free,
    "loss_position": _loss_position, "collects": _minimize_collects,
    "missing_feed": _missing_feed, "by_name": _fetch_by_name,
    "caches": _caches, "feed_order": _feed_order,
    "eval_updates": _eval_sees_updates, "subset": _parameters_subset,
}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's results of every scenario, computed once."""
    d = tmp_path_factory.mktemp("jax_static")
    out = {name: fn(pt) for name, fn in SCENARIOS.items()
           if name != "training"}
    out["training"] = _training_eager(pt)
    out["save_load"] = _save_load_inference(pt, str(d / "inf"))
    out["polymorphic"] = _save_polymorphic(pt, str(d / "poly"))
    return out


def _same(got, want):
    """Results equal: arrays within TOL, everything else by ``==``."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, np.generic, float)):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), **TOL)
    else:
        assert got == want, (got, want)


def _twin(jax_ref, name):
    got = SCENARIOS[name](paddle)
    _same(got, jax_ref[name])
    return got


# ---------------------------------------------------------------- twins
def test_program_guard_scoping(jax_ref):
    assert all(_twin(jax_ref, "guard"))


def test_executor_forward_feed_fetch(jax_ref):
    out, out8, n = _twin(jax_ref, "forward")
    assert out8.shape == (8, 2) and n == 2


def test_executor_training_via_minimize(jax_ref):
    """Against the JAX package's eager loop of the same steps (module
    docstring)."""
    registered, losses, _ = _twin(jax_ref, "training")
    assert registered and losses[-1] < losses[0] * 0.7


def test_jax_executor_replays_build_time_labels():
    """A finding of the reference: the JAX package's Executor evaluates a
    cross entropy on the integer placeholder's build-time zeros, not on
    the fed labels (the op reading them records no tape node, so its
    replay reads the build-time value); the port's on the fed labels."""
    jgot, jfed, jzeros = _labels_replayed(pt)
    tgot, tfed, tzeros = _labels_replayed(paddle)
    np.testing.assert_allclose([tfed, tzeros], [jfed, jzeros], **TOL)
    np.testing.assert_allclose(jgot, jzeros, **TOL)
    np.testing.assert_allclose(tgot, tfed, **TOL)
    assert abs(jfed - jzeros) > 0.1


def test_program_clone_for_test_drops_optimizer(jax_ref):
    assert all(_twin(jax_ref, "clone"))


def test_eager_minimize_still_works(jax_ref):
    _, raised = _twin(jax_ref, "eager_minimize")
    assert raised == "RuntimeError"


def test_save_load_inference_model(jax_ref, tmp_path):
    got = _save_load_inference(paddle, str(tmp_path / "inf"))
    np.testing.assert_allclose(got, jax_ref["save_load"], rtol=1e-4,
                               atol=1e-5)


def test_parameter_free_fetch_uses_feed(jax_ref):
    np.testing.assert_allclose(_twin(jax_ref, "parameter_free"),
                               np.full((2, 2), 7.0), rtol=1e-6)


class TestReviewRegressions:
    def test_loss_position_in_fetch_list(self, jax_ref):
        lv, lg = _twin(jax_ref, "loss_position")
        assert lv.shape == () and lg.shape == (2, 2)

    def test_minimize_without_parameters_collects_them(self, jax_ref):
        n, l0, l1 = _twin(jax_ref, "collects")
        assert n == 2 and l1 < l0

    def test_missing_feed_raises(self, jax_ref):
        got = _twin(jax_ref, "missing_feed")
        assert got[0] == "KeyError" and "b" in got[1]

    def test_fetch_by_placeholder_name(self, jax_ref):
        np.testing.assert_allclose(_twin(jax_ref, "by_name"), [1.0, 2.0])

    def test_executor_caches_compiled_steps(self, jax_ref):
        assert _twin(jax_ref, "caches") == 1

    def test_feed_dict_order_irrelevant(self, jax_ref):
        r1, r2 = _twin(jax_ref, "feed_order")
        np.testing.assert_allclose(r1, [4.0, 4.0])
        np.testing.assert_allclose(r2, [4.0, 4.0])

    def test_eval_sees_updated_weights(self, jax_ref):
        np.testing.assert_allclose(_twin(jax_ref, "eval_updates"), 4.0,
                                   rtol=1e-5)

    def test_save_inference_model_polymorphic_batch(self, jax_ref,
                                                    tmp_path):
        shape, got = _save_polymorphic(paddle, str(tmp_path / "poly"))
        assert shape == jax_ref["polymorphic"][0] == (4, 3)
        np.testing.assert_allclose(got, jax_ref["polymorphic"][1],
                                   rtol=1e-4, atol=1e-5)

    def test_minimize_parameters_subset_honored(self, jax_ref):
        subset, moved, _ = _twin(jax_ref, "subset")
        assert subset
        np.testing.assert_array_equal(moved, 0.0)


# ------------------------------------------------------- GPT, Executor
def _flat_jax(jm):
    return np.concatenate([np.asarray(p.numpy()).astype(np.float32).ravel()
                           for p in jm.parameters()])


def _flat_port(tm):
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    out = []
    for n, p in tm.named_parameters():
        a = p.detach().float().numpy()
        out.append((a.T if n in linear else a).ravel())
    return np.concatenate(out)


def test_gpt_tiny_trains_through_an_executor(one_torch_thread):
    """``gpt_tiny`` built as a static Program (``static.data`` ids and
    labels, ``AdamW.minimize``) and run three ``Executor.run`` steps,
    against the JAX package's eager steps from the same weights (its
    Executor reads the labels' build-time zeros): losses and parameters
    within 1e-5."""
    from paddle_tpu.models import GPTForCausalLM as JaxGPT
    from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
    from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                         load_reference_state_dict)

    pt.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    tm = GPTForCausalLM(gpt_tiny(), seed=1, device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 512, (2, 16)) for _ in range(3)]
    jo = pt.optimizer.AdamW(learning_rate=1e-3, epsilon=1e-6,
                            parameters=jm.parameters())
    jl = []
    for ids in batches:
        _, loss = jm(pt.to_tensor(ids),
                     labels=pt.to_tensor(np.roll(ids, -1, 1)))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(np.asarray(loss.numpy())))
    main = static.Program()
    with static.program_guard(main):
        ids = static.data("ids", [None, 16], "int64")
        lab = static.data("lab", [None, 16], "int64")
        _, loss = tm(ids, labels=lab)
        opt = paddle.optimizer.AdamW(learning_rate=1e-3, epsilon=1e-6)
        opt.minimize(loss)
    assert len(opt._parameter_list) == len(list(tm.parameters()))
    exe = static.Executor()
    tl = [float(exe.run(main, feed={"ids": b, "lab": np.roll(b, -1, 1)},
                        fetch_list=[loss])[0]) for b in batches]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(_flat_port(tm), _flat_jax(jm), **TOL)
    assert all(p.grad is None for p in tm.parameters())


# --------------------------------------------- every fetch sees its feed
def test_every_fetch_derived_from_a_feed_changes_with_it():
    """The record's contract: an op that bypassed both op entries would
    replay its build-time value. Over the op families the twins use
    (Linear, activations, reductions, shapes, indexing, casts, detach,
    losses, facade calls, control flow, StaticRNN), two feeds give two
    values of every fetch."""
    paddle.seed(0)
    nn = static.nn
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [4, 6], "float32")
        lab = static.data("lab", [4], "int64")
        h = paddle.nn.Linear(6, 5)(x)
        fetches = {
            "linear": h, "relu": paddle.nn.functional.relu(h),
            "gelu": paddle.nn.functional.gelu(h),
            "softmax": paddle.nn.functional.softmax(h, axis=-1),
            "sum": h.sum(), "mean": paddle.mean(h, axis=0),
            "max": paddle.max(h, axis=1), "reshape": h.reshape([5, 4]),
            "transpose": paddle.transpose(h, [1, 0]),
            "concat": paddle.concat([h, x], axis=1), "slice": x[:, 1:3],
            "matmul": paddle.matmul(x, x, transpose_y=True),
            "cast": x.astype("float64"), "detach": (x * 2.0).detach(),
            "exp": paddle.exp(x), "where": paddle.where(x > 0, x, -x),
            "pow": x ** 2, "ce": paddle.nn.functional.cross_entropy(h, lab),
            "onehot": paddle.nn.functional.one_hot(lab, 5).sum(0),
            "fc": nn.fc(x, 3), "cond": nn.cond(x.sum() > 0,
                                               lambda: x * 2.0,
                                               lambda: x - 1.0),
            "while": nn.while_loop(
                lambda i, v: i < lab.sum(), lambda i, v: [i + 1, v * 1.5],
                [paddle.zeros([], "int64"), x])[1],
            "switch": nn.switch_case(lab[0], [lambda: x + 1.0,
                                              lambda: x * 3.0]),
        }
        rnn = nn.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(shape=[-1, 6], batch_ref=xt, init_value=0.0)
            nxt = prev + xt
            rnn.update_memory(prev, nxt)
            rnn.step_output(nxt)
        fetches["static_rnn"] = rnn()
    exe = static.Executor()
    names = list(fetches)
    rng = np.random.default_rng(0)
    feeds = [{"x": rng.standard_normal((4, 6)).astype("float32"),
              "lab": rng.integers(0, 5, 4)} for _ in range(2)]
    feeds[1]["lab"] = (feeds[0]["lab"] + 1) % 5
    outs = [exe.run(main, feed=f, fetch_list=list(fetches.values()))
            for f in feeds]
    same = [n for n, a, b in zip(names, *outs)
            if np.array_equal(np.asarray(a), np.asarray(b))]
    assert same == [], same


# ------------------------------------------------------------- findings
def _cond_program(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [4], "float32")
        out = S.nn.cond(P.sum(x) > 0, lambda: x * 2.0, lambda: x - 1.0)
    exe = S.Executor()
    return [exe.run(main, feed={"x": np.full(4, v, "float32")},
                    fetch_list=[out])[0] for v in (1.0, -1.0)]


def test_static_cond_takes_the_fed_branch():
    """A finding of the reference: the JAX package's Executor replays the
    branch the build-time zeros took (``x - 1`` for every feed); the port
    dispatches on the fed predicate."""
    jpos, jneg = _cond_program(pt)
    tpos, tneg = _cond_program(paddle)
    np.testing.assert_array_equal(jpos, np.zeros(4))    # stale: 1 - 1
    np.testing.assert_array_equal(jneg, np.full(4, -2.0))
    np.testing.assert_array_equal(tpos, np.full(4, 2.0))  # 1 * 2
    np.testing.assert_array_equal(tneg, np.full(4, -2.0))


def _while_program(P):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        n = S.data("n", [], "int64")
        i, s = S.nn.while_loop(lambda i, s: i < n,
                               lambda i, s: [i + 1, s * 2.0],
                               [P.to_tensor(np.int64(0)),
                                P.to_tensor(np.float32(1.0))])
    exe = S.Executor()
    return [tuple(np.asarray(v).item() for v in exe.run(
        main, feed={"n": np.int64(k)}, fetch_list=[i, s])) for k in (3, 5)]


def test_static_while_loop_runs_the_fed_trip_count():
    """The JAX package's Executor replays the build-time trip count (0);
    the port runs the fed one."""
    assert _while_program(pt) == [(0, 1.0), (0, 1.0)]
    assert _while_program(paddle) == [(3, 8.0), (5, 32.0)]


def _amp_program(P, amp):
    S = _S(P)
    main = S.Program()
    with S.program_guard(main):
        x = S.data("x", [2, 4], "float32")
        w = P.to_tensor(np.full((4, 3), 0.1, np.float32))
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            y = P.matmul(x, w)
    xv = np.full((2, 4), 1.0 / 3, np.float32)
    (out,) = S.Executor().run(main, feed={"x": xv}, fetch_list=[y],
                              return_numpy=False)
    return str(y.dtype), str(out.dtype), np.asarray(out.numpy(), "f4")


def test_amp_casts_replay_as_recorded():
    """A finding of the reference: ``apply_op`` casts under
    ``amp.auto_cast`` but records the uncast function, so the JAX
    package's Executor replays a matmul built under O1 in f32; the port
    replays each op under the amp state it was recorded in (bf16)."""
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp

    jb, jr, jv = _amp_program(pt, jamp)
    tb, tr, tv = _amp_program(paddle, amp)
    assert "bfloat16" in jb and "float32" in jr
    assert "bfloat16" in tb and "bfloat16" in tr
    np.testing.assert_allclose(jv, np.full((2, 3), 0.4 / 3), rtol=1e-6)
    want = (torch.full((2, 4), 1.0 / 3).bfloat16()
            @ torch.full((4, 3), 0.1).bfloat16()).float().numpy()
    np.testing.assert_array_equal(tv, want)
    assert abs(float(tv[0, 0]) - 0.4 / 3) > 1e-4  # rounded through bf16
