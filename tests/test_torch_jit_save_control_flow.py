"""``jit.save`` of tensor control flow: ``static.nn``'s ``cond``, ``case``,
``switch_case``, ``while_loop`` and ``StaticRNN``, and dy2static's ``if``,
``while`` and ``for range(tensor)``, each saved by both packages from the
same weights and loaded back.

Each construct is a node of the port's exported program (``cond`` for the
branches, nested for ``case``/``switch_case``; ``while_loop`` for the
loops and ``StaticRNN``). The loaded program is called on inputs that
take every branch and several trip counts (zero among them): it equals
the port's eager forward bit for bit and the JAX package's loaded program
within 1e-5 (rtol and atol, f32). A forward whose control flow the pass
cannot convert raises ``ValueError`` naming its source line; with
``PADDLE_TPU_DY2STATIC=0`` the pass is off and the tensor ``if`` is
refused the same way. The JAX package's programs are saved, loaded and
run once, in a module fixture.
"""
import io
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.jit.dy2static import ast_transform
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import state_of
from torch_suite import one_torch_thread  # noqa: F401


def _snn(P):
    from importlib import import_module

    return import_module(P.__name__ + ".static.nn")


def _f32(*shape, v=1.0):
    return np.full(shape, v, np.float32)


def _cond(P):
    class M(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 4)

        def forward(self, x):
            return _snn(P).cond(x.sum() > 0, lambda: self.fc(x),
                                lambda: x * 2.0 - 1.0)

    return M(), [P.jit.InputSpec([2, 4], "float32")], [
        [_f32(2, 4)], [_f32(2, 4, v=-1.0)], [_f32(2, 4, v=0.5)]]


def _case(P):
    class M(P.nn.Layer):
        def forward(self, a, x):
            return _snn(P).case([(a > 3, lambda: x + 100.0),
                                 (a > 1, lambda: x + 10.0)],
                                default=lambda: x * 1.0)

    return M(), [P.jit.InputSpec([], "float32"),
                 P.jit.InputSpec([3], "float32")], [
        [np.float32(a), _f32(3)] for a in (0.0, 2.0, 5.0, 1.5, 4.0)]


def _switch(P):
    class M(P.nn.Layer):
        def forward(self, i, v):
            return _snn(P).switch_case(i, [lambda: v * 1.0,
                                           lambda: v * 10.0,
                                           lambda: v * 20.0])

    return M(), [P.jit.InputSpec([], "int64"),
                 P.jit.InputSpec([2], "float32")], [
        [np.int64(i), _f32(2)] for i in (0, 1, 2, 7)]


def _while(P):
    class M(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(3, 3)

        def forward(self, x, n):
            i0 = P.zeros([], dtype="int64")
            i, v = _snn(P).while_loop(lambda i, v: i < n,
                                      lambda i, v: [i + 1, P.tanh(
                                          self.fc(v))], [i0, x])
            return v, i

    return M(), [P.jit.InputSpec([2, 3], "float32"),
                 P.jit.InputSpec([], "int64")], [
        [_f32(2, 3, v=0.3), np.int64(n)] for n in (0, 1, 4)]


def _rnn(P):
    class M(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 4)

        def forward(self, x):
            rnn = _snn(P).StaticRNN()
            with rnn.step():
                xt = rnn.step_input(x)
                prev = rnn.memory(shape=[-1, 4], batch_ref=xt,
                                  init_value=0.0)
                h = P.tanh(self.fc(prev) + xt)
                rnn.update_memory(prev, h)
                rnn.step_output(h)
            return rnn()

    x = np.random.default_rng(1).standard_normal((5, 3, 4)).astype("f4")
    return M(), [P.jit.InputSpec([5, 3, 4], "float32")], [[x], [-x]]


def _dy_if(P):
    class M(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = P.nn.Linear(4, 4)
            self.b = P.nn.Linear(4, 4)

        def forward(self, x):
            if x.sum() > 0:
                y = self.a(x)
            else:
                y = self.b(x)
            return y

    return M(), [P.jit.InputSpec([2, 4], "float32")], [
        [_f32(2, 4)], [_f32(2, 4, v=-1.0)]]


def _dy_while(P):
    class M(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(2, 2)

        def forward(self, x, n):
            i = P.zeros([], dtype="int64")
            s = x
            while i < n:
                if (i % 2) == 0:
                    s = s * 0.5 + self.fc(s)
                else:
                    s = s - 1.0
                i = i + 1
            return s, i

    return M(), [P.jit.InputSpec([2], "float32"),
                 P.jit.InputSpec([], "int64")], [
        [_f32(2), np.int64(n)] for n in (0, 3, 4)]


def _dy_for(P):
    class M(P.nn.Layer):
        def forward(self, x, n):
            s = x
            for k in range(n):
                s = s * 2.0 + k
            return s

    return M(), [P.jit.InputSpec([2], "float32"),
                 P.jit.InputSpec([], "int64")], [
        [_f32(2), np.int64(n)] for n in (0, 1, 5)]


CASES = {"cond": (_cond, {"cond": 1}), "case": (_case, {"cond": 2}),
         "switch_case": (_switch, {"cond": 3}),
         "while_loop": (_while, {"while_loop": 1}),
         "static_rnn": (_rnn, {"while_loop": 1}),
         "dy_if": (_dy_if, {"cond": 1}),
         "dy_while": (_dy_while, {"while_loop": 1, "cond": 1}),
         "dy_for": (_dy_for, {"while_loop": 1})}


def _flat(out):
    out = out if isinstance(out, (list, tuple)) else [out]
    return [np.asarray(o.numpy()) for o in out]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Every case built by both packages over the JAX layer's weights,
    each saved; the JAX package's loaded outputs on every input."""
    d = tmp_path_factory.mktemp("jit_cf")
    out = {}
    for name, (make, _) in CASES.items():
        pt.seed(0)
        jm, jspec, inputs = make(pt)
        paddle.set_device("cpu")
        try:
            tm, tspec, _ = make(paddle)
            tm.set_state_dict(state_of(jm))
            paddle.jit.save(tm, str(d / f"{name}_port"), input_spec=tspec)
        finally:
            paddle.set_device(None)
        pt.jit.save(jm, str(d / f"{name}_jax"), input_spec=jspec)
        jl = pt.jit.load(str(d / f"{name}_jax"))
        want = [_flat(jl(*[pt.to_tensor(a) for a in xs])) for xs in inputs]
        out[name] = (str(d / f"{name}_port"), tm, inputs, want)
    return out


def _hops(prefix):
    """Higher-order nodes of a saved program, by name, through the
    subgraphs of branches and bodies."""
    with open(prefix + ".pdmodel", "rb") as f:
        prog = pickle.load(f)
    ep = torch.export.load(io.BytesIO(prog["exported"]))
    count = {}
    for _, gm in ep.graph_module.named_modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for n in gm.graph.nodes:
            if n.op == "call_function" and isinstance(
                    n.target, torch._ops.HigherOrderOperator):
                count[n.target.name()] = count.get(n.target.name(), 0) + 1
    return count


@pytest.mark.parametrize("name", sorted(CASES))
def test_construct_is_a_node_of_the_program(saved, name):
    assert _hops(saved[name][0]) == CASES[name][1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_loaded_program_matches_eager_and_the_jax_program(saved, name):
    prefix, tm, inputs, want = saved[name]
    tl = paddle.jit.load(prefix, device="cpu")
    # the eager forward as dy2static converts it (its concrete regime:
    # Python's branch and loop on the CPU)
    fwd = ast_transform(tm.forward)
    for xs, w in zip(inputs, want):
        got = _flat(tl(*xs))
        with torch.no_grad():
            eager = _flat(fwd(*[paddle.to_tensor(a) for a in xs]))
        assert len(got) == len(w) == len(eager)
        for g, e, j in zip(got, eager, w):
            assert g.dtype == e.dtype and g.tobytes() == e.tobytes(), name
            np.testing.assert_allclose(g, j.astype(g.dtype), rtol=1e-5,
                                       atol=1e-5)


def test_unconvertible_control_flow_names_its_line(tmp_path):
    def host_read(x):
        if bool(x.sum() > 0):
            return x * 2.0
        return x

    with pytest.raises(ValueError, match=r"if bool\(x.sum\(\) > 0\):"):
        paddle.jit.save(host_read, str(tmp_path / "h"), input_spec=[
            paddle.jit.InputSpec([2, 3], "float32")])


def test_dy2static_off_refuses_the_tensor_if(tmp_path, monkeypatch):
    def branchy(x):
        if x.sum() > 0:
            return x * 2
        return x

    monkeypatch.setenv("PADDLE_TPU_DY2STATIC", "0")
    with pytest.raises(ValueError, match=r"if x.sum\(\) > 0:"):
        paddle.jit.save(branchy, str(tmp_path / "b"), input_spec=[
            paddle.jit.InputSpec([2, 3], "float32")])
