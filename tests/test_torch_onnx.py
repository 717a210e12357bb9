"""``paddle_tpu_torch.onnx`` against the JAX package's ``paddle_tpu.onnx``:
a twin of every test of ``tests/test_onnx_export.py`` and of
``test_misc_families.py::TestHubOnnx::test_onnx_export_writes_model``,
with the structure checks on the port's file (I/O counts and names,
``Loop`` body ops and I/O counts, the passthrough carry produced inside
the body, ``dim_param``, the errors).

Both packages' files are also evaluated by ``tools/onnx_eval.py`` on the
same inputs: each agrees with the JAX model's eager output within 1e-5 by
norm (f32), and next tokens are equal, for the MLP, LeNet, tiny GPT's and
tiny Llama's decode steps (four steps, the caches fed back), a
``while_loop`` and a ``StaticRNN``. The port's op types are a subset of
the JAX converter's. A ``cond`` node and K1's ``flash_fwd`` raise
``NotImplementedError`` naming them. The JAX side of each case runs once,
in a module fixture.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch import onnx
from paddle_tpu_torch.onnx import wire
from paddle_tpu_torch.onnx.convert import JAX_OP_TYPES
from paddle_tpu_torch.tools import onnx_eval
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import state_of
from torch_suite import one_torch_thread  # noqa: F401


def _graph(path):
    model = wire.read_message(open(path, "rb").read())
    return model, wire.read_message(model[7][0])


def _ops(graph):
    return [wire.read_message(n)[4][0].decode() for n in graph[1]]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _evaluate(path, xs):
    g = onnx_eval.load(path)
    return onnx_eval.run(g, dict(zip(g.inputs, xs))), g


def _np(t):
    return np.asarray(t.numpy())


# ------------------------------------------------------------- the nets
def _mlp(P):
    nn = P.nn
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def _lenet(P):
    nn = P.nn
    return nn.Sequential(nn.Conv2D(1, 6, 5, padding=2), nn.ReLU(),
                         nn.MaxPool2D(2, 2), nn.Flatten(),
                         nn.Linear(6 * 14 * 14, 10))


def _counter(P):
    from importlib import import_module

    snn = import_module(P.__name__ + ".static.nn")

    class Counter(P.nn.Layer):
        def forward(self, x):
            i0 = P.to_tensor(np.int32(0))
            _, v = snn.while_loop(lambda i, v: i < 4,
                                  lambda i, v: [i + 1, v * 1.5 + 0.1],
                                  [i0, x])
            return v

    return Counter()


def _passthrough(P):
    from importlib import import_module

    snn = import_module(P.__name__ + ".static.nn")

    class M(P.nn.Layer):
        def forward(self, x):
            i0 = P.to_tensor(np.int32(0))
            _, v = snn.while_loop(lambda i, v: i < 3,
                                  lambda i, v: [i + 1, v], [i0, x])
            return v

    return M()


def _rnn(P):
    from importlib import import_module

    snn = import_module(P.__name__ + ".static.nn")

    class RNN(P.nn.Layer):
        def forward(self, x):
            rnn = snn.StaticRNN()
            with rnn.step():
                xt = rnn.step_input(x)
                prev = rnn.memory(shape=[-1, 4], batch_ref=xt,
                                  init_value=0.0)
                h = prev + xt
                rnn.update_memory(prev, h)
                rnn.step_output(h)
            return rnn()

    return RNN()


NETS = {"mlp": (_mlp, (2, 8)), "lenet": (_lenet, (1, 1, 28, 28)),
        "while": (_counter, (3,)), "passthrough": (_passthrough, (2,)),
        "rnn": (_rnn, (5, 3, 4))}


def _inputs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype("f4")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each net in both packages over the JAX net's weights, exported by
    each; the JAX net's eager output."""
    d = tmp_path_factory.mktemp("onnx")
    out = {}
    paddle.set_device("cpu")
    try:
        for name, (make, shape) in NETS.items():
            pt.seed(0)
            jnet = make(pt)
            tnet = make(paddle)
            tnet.set_state_dict(state_of(jnet))
            x = _inputs(shape)
            files = {}
            for P, net in ((pt, jnet), (paddle, tnet)):
                files[P] = P.onnx.export(
                    net, str(d / f"{name}_{P.__name__}"),
                    input_spec=[P.to_tensor(x)])
            out[name] = (files, x, _np(jnet(pt.to_tensor(x))), tnet)
    finally:
        paddle.set_device(None)
    return out


@pytest.mark.parametrize("name", sorted(NETS))
def test_both_files_evaluate_to_the_jax_eager_output(exported, name):
    files, x, want, tnet = exported[name]
    for P, path in files.items():
        (got,), g = _evaluate(path, [x])
        assert got.shape == want.shape and _rel(got, want) <= 1e-5, P
        assert got.dtype == want.dtype
    ops = onnx_eval.load(files[paddle]).op_types()
    assert set(ops) <= JAX_OP_TYPES, set(ops) - JAX_OP_TYPES


def test_mlp_export_structure(exported):
    p = exported["mlp"][0][paddle]
    assert p.endswith(".onnx")
    model, graph = _graph(p)
    assert model[1][0] == 8
    assert model[2][0] == b"paddle-tpu"
    ops = _ops(graph)
    assert ops.count("MatMul") == 2 and "Max" in ops
    inits = [wire.read_message(t) for t in graph[5]]
    shapes = [tuple(onnx_eval._varints(i[1][0])) for i in inits if 1 in i]
    assert (16, 8) in shapes and (4, 16) in shapes or \
        (8, 16) in shapes and (16, 4) in shapes
    assert len(graph[11]) == 1 and len(graph[12]) == 1


def test_lenet_export_has_conv_and_pool(exported):
    _, graph = _graph(exported["lenet"][0][paddle])
    ops = _ops(graph)
    assert "Conv" in ops and "MaxPool" in ops and "MatMul" in ops
    conv = next(wire.read_message(n) for n in graph[1]
                if wire.read_message(n)[4][0] == b"Conv")
    attr_names = {wire.read_message(a)[1][0].decode() for a in conv[5]}
    assert {"strides", "pads", "group"} <= attr_names


def test_unmapped_primitive_raises_loudly(tmp_path):
    class Weird(paddle.nn.Layer):
        def forward(self, x):
            return paddle.linalg.cholesky(x)

    with pytest.raises(NotImplementedError, match="primitive"):
        onnx.export(Weird(), str(tmp_path / "w"),
                    input_spec=[paddle.to_tensor(np.eye(3, dtype="f4"))])


def test_cond_and_k1_raise_naming_them(tmp_path):
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.static import nn as snn

    class Branch(paddle.nn.Layer):
        def forward(self, x):
            return snn.cond(x.sum() > 0, lambda: x * 2.0, lambda: x - 1.0)

    with pytest.raises(NotImplementedError, match="'cond'"):
        onnx.export(Branch(), str(tmp_path / "c"),
                    input_spec=[paddle.to_tensor(np.ones(3, "f4"))])

    class K1(paddle.nn.Layer):
        def forward(self, q):
            return paddle.Tensor._wrap(fa.flash_attention_bshd(
                q._value, q._value, q._value, causal=True))

    with pytest.raises(NotImplementedError, match="flash_fwd"):
        onnx.export(K1(), str(tmp_path / "k"), input_spec=[
            paddle.to_tensor(np.ones((1, 8, 2, 32), "f4"))])
    assert not os.path.exists(str(tmp_path / "k.onnx"))


def test_export_requires_input_spec(tmp_path):
    with pytest.raises(ValueError):
        onnx.export(paddle.nn.Linear(2, 2), str(tmp_path / "x"))


def test_weight_norm_hooks_run_during_export(tmp_path):
    paddle.seed(0)
    lin = paddle.nn.Linear(4, 4)
    wn = paddle.nn.utils.weight_norm(lin)
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    want = _np(wn(paddle.to_tensor(x)))
    with paddle.no_grad():
        g = lin.weight_g
        g._value.mul_(2.0)
    want2 = _np(wn(paddle.to_tensor(x)))
    assert not np.allclose(want, want2)
    p = onnx.export(wn, str(tmp_path / "wn"),
                    input_spec=[paddle.to_tensor(x)])
    (got,), _ = _evaluate(p, [x])
    assert _rel(got, want2) <= 1e-6


def test_opset_below_18_rejected(tmp_path):
    with pytest.raises(NotImplementedError, match="opset"):
        onnx.export(paddle.nn.Linear(2, 2), str(tmp_path / "x"),
                    input_spec=[paddle.to_tensor(np.zeros((1, 2), "f4"))],
                    opset_version=9)


def test_input_spec_none_dims_are_dim_params(tmp_path):
    paddle.seed(5)
    lin = paddle.nn.Linear(4, 2)
    p = onnx.export(lin, str(tmp_path / "dyn"), input_spec=[
        paddle.jit.InputSpec([None, 4], "float32", name="feats")])
    _, graph = _graph(p)
    vi = wire.read_message(graph[11][0])
    assert vi[1][0] == b"feats"
    shape = wire.read_message(wire.read_message(wire.read_message(
        vi[2][0])[1][0])[2][0])
    dims = [wire.read_message(d) for d in shape[1]]
    assert dims[0] == {2: [b"N"]} and dims[1] == {1: [4]}
    x = _inputs((1, 4))
    (got,), _ = _evaluate(p, [x])
    np.testing.assert_allclose(got, _np(lin(paddle.to_tensor(x))),
                               rtol=1e-6, atol=1e-6)


def test_onnx_export_writes_model(tmp_path):
    from paddle_tpu_torch.jit import InputSpec

    paddle.seed(5)
    lin = paddle.nn.Linear(4, 2)
    out = paddle.onnx.export(lin, str(tmp_path / "model"),
                             input_spec=[InputSpec((2, 4), "float32")])
    assert out.endswith(".onnx") and os.path.exists(out)
    assert os.path.getsize(out) > 50


def test_mobilenet_v2_exports_52_convs(tmp_path):
    """The JAX test's model at 64 x 64 (its file has 719 nodes: the port's
    spells batch norm and ReLU6 in the same op set with another count).
    The file evaluates to the port's eager logits, which the zoo tests
    hold to the JAX model's."""
    from paddle_tpu_torch.vision.models import mobilenet_v2

    paddle.seed(0)
    net = mobilenet_v2()
    net.eval()
    x = _inputs((1, 3, 64, 64), seed=2)
    p = onnx.export(net, str(tmp_path / "mbv2"),
                    input_spec=[paddle.to_tensor(x)])
    _, graph = _graph(p)
    ops = _ops(graph)
    assert ops.count("Conv") == 52 and set(ops) <= JAX_OP_TYPES
    (got,), _ = _evaluate(p, [x])
    assert _rel(got, _np(net(paddle.to_tensor(x)))) <= 1e-5


# --------------------------------------------------------------- decode
def _jax_step(jm, tok, cur, caches):
    n = len(caches) // 2
    cs = [(pt.to_tensor(caches[2 * i]), pt.to_tensor(caches[2 * i + 1]))
          for i in range(n)]
    with pt.no_grad():
        hidden, ncs = jm._decode_trunk()(pt.to_tensor(tok), caches=cs,
                                         cur_len=pt.to_tensor(np.int32(cur)))
        logits = _np(jm.logits(hidden))
    return (int(np.argmax(logits[:, -1, :].astype("f4"), -1)[0]),
            [_np(t) for c in ncs for t in c])


def _decode_pair(kind):
    from paddle_tpu.models import GPTForCausalLM as JG
    from paddle_tpu.models import LlamaForCausalLM as JL
    from paddle_tpu.models import gpt_tiny as jgt
    from paddle_tpu.models import llama_tiny as jlt
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny,
                                         load_reference_state_dict)

    pt.seed(0)
    if kind == "gpt":
        jm = JG(jgt(max_position_embeddings=32))
        tm = GPTForCausalLM(gpt_tiny(max_position_embeddings=32),
                            device="cpu", seed=0)
    else:
        jm = JL(jlt())
        tm = LlamaForCausalLM(llama_tiny(), device="cpu", seed=0)
    jm.eval()
    load_reference_state_dict(tm, {k: np.asarray(v.numpy())
                                   for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture(scope="module", params=["gpt", "llama"])
def decode_files(request, tmp_path_factory):
    kind = request.param
    d = tmp_path_factory.mktemp(f"decode_{kind}")
    jm, tm = _decode_pair(kind)
    files = {pt: pt.onnx.export_decode(jm, str(d / "jax"), batch=1),
             paddle: onnx.export_decode(tm, str(d / "port"), batch=1)}
    n_layers, heads, hd = tm._cache_spec()
    total = tm.config.max_position_embeddings
    caches = [np.zeros((1, total, heads, hd), np.float32)
              for _ in range(2 * n_layers)]
    steps, tok = [], np.array([[5]], np.int64)
    for cur in range(4):
        nxt, new = _jax_step(jm, tok, cur, caches)
        steps.append((tok, cur, caches, nxt, new))
        caches, tok = new, np.array([[nxt]], np.int64)
    return kind, files, n_layers, steps


def test_decode_step_structure(decode_files):
    kind, files, n_layers, _ = decode_files
    _, graph = _graph(files[paddle])
    ops = _ops(graph)
    assert len(graph[11]) == 2 + 2 * n_layers
    assert len(graph[12]) == 1 + 2 * n_layers
    names = [wire.read_message(v)[1][0].decode() for v in graph[11]]
    assert names[:4] == ["tokens", "cur_len", "past_k_0", "past_v_0"]
    assert "ArgMax" in ops and "ScatterND" in ops
    if kind == "llama":
        assert "Sin" in ops and "Gather" in ops
    assert set(onnx_eval.load(files[paddle]).op_types()) <= JAX_OP_TYPES


def test_decode_steps_evaluate_to_the_jax_eager_step(decode_files):
    _, files, _, steps = decode_files
    for P, path in files.items():
        g = onnx_eval.load(path)
        caches = steps[0][2]
        for tok, cur, _, nxt, new in steps:
            out = onnx_eval.run(g, dict(zip(g.inputs, [
                tok, np.int32(cur)] + list(caches))))
            assert int(out[0].reshape(-1)[0]) == nxt, (P, cur)
            assert max(_rel(a, b) for a, b in zip(out[1:], new)) <= 1e-5
            caches = out[1:]


# ---------------------------------------------------------- while loops
def _loop_body(path):
    _, graph = _graph(path)
    for n in graph[1]:
        nd = wire.read_message(n)
        if nd[4][0].decode() == "Loop":
            body = wire.read_message(wire.read_message(nd[5][0])[6][0])
            return body
    return None


def test_while_loop_exports_as_onnx_loop(exported):
    p = exported["while"][0][paddle]
    assert "Loop" in _ops(_graph(p)[1])
    body = _loop_body(p)
    body_ops = [wire.read_message(bn)[4][0].decode() for bn in body[1]]
    assert "Mul" in body_ops and "Less" in body_ops
    assert len(body[11]) == 2 + 2 and len(body[12]) == 1 + 2


def test_static_rnn_exports_as_onnx_loop(exported):
    """The port's StaticRNN is one while_loop carrying the step, the
    memory and the stacked output: iter + cond + three carries in, cond +
    three carries out (the JAX file's scan carries one and scans one)."""
    body = _loop_body(exported["rnn"][0][paddle])
    body_ops = [wire.read_message(bn)[4][0].decode() for bn in body[1]]
    assert "Gather" in body_ops and "Add" in body_ops
    assert "ScatterND" in body_ops
    assert len(body[11]) == 2 + 3 and len(body[12]) == 1 + 3


def test_while_loop_passthrough_carry_body_output_is_produced(exported):
    body = _loop_body(exported["passthrough"][0][paddle])
    produced = set()
    for bn in body[1]:
        for o in wire.read_message(bn).get(2, []):
            produced.add(o.decode())
    outs = [wire.read_message(o)[1][0].decode() for o in body[12]]
    assert all(o in produced for o in outs), (outs, produced)


# ------------------------------------------------------------- to_static
def test_export_to_static_wrapped_layer(tmp_path):
    class M(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = paddle.nn.Linear(8, 4)

        def forward(self, x):
            return paddle.nn.functional.relu(self.fc(x))

    m = paddle.jit.to_static(M())
    x = paddle.to_tensor(_inputs((2, 8)))
    want = _np(m(x))
    assert hasattr(m.forward, "dygraph_function")
    path = onnx.export(m, str(tmp_path / "m"), input_spec=[x])
    (got,), _ = _evaluate(path, [_np(x)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert hasattr(m.forward, "dygraph_function")


def test_export_to_static_layer_runs_pre_hooks(tmp_path):
    class M(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = paddle.nn.utils.weight_norm(paddle.nn.Linear(8, 4))

        def forward(self, x):
            return self.fc(x)

    m = M()
    x = paddle.to_tensor(_inputs((2, 8), seed=1))
    want = _np(m(x))
    with paddle.no_grad():
        m.fc.weight_g._value.mul_(2.0)
    want2 = _np(m(x))
    assert not np.allclose(want, want2)
    m2 = paddle.jit.to_static(m)
    m2(x)
    path = onnx.export(m2, str(tmp_path / "wn"), input_spec=[x])
    (got,), _ = _evaluate(path, [_np(x)])
    np.testing.assert_allclose(got, want2, rtol=1e-6, atol=1e-6)
    assert hasattr(m2.forward, "dygraph_function")


def test_export_to_static_bare_function(tmp_path):
    w = paddle.to_tensor(_inputs((8, 4), seed=2))

    @paddle.jit.to_static
    def f(x):
        return paddle.matmul(x, w)

    x = paddle.to_tensor(_inputs((2, 8), seed=3))
    want = _np(f(x))
    path = onnx.export(f, str(tmp_path / "fn"), input_spec=[x])
    (got,), _ = _evaluate(path, [_np(x)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))


def test_export_decode_keeps_the_models_mode(tmp_path):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

    m = GPTForCausalLM(gpt_tiny(max_position_embeddings=16, num_layers=1),
                       device="cpu", seed=0)
    for training in (False, True):
        m.train(training)
        onnx.export_decode(m, str(tmp_path / f"d{training}"))
        assert m.training is training


def test_wire_writes_the_jax_packages_bytes():
    """The copied writer emits the JAX package's bytes for the same
    messages, but a 0-d constant, which keeps its 0-d shape (the JAX copy
    writes it as ``[1]``); the reader is the same."""
    from paddle_tpu.onnx import wire as jwire

    for a in (np.arange(6, dtype=np.float32).reshape(2, 3),
              np.array([True, False]), np.arange(5, dtype=np.int64),
              np.zeros((0,), np.float32)):
        assert wire.tensor_proto("t", a) == jwire.tensor_proto("t", a)
    g = [m.graph_proto("g", [m.node_proto("Add", ["a", "b"], ["c"])],
                       [m.value_info("a", np.float32, [None, 3])], [],
                       [m.tensor_proto("b", np.ones(3, np.float32))])
         for m in (wire, jwire)]
    assert g[0] == g[1]
    assert wire.model_proto(g[0]) == jwire.model_proto(g[1])
    scalar = wire.read_message(wire.tensor_proto("s", np.float32(3.0)))
    assert scalar[1] == [b""] and jwire.read_message(jwire.tensor_proto(
        "s", np.float32(3.0)))[1] == [b"\x01"]
    assert wire.read_message(g[0]) == jwire.read_message(g[1])
