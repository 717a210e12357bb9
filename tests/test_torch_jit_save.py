"""``paddle_tpu_torch.jit.save``/``load``/``TranslatedLayer`` on
``torch.export``, against the JAX package's ``jit.save``/``load``.

- A small facade net (``tests/test_inference.py``'s) saved by both
  packages from the same weights: the f32 ``.pdiparams`` hold the same
  names and equal arrays; the port's loaded program equals its eager
  net bit for bit and the JAX package's loaded program within f32
  tolerance (1e-6 atol, 2e-5 rtol: the same two products summed in
  another order), at the traced batch and another (a ``None`` dim).
- The 2-layer narrow GPT: one ``paddle_tpu_torch::flash_fwd`` node (K1)
  per layer in the exported graph, the loaded logits bit for bit the
  eager ones (the same operators in the same order), and within 1e-5 of
  the JAX package's eager logits (``tests/test_torch_gpt.py``'s f32
  tolerance); bf16 weights cross the ``.pdiparams`` bit for bit.
- ``to_static`` forwards and plain functions, nested outputs, and Python
  control flow on tensor values saved through the dy2static pass (its
  cases are ``tests/test_torch_jit_save_control_flow.py``'s).
"""
import io
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.ops import flash_attention as fa
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401


def _net(P):
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = P.nn.Linear(8, 16)
            self.fc2 = P.nn.Linear(16, 3)

        def forward(self, x):
            return self.fc2(P.nn.functional.relu(self.fc1(x)))

    return Net()


@pytest.fixture(scope="module")
def saved_nets(tmp_path_factory):
    """Both packages' nets over the JAX net's weights, each saved."""
    d = tmp_path_factory.mktemp("jit_save")
    pt.seed(7)
    jnet = _net(pt)
    paddle.set_device("cpu")
    try:
        tnet = _net(paddle)
        tnet.set_state_dict({k: np.asarray(v.numpy())
                             for k, v in jnet.state_dict().items()})
    finally:
        paddle.set_device(None)
    for P, net in ((pt, jnet), (paddle, tnet)):
        P.jit.save(net, str(d / P.__name__), input_spec=[
            P.jit.InputSpec([None, 8], "float32", name="feats")])
    return d, jnet, tnet


def test_pdiparams_of_both_packages_hold_the_same_arrays(saved_nets):
    d, _, _ = saved_nets
    files = {}
    for P in (pt, paddle):
        with open(d / f"{P.__name__}.pdiparams", "rb") as f:
            files[P] = pickle.load(f)
    assert list(files[paddle]) == list(files[pt])
    for k, v in files[pt].items():
        got = files[paddle][k]
        assert isinstance(got, np.ndarray) and got.dtype == v.dtype
        assert got.tobytes() == np.asarray(v).tobytes(), k
    with open(d / "paddle_tpu_torch.pdmodel", "rb") as f:
        prog = pickle.load(f)
    assert prog["param_names"] == list(files[pt])
    assert prog["input_names"] == ["feats"]


@pytest.mark.parametrize("rows", [2, 4, 9])
def test_loaded_net_equals_eager_and_the_jax_program(saved_nets, rows):
    d, jnet, tnet = saved_nets
    x = np.random.default_rng(rows).standard_normal((rows, 8)).astype("f4")
    tl = paddle.jit.load(str(d / "paddle_tpu_torch"), device="cpu")
    got = tl(paddle.to_tensor(x, place="cpu"))
    assert isinstance(got, paddle.Tensor)
    eager = tnet(paddle.to_tensor(x, place="cpu")).numpy()
    assert got.numpy().tobytes() == eager.tobytes()
    jl = pt.jit.load(str(d / "paddle_tpu"))
    want = np.asarray(jl(pt.to_tensor(x)).numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)
    assert isinstance(tl, paddle.jit.TranslatedLayer)
    assert sorted(n for n, _ in tl.named_parameters()) == sorted(
        k.replace(".", "__") for k in tnet.state_dict())


def test_the_port_reads_a_jax_written_pdiparams(saved_nets):
    from paddle_tpu_torch.jit.save_load import load_params

    d, jnet, _ = saved_nets
    got = load_params(str(d / "paddle_tpu.pdiparams"))
    for k, v in jnet.state_dict().items():
        assert torch.equal(got[k], torch.from_numpy(np.array(v.numpy())))


@pytest.fixture(scope="module")
def gpt_pair():
    pt.seed(0)
    jm = JaxGPT(jax_gpt_tiny(hidden_size=64, num_heads=2))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(hidden_size=64, num_heads=2),
                        device="cpu", seed=1)
    load_reference_state_dict(tm, {k: np.asarray(v.numpy())
                                   for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


def _flash_nodes(prefix):
    with open(prefix + ".pdmodel", "rb") as f:
        prog = pickle.load(f)
    ep = torch.export.load(io.BytesIO(prog["exported"]))
    return [n for n in ep.graph.nodes
            if n.op == "call_function"
            and "paddle_tpu_torch.flash_fwd" in str(n.target)]


def test_gpt_exports_k1_per_layer_and_reloads_bit_for_bit(gpt_pair,
                                                          tmp_path):
    jm, tm = gpt_pair
    prefix = str(tmp_path / "gpt")
    paddle.jit.save(tm, prefix, input_spec=[
        paddle.jit.InputSpec([None, 16], "int64", name="input_ids")])
    assert len(_flash_nodes(prefix)) == tm.config.num_layers == 2
    tl = paddle.jit.load(prefix, device="cpu")
    for B in (3, 2):
        ids = np.random.default_rng(B).integers(0, 512, (B, 16))
        with torch.no_grad():
            eager = tm(torch.from_numpy(ids))
        fa.reset_counters()
        got = tl(ids)
        assert fa.plain_calls["flash_fwd"] == 2
        assert isinstance(got, torch.Tensor) and torch.equal(got, eager)
        want = np.asarray(jm(pt.to_tensor(ids)).numpy())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_weights_cross_the_pdiparams_bit_for_bit(tmp_path):
    from paddle_tpu_torch.jit.save_load import load_params

    tm = GPTForCausalLM(gpt_tiny(hidden_size=64, num_heads=2, num_layers=1),
                        device="cpu", seed=3, dtype=torch.bfloat16)
    prefix = str(tmp_path / "bf16")
    paddle.jit.save(tm, prefix, input_spec=[
        paddle.jit.InputSpec([None, 8], "int64")])
    got = load_params(prefix + ".pdiparams")
    for k, v in tm.state_dict().items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    tl = paddle.jit.load(prefix, device="cpu")
    assert {p._value.dtype for p in tl.parameters()} == {
        v.dtype for v in tm.state_dict().values()}
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 8)))
    with torch.no_grad():
        assert torch.equal(tl(ids), tm(ids))


def test_to_static_forward_and_plain_functions(tmp_path):
    paddle.set_device("cpu")
    try:
        paddle.seed(1)
        net = _net(paddle)
        x = np.random.default_rng(0).standard_normal((5, 8)).astype("f4")
        eager = net(paddle.to_tensor(x)).numpy()
        paddle.jit.to_static(net, input_spec=[
            paddle.jit.InputSpec([None, 8], "float32", name="x")])
        paddle.jit.save(net, str(tmp_path / "static"))
        got = paddle.jit.load(str(tmp_path / "static"), device="cpu")(x)
        assert got.numpy().tobytes() == eager.tobytes()

        def fn(a, b):
            return {"sum": a + b, "pair": (a * b, a - b)}

        paddle.jit.save(fn, str(tmp_path / "fn"), input_spec=[
            paddle.jit.InputSpec([None, 3], "float32"),
            paddle.jit.InputSpec([None, 3], "float32")])
        a = torch.ones(4, 3)
        b = torch.full((4, 3), 2.0)
        out = paddle.jit.load(str(tmp_path / "fn"), device="cpu")(a, b)
        assert set(out) == {"sum", "pair"}
        assert torch.equal(out["sum"], a + b)
        assert torch.equal(out["pair"][0], a * b)
        assert torch.equal(out["pair"][1], a - b)
    finally:
        paddle.set_device(None)


def test_control_flow_on_tensor_values_is_refused(tmp_path):
    """Python control flow on tensor values goes through the dy2static
    pass into a ``cond`` node: the loaded program takes each branch as the
    JAX package's loaded program does. A save without ``input_spec`` is
    still refused, and writes nothing."""
    def branchy(x):
        if x.sum() > 0:
            return x * 2
        return x

    for P in (paddle, pt):
        P.jit.save(branchy, str(tmp_path / P.__name__), input_spec=[
            P.jit.InputSpec([2, 3], "float32")])
    tl = paddle.jit.load(str(tmp_path / "paddle_tpu_torch"), device="cpu")
    jl = pt.jit.load(str(tmp_path / "paddle_tpu"))
    for v in (1.0, -1.0):
        x = np.full((2, 3), v, "f4")
        got = tl(x).numpy()
        assert got.tobytes() == (x * 2 if v > 0 else x).tobytes()
        np.testing.assert_array_equal(got, np.asarray(
            jl(pt.to_tensor(x)).numpy()))
    with pytest.raises(ValueError, match="input_spec"):
        paddle.jit.save(branchy, str(tmp_path / "b"))
    assert not os.path.exists(str(tmp_path / "b.pdmodel"))
