"""``paddle_tpu_torch.quantization`` against the JAX package's
(``paddle_tpu/quantization/__init__.py``): the fake quanter, QAT and PTQ
on the JAX test file's nets (``tests/test_quantization.py``), the layer
routing, and QAT and PTQ on the 2-layer GPT.

Inputs come from seeded numpy; weights cross with ``set_state_dict``
(``twin``) or ``load_reference_state_dict`` (GPT). Tolerances, f32:
fake-quantized values, outputs and the straight-through gradients 1e-5
(atol = rtol; the same rounding of the same f32 quotients: values on the
int8 grid agree exactly unless a quotient lies within an ulp of a
half, so a few elements may be one grid step apart, which 1e-5 would
show); PTQ's deploy outputs 1e-5; the GPT's loss, logits and weight
gradients 2e-5 (the same f32 math summed in another order, as
``tests/test_torch_gpt.py``'s 1e-5, through two more roundings).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     load_reference_state_dict)
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import one_thread, twin  # noqa: F401

TOL = 1e-5


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 4))


def _x(n=4, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 8)).astype("f4")


def _qat(P, net, **cfg):
    net.train()
    Q = P.quantization
    return Q.QAT(Q.QuantConfig(**cfg)).quantize(net)


def _both_quanters():
    return {"activation": "fq", "weight": "fq"}


def _cfg(P, spec):
    Q = P.quantization
    make = {"fq": Q.FakeQuanterWithAbsMaxObserver, "absmax": Q.AbsmaxObserver}
    return {k: (make[v]() if v else None) for k, v in spec.items()}


@pytest.mark.parametrize("rate", [0.0, 0.9])
def test_fake_quanter_values_grid_and_ste_gradient(rate):
    """The JAX test file's fake-quant cases in both packages: the values
    on the int8 grid of the observed scale, the error within a step, and
    the straight-through gradient (1 inside the range, 0 outside)."""
    xv = np.random.default_rng(2).uniform(-2, 2, 64).astype("f4")
    xv[:3] = [0.1, -0.5, 0.9]
    res = {}
    for P in (pt, paddle):
        q = P.quantization.FakeQuanterWithAbsMaxObserver(moving_rate=rate)
        q.train()
        x = P.to_tensor(xv, stop_gradient=False)
        out = q(x)
        (out * P.to_tensor(np.linspace(-1, 1, 64).astype("f4"))).sum(
            ).backward()
        res[P] = (np.asarray(out.numpy()), float(q.scales().numpy()),
                  np.asarray(x.grad.numpy()))
    (jo, js, jg), (to, ts, tg) = res[pt], res[paddle]
    assert ts == js
    np.testing.assert_allclose(to, jo, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tg, jg)
    grid = to / (ts / 127.0)
    np.testing.assert_allclose(grid, np.round(grid), atol=1e-4)
    inside = np.abs(xv) <= ts
    assert np.abs(to - xv)[inside].max() <= ts / 127.0 + 1e-6


@pytest.mark.parametrize("conv", [False, True])
def test_qat_net_outputs_and_grads(conv):
    """QAT with a fake quanter on weights and activations: outputs, the
    input's and every parameter's gradient through the quanters equal
    the JAX package's (``twin``, 1e-5)."""
    if conv:
        def make(P):
            return _qat(P, P.nn.Sequential(P.nn.Conv2D(3, 8, 3, padding=1),
                                           P.nn.ReLU()),
                        **_cfg(P, _both_quanters()))
        x = np.random.default_rng(5).standard_normal(
            (2, 3, 8, 8)).astype("f4")
    else:
        def make(P):
            return _qat(P, _mlp(P), **_cfg(P, _both_quanters()))
        x = _x(8)
    tl = twin(make, [x], tol=TOL)
    kind = "QuantedConv2D" if conv else "QuantedLinear"
    kinds = [type(m).__name__ for _, m in tl.named_children()]
    assert kinds.count(kind) == (1 if conv else 2)


def test_qat_trains_and_steps_match():
    """Twelve SGD steps of the QAT net, the same losses in both (1e-5
    relative), falling."""
    y = np.random.default_rng(3).integers(0, 4, (8,))
    x = _x(8)
    losses = {}
    for P in (pt, paddle):
        P.seed(0)
        net = _mlp(P)
        if P is paddle:
            net.set_state_dict({k: np.asarray(v.numpy())
                                for k, v in jnet.state_dict().items()})
        else:
            jnet = net
        qm = _qat(P, net, **_cfg(P, _both_quanters()))
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=qm.parameters())
        out = []
        for _ in range(12):
            loss = P.nn.functional.cross_entropy(qm(P.to_tensor(x)),
                                                 P.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss.numpy()))
        losses[P] = out
    np.testing.assert_allclose(losses[paddle], losses[pt], rtol=TOL)
    assert losses[paddle][-1] < losses[paddle][0]


def test_ptq_calibration_and_convert():
    """PTQ with absmax observers: three calibration passes, then
    ``convert``: the deploy nets' outputs and weights equal (1e-5), the
    wrappers gone in both."""
    x = _x(16)
    res = {}
    for P in (pt, paddle):
        P.seed(0)
        net = _mlp(P)
        if P is paddle:
            net.set_state_dict(state)
        else:
            state = {k: np.asarray(v.numpy())
                     for k, v in net.state_dict().items()}
        net.eval()
        ptq = P.quantization.PTQ(P.quantization.QuantConfig(
            **_cfg(P, {"activation": "absmax", "weight": "absmax"})))
        qm = ptq.quantize(net)
        for _ in range(3):
            qm(P.to_tensor(x))
        deploy = ptq.convert(qm)
        res[P] = (np.asarray(deploy(P.to_tensor(x)).numpy()),
                  [type(m).__name__ for _, m in deploy.named_children()],
                  {k: np.asarray(v.numpy())
                   for k, v in deploy.state_dict().items()})
    (jo, jk, jw), (to, tk, tw) = res[pt], res[paddle]
    np.testing.assert_allclose(to, jo, rtol=TOL, atol=TOL)
    assert tk == jk and "QuantedLinear" not in tk
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=TOL, atol=TOL)


def test_routing_by_type_name_and_mapping():
    """``add_type_config``, ``add_name_config`` on a dotted path and a
    custom mapping beside the defaults wrap the same layers in both."""
    def structure(P):
        Q = P.quantization
        m = _mlp(P)
        m.train()
        cfg = Q.QuantConfig()
        cfg.add_type_config(P.nn.Linear,
                            weight=Q.FakeQuanterWithAbsMaxObserver())
        qm = Q.QAT(cfg).quantize(m)
        quanted = [l for _, l in qm.named_children()
                   if isinstance(l, Q.QuantedLinear)]
        distinct = quanted[0].weight_quanter is not quanted[1].weight_quanter
        acts = [l.activation_quanter for l in quanted]

        class Net(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.block = P.nn.Sequential(P.nn.Linear(4, 4))
                self.head = P.nn.Linear(4, 2)

            def forward(self, x):
                return self.head(self.block(x))

        class Mine(P.nn.Layer):
            pass

        class MineQuanted(P.nn.Layer):
            def __init__(self, src, wq, aq):
                super().__init__()

        cfg2 = Q.QuantConfig()
        cfg2.add_name_config(["block.0"],
                             weight=Q.FakeQuanterWithAbsMaxObserver())
        cfg2.add_qat_layer_mapping(Mine, MineQuanted)
        net = Net()
        net.train()
        q2 = Q.QAT(cfg2).quantize(net)
        kids = dict(q2.named_children())
        return ([type(l).__name__ for _, l in qm.named_children()],
                distinct, acts,
                [type(l).__name__ for _, l in kids["block"].named_children()],
                type(kids["head"]).__name__)

    j, t = structure(pt), structure(paddle)
    assert t == j
    assert t[0].count("QuantedLinear") == 2 and t[1]
    assert t[3] == ["QuantedLinear"] and t[4] == "Linear"


def test_modes_are_checked():
    for P in (pt, paddle):
        Q = P.quantization
        m = _mlp(P)
        m.eval()
        with pytest.raises(AssertionError):
            Q.QAT(Q.QuantConfig(weight=Q.FakeQuanterWithAbsMaxObserver())
                  ).quantize(m)
        m.train()
        with pytest.raises(AssertionError):
            Q.PTQ(Q.QuantConfig(weight=Q.AbsmaxObserver())).quantize(m)


def test_stub_and_names():
    assert set(pt.quantization.__all__) <= set(paddle.quantization.__all__)
    assert paddle.quantization.quanters.FakeQuanterWithAbsMaxObserver is \
        paddle.quantization.FakeQuanterWithAbsMaxObserver
    assert paddle.quantization.observers.AbsmaxObserver is \
        paddle.quantization.AbsmaxObserver
    x = np.arange(6, dtype="f4").reshape(2, 3)
    for P in (pt, paddle):
        obs = P.quantization.AbsmaxObserver()
        out = P.nn.quant.Stub(obs)(P.to_tensor(x))
        np.testing.assert_array_equal(np.asarray(out.numpy()), x)
        assert float(obs.scales().numpy()) == 5.0
        np.testing.assert_array_equal(
            np.asarray(P.nn.quant.Stub()(P.to_tensor(x)).numpy()), x)


def test_qat_gpt_wraps_the_same_projections_and_matches():
    """The 2-layer GPT under QAT (fake quanters on weights and
    activations): the JAX default mapping wraps its four ``nn.Linear``
    projections a layer; the port's wraps the same four
    (``models/_modules.py`` ``Linear`` -> ``QuantedTorchLinear``). Loss,
    logits and the projections' weight gradients equal the JAX
    package's (2e-5; the port's ``[out, in]`` weights transposed)."""
    pt.seed(0)
    jm = JaxGPT(jax_gpt_tiny(hidden_size=64, num_heads=2))
    ref = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(hidden_size=64, num_heads=2),
                        device="cpu", seed=1)
    load_reference_state_dict(tm, ref)
    jq = _qat(pt, jm, **_cfg(pt, _both_quanters()))
    tq = _qat(paddle, tm, **_cfg(paddle, _both_quanters()))
    jn = sorted(n for n, m in jq.named_sublayers()
                if isinstance(m, pt.quantization.QuantedLinear))
    tn = sorted(n for n, m in tq.named_modules()
                if isinstance(m, paddle.quantization.QuantedTorchLinear))
    assert tn == jn and len(tn) == 8, (tn, jn)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 16))
    labels = np.roll(ids, -1, axis=1)
    jl, jloss = jq(pt.to_tensor(ids), labels=pt.to_tensor(labels))
    jloss.backward()
    tl, tloss = tq(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tloss.backward()
    tol = 2e-5
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl.numpy()),
                               rtol=tol, atol=tol)
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in jq.named_parameters() if p.grad is not None}
    for n, p in tq.named_parameters():
        if n.endswith("source.weight"):
            np.testing.assert_allclose(p.grad.numpy().T, jgrads[n],
                                       rtol=tol, atol=tol, err_msg=n)


def test_ptq_gpt_calibrates_and_converts_as_the_jax_package():
    """PTQ with absmax observers on the 2-layer GPT: two calibration
    passes, then ``convert``: the deploy models' logits equal (2e-5) and
    each projection's stored weight is its fake-quantized value in both
    (the port's transposed)."""
    pt.seed(0)
    jm = JaxGPT(jax_gpt_tiny(hidden_size=64, num_heads=2))
    ref = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(hidden_size=64, num_heads=2),
                        device="cpu", seed=1)
    load_reference_state_dict(tm, ref)
    ids = np.random.default_rng(2).integers(0, 512, (2, 16))
    out = {}
    for P, m, x in ((pt, jm, pt.to_tensor(ids)),
                    (paddle, tm, torch.from_numpy(ids))):
        m.eval()
        Q = P.quantization
        ptq = Q.PTQ(Q.QuantConfig(**_cfg(P, {"activation": "absmax",
                                             "weight": "absmax"})))
        qm = ptq.quantize(m)
        for _ in range(2):
            qm(x)
        deploy = ptq.convert(qm)
        host = (lambda t: np.asarray(t.numpy())) if P is pt else \
            (lambda t: t.detach().numpy())
        out[P] = (host(deploy(x)),
                  {k: host(v) for k, v in deploy.state_dict().items()})
    (jl, jw), (tl, tw) = out[pt], out[paddle]
    np.testing.assert_allclose(tl, jl, rtol=2e-5, atol=2e-5)
    for k, v in jw.items():
        got = tw[k].T if tw[k].ndim == 2 and k.endswith(
            ("proj.weight", "fc1.weight", "fc2.weight")) else tw[k]
        np.testing.assert_allclose(got, v, rtol=1e-6, atol=1e-7, err_msg=k)
