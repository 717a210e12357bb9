"""``paddle.summary`` (``hapi/summary.py``) and ``paddle.flops``
(``utils/flops.py``) of the port against the JAX package's.

- ``summary`` prints the same table (layer types and order, output
  shapes, parameter counts, totals) and returns the same counts for the
  same nets, given shapes, dtypes or inputs; on a torch module (the
  port's GPT) it counts every parameter.
- ``flops`` counts products and convolutions: exactly the analytic
  2·M·N·K sums (2·N·C_out·H_out·W_out·C_in·k² a convolution). The JAX
  package reads XLA's cost analysis, which counts the elementwise work
  too (bias adds, ReLU) and a convolution's taps its own way: the counts
  differ by design (ROADMAP "Differences by design"), so the JAX side is
  only held to count something.

Exact comparisons (integers and printed text).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

BOTH = (pt, paddle)


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 2))


def _conv(P):
    return P.nn.Sequential(P.nn.Conv2D(3, 4, 3, padding=1), P.nn.ReLU(),
                           P.nn.Conv2D(4, 2, 3, stride=2),
                           P.nn.Flatten(), P.nn.Linear(2 * 3 * 3, 5))


@pytest.mark.parametrize("case", ["mlp_shape", "conv_shape", "mlp_input",
                                  "embedding_int"])
def test_summary_prints_and_counts_as_the_jax_package(case, capsys):
    got = {}
    for P in BOTH:
        P.seed(0)
        if case == "mlp_shape":
            info = P.summary(_mlp(P), (4, 8))
        elif case == "conv_shape":
            info = P.hapi.summary(_conv(P), [(2, 3, 8, 8)],
                                  dtypes=["float32"])
        elif case == "mlp_input":
            net = _mlp(P)
            x = P.to_tensor(np.ones((3, 8), "f4"))
            for p in net.parameters()[:1]:
                p.stop_gradient = True
            info = P.summary(net, input=x)
        else:
            net = P.nn.Sequential(P.nn.Embedding(10, 4), P.nn.Linear(4, 3))
            info = P.summary(net, (2, 5), dtypes="int64")
        got[P] = (info, capsys.readouterr().out)
    assert got[paddle] == got[pt]
    if case == "mlp_shape":
        assert got[paddle][0]["total_params"] == 8 * 16 + 16 + 16 * 2 + 2
        assert "Linear-0" in got[paddle][1]


def test_summary_of_a_torch_module(capsys):
    m = GPTForCausalLM(gpt_tiny(num_layers=1, hidden_size=32, num_heads=2,
                                vocab_size=64), device="cpu", seed=0)
    info = paddle.summary(m, (2, 8), dtypes="int64")
    n = sum(p.numel() for p in m.parameters())
    assert info == {"total_params": n, "trainable_params": n}
    out = capsys.readouterr().out
    assert "Linear-" in out and "LayerNorm-" in out
    assert m.training  # the mode is put back


def test_flops_are_the_analytic_product_sums():
    for P in BOTH:
        P.seed(0)
    lin = {P: P.nn.Linear(64, 32, bias_attr=False) for P in BOTH}
    want = 2 * 8 * 64 * 32
    assert paddle.flops(lin[paddle], [8, 64]) == want
    assert pt.flops(lin[pt], [8, 64]) >= want  # a bare product: XLA's too
    mlp = {P: _mlp(P) for P in BOTH}
    want = 2 * 4 * 8 * 16 + 2 * 4 * 16 * 2
    assert paddle.flops(mlp[paddle], [4, 8]) == want
    assert pt.flops(mlp[pt], [4, 8]) > want  # XLA adds bias adds, ReLU
    conv = {P: _conv(P) for P in BOTH}
    want = (2 * 2 * 4 * 8 * 8 * 3 * 9 + 2 * 2 * 2 * 3 * 3 * 4 * 9
            + 2 * 2 * 18 * 5)
    assert paddle.flops(conv[paddle], [2, 3, 8, 8], print_detail=True) == want
    assert pt.flops(conv[pt], [2, 3, 8, 8]) > 0
    assert paddle.utils.flops is paddle.flops


def test_flops_of_the_ports_gpt_on_the_cpu():
    """The GPT's products: per layer the QKV, output and MLP projections,
    then the tied head. Attention is the operator
    ``paddle_tpu_torch::flash_fwd``: on the card its K1 launches add
    their causal pairs' flops (``flop_log``); on the CPU the plain
    version runs inside the operator, where the count does not look."""
    B, S, H, L, V = 2, 8, 32, 2, 64
    m = GPTForCausalLM(gpt_tiny(num_layers=L, hidden_size=H, num_heads=2,
                                vocab_size=V), device="cpu", seed=0)
    T = B * S
    per_layer = (2 * T * H * 3 * H + 2 * T * H * H + 2 * T * H * 4 * H
                 + 2 * T * 4 * H * H)
    with torch.no_grad():
        class Ids(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.m = m

            def forward(self, x):
                return self.m(x.long())

        assert paddle.flops(Ids(), [B, S]) == L * per_layer + 2 * T * H * V


def test_model_summary_counts_as_the_jax_package(capsys):
    """``hapi.Model.summary`` (``tests/test_hapi.py``'s 8-16-2 net)."""
    got = {}
    for P in BOTH:
        P.seed(0)
        model = P.Model(P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                                        P.nn.Linear(16, 2)))
        got[P] = model.summary()
    assert got[paddle] == got[pt]
    assert got[paddle]["total_params"] == 178
