"""The deterministic embedding backward's plain version
(``ops/embedding_grad.py``; its CUDA kernel runs on the card in
``chip_smoke.py``'s distributed phase) against ``tF.embedding``'s
gradient and the JAX package's, on the CPU; and
``FLAGS_cudnn_deterministic`` routing ``nn.functional.embedding``
through it. Tolerance 1e-6 (f32 sums of the same rows in another
order); the flag's two paths agree bit for bit on the CPU."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as jF
import paddle_tpu_torch as paddle
from paddle_tpu_torch.ops import embedding_grad as eg
from torch_suite import one_torch_thread  # noqa: F401


def _case(seed, V=50, H=8, shape=(4, 16)):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.1, shape) - 1) % V
    w = rng.standard_normal((V, H)).astype(np.float32)
    g = rng.standard_normal(shape + (H,)).astype(np.float32)
    return ids, w, g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_version_matches_torch_and_jax(seed):
    ids, w, g = _case(seed)
    wt = torch.tensor(w, requires_grad=True)
    torch.nn.functional.embedding(torch.from_numpy(ids), wt).backward(
        torch.from_numpy(g))
    got = eg.ref_embedding_grad(torch.from_numpy(ids),
                                torch.from_numpy(g).reshape(-1, 8), 50)
    np.testing.assert_allclose(got.numpy(), wt.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    jw = pt.to_tensor(w)
    jw.stop_gradient = False
    out = jF.embedding(pt.to_tensor(ids), jw)
    (out * pt.to_tensor(g)).sum().backward()
    np.testing.assert_allclose(got.numpy(), np.asarray(jw.grad.numpy()),
                               rtol=1e-6, atol=1e-6)


def test_bf16_rounds_once_from_f32_sums():
    ids, _, g = _case(3)
    gb = torch.from_numpy(g).reshape(-1, 8).to(torch.bfloat16)
    got = eg.ref_embedding_grad(torch.from_numpy(ids), gb, 50)
    want = torch.zeros(50, 8).index_add_(
        0, torch.from_numpy(ids).reshape(-1), gb.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_flag_routes_the_functional(monkeypatch):
    ids, w, g = _case(4)
    paddle.set_device("cpu")
    grads = {}
    try:
        for flag in (True, False):
            paddle.set_flags({"FLAGS_cudnn_deterministic": flag})
            before = eg.plain_calls
            wt = torch.tensor(w, requires_grad=True)
            out = paddle.nn.functional.embedding(torch.from_numpy(ids), wt,
                                                 padding_idx=0)
            out.backward(torch.from_numpy(g))
            grads[flag] = (wt.grad.clone(), eg.plain_calls - before)
    finally:
        paddle.set_flags({"FLAGS_cudnn_deterministic": True})
        paddle.set_device(None)
    assert grads[True][1] == 1 and grads[False][1] == 0
    assert torch.equal(grads[True][0], grads[False][0])
    assert not grads[True][0][0].any()  # padding_idx gets no gradient
    assert paddle.get_flags("FLAGS_cudnn_deterministic") == {
        "FLAGS_cudnn_deterministic": True}


def test_a_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """On a non-CPU tensor the wrapper launches the kernel or raises;
    here the build raises (no nvcc), and the plain count stays."""
    from paddle_tpu_torch.ops import _build

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_build)
    g = torch.zeros(4, 8, device="meta")
    before = eg.plain_calls
    with pytest.raises((RuntimeError, NotImplementedError)):
        eg.embedding_grad(torch.zeros(4, dtype=torch.int64, device="meta"),
                          g, 10)
    assert eg.plain_calls == before


def test_graph_replays_count_as_launches():
    """A call recorded into a CUDA graph counts as captured, and each
    replay's recorded calls as launches: ``launches()`` is eager plus
    replayed, as for K1-K4."""
    eg.reset_counters()
    eg.count_replays(3)
    eg.count_replays(3)
    assert (eg.kernel_launches, eg.captured_launches,
            eg.replayed_launches, eg.launches()) == (0, 0, 6, 6)
    eg.reset_counters()
    assert eg.launches() == 0 and eg.plain_calls == 0
