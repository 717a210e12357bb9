"""paddle_tpu_torch.ops.fused_loss against the JAX package's
``fused_linear_cross_entropy``: the loss and its grads in hidden and
weight, on inputs drawn with numpy.

Cases: a vocab that is not a multiple of the chunk (the last chunk is the
remainder here, zero-padded and masked in the JAX package), labels equal
to ``ignore_index``, every label ignored, and bf16 hidden and weight.

Tolerances: f32 atol = rtol = 1e-5 (the same f32 chunked logsumexp,
summed in other orders). bf16 inputs: the math is f32 on both sides from
the same bf16 values, so the loss holds to 1e-5; the grads come back in
bf16 and hold to one bf16 ulp (rtol 2^-7, atol 1e-6 for values near 0).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_loss import \
    fused_linear_cross_entropy as jax_fused_ce
from paddle_tpu_torch.ops.fused_loss import fused_linear_cross_entropy
from torch_suite import one_torch_thread  # noqa: F401

# name: (N, H, V, chunk, ignored rows, dtype)
CASES = {
    "ragged_vocab": (24, 32, 300, 128, (), "f32"),
    "ignore_index": (24, 32, 256, 64, (0, 5, 23), "f32"),
    "all_ignored": (8, 16, 100, 64, tuple(range(8)), "f32"),
    "one_chunk": (16, 32, 200, 8192, (3,), "f32"),
    "bf16": (24, 32, 300, 128, (7,), "bf16"),
}


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name):
    n, h, v, chunk, ignored, dt = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    hidden = rng.standard_normal((n, h)).astype(np.float32)
    weight = (0.2 * rng.standard_normal((v, h))).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int64)
    labels[list(ignored)] = -100
    if dt == "bf16":
        hidden = hidden.astype(ml_dtypes.bfloat16)
        weight = weight.astype(ml_dtypes.bfloat16)
    loss_j, (dh_j, dw_j) = jax.value_and_grad(
        lambda a, b: jax_fused_ce(a, b, jnp.asarray(labels), chunk),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(weight))
    ht, wt = _t(hidden).requires_grad_(), _t(weight).requires_grad_()
    loss_t = fused_linear_cross_entropy(ht, wt, torch.from_numpy(labels),
                                        chunk)
    loss_t.backward()
    assert loss_t.dtype == torch.float32
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-5,
                               rtol=1e-5)
    tol = dict(atol=1e-5, rtol=1e-5) if dt == "f32" else dict(atol=1e-6,
                                                              rtol=2 ** -7)
    for got, want, ref in ((ht.grad, dh_j, ht), (wt.grad, dw_j, wt)):
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)
    if len(ignored) == n:
        assert loss_t.item() == 0.0 and float(ht.grad.abs().max()) == 0.0


def test_matches_dense_cross_entropy():
    """The fused loss is the plain mean CE of the full logits."""
    rng = np.random.default_rng(9)
    h = torch.from_numpy(rng.standard_normal((12, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((70, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 70, 12))
    want = torch.nn.functional.cross_entropy(h @ w.T, y)
    got = fused_linear_cross_entropy(h, w, y, chunk=32)
    np.testing.assert_allclose(got.item(), want.item(), atol=1e-5, rtol=1e-5)
