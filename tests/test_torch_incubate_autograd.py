"""``incubate.autograd`` against the JAX package, on
``tests/test_higher_order_ad.py``'s cases and a few more (several
inputs, a batched Hessian, a layer's parameters), values at rtol 1e-5 /
atol 1e-6.

Flash attention has no second derivative on either side: the JAX
package's ``custom_vjp`` over ``pallas_call`` has no forward-mode rule,
and the port's backward (K2, K3), run with ``create_graph``, returns
gradients whose own backward raises. A
``Hessian``, ``jvp`` or ``forward_grad`` through it raises in both
packages. Before this was pinned, the port's CPU path differentiated
its plain backward and returned a wrong Hessian (it missed LSE's
dependence on q); the twin holds the dense attention's Hessian, with the
kernel switched off, against the JAX package's.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def R(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype("f4")


def _np(out):
    if isinstance(out, (list, tuple)):
        return [_np(o) for o in out]
    return np.asarray(out.numpy())


def _leaf(P, a):
    t = P.to_tensor(a)
    t.stop_gradient = False
    return t


X2 = np.array([1.0, 2.0], "f4")
CASES = {
    "vjp": lambda P: P.incubate.autograd.vjp(
        lambda x: (x * x).sum(), P.to_tensor(X2)),
    "vjp_two_inputs_with_v": lambda P: P.incubate.autograd.vjp(
        lambda x, y: P.tanh(x) * y, [P.to_tensor(R(3)),
                                     P.to_tensor(R(3, seed=1))],
        v=P.to_tensor(R(3, seed=2))),
    "jvp": lambda P: P.incubate.autograd.jvp(
        lambda x: x * x, P.to_tensor(X2), v=P.to_tensor(
            np.array([1.0, 0.0], "f4"))),
    "jvp_default_tangent": lambda P: P.incubate.autograd.jvp(
        lambda x: P.sin(x) * x, P.to_tensor(R(4))),
    "jacobian": lambda P: P.incubate.autograd.Jacobian(
        lambda x: P.stack([x[0] * x[1], x[0] + x[1]]), P.to_tensor(X2))[:],
    "jacobian_batched": lambda P: P.incubate.autograd.Jacobian(
        lambda x: x * x, P.to_tensor(R(4, 3, seed=1)), is_batched=True)[:],
    "jacobian_of_a_layer": lambda P: P.incubate.autograd.Jacobian(
        lambda x: P.tanh(P.matmul(x, P.to_tensor(R(3, 2, seed=4)))),
        P.to_tensor(R(3, seed=5)))[:],
    "hessian": lambda P: P.incubate.autograd.Hessian(
        lambda x: (x * x).sum() + x[0] * x[1], P.to_tensor(X2))[:],
    "hessian_nonlinear": lambda P: P.incubate.autograd.Hessian(
        lambda x: (P.exp(x) * x[0]).sum() + (x ** 3).sum(),
        P.to_tensor(R(3, seed=6)))[:],
    "hessian_batched": lambda P: P.incubate.autograd.Hessian(
        lambda x: (x ** 3).sum(), P.to_tensor(R(2, 3, seed=7)),
        is_batched=True)[:],
}


def _forward_grad(P, tangent=None):
    x = _leaf(P, X2)
    y = x * x * x
    t = None if tangent is None else P.to_tensor(tangent)
    return P.incubate.autograd.forward_grad(y, x, grad_inputs=t)


def _forward_grad_sum(P):
    x = _leaf(P, X2)
    y = (x * x).sum()
    return P.incubate.autograd.forward_grad(y, x, grad_inputs=P.to_tensor(
        np.array([1.0, 0.0], "f4")))


def _prim_grad(P):
    x = _leaf(P, np.float32(3.0))
    return P.incubate.autograd.grad(x * x, x)


CASES.update({
    "forward_grad": lambda P: _forward_grad(P),
    "forward_grad_with_tangent": lambda P: _forward_grad(
        P, np.array([1.0, -2.0], "f4")),
    "forward_grad_of_a_sum": _forward_grad_sum,
    "primapi_grad": _prim_grad,
})


@pytest.fixture(scope="module")
def jax_side():
    return {name: _np(fn(pt)) for name, fn in CASES.items()}


def _arrays(x):
    if isinstance(x, list):
        return [a for v in x for a in _arrays(v)]
    return [x]


@pytest.mark.parametrize("name", list(CASES))
def test_transform_matches_jax(jax_side, name):
    got, want = _arrays(_np(CASES[name](paddle))), _arrays(jax_side[name])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


def test_forward_grad_leaves_the_graph_usable():
    x = _leaf(paddle, X2)
    y = (x * x * x).sum()
    paddle.incubate.autograd.forward_grad(y, x)
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), 3 * X2 ** 2, **TOL)


def test_prim_toggles():
    iag = paddle.incubate.autograd
    iag.enable_prim()
    assert iag.prim_enabled()
    iag.disable_prim()
    assert not iag.prim_enabled()


# ------------------------------------------------------------ attention
K, V = R(1, 4, 1, 32, seed=8), R(1, 4, 1, 32, seed=9)
Q = R(1, 4, 1, 32, seed=10)


def _attn(P):
    k, v = P.to_tensor(K), P.to_tensor(V)
    return lambda q: P.nn.functional.scaled_dot_product_attention(
        q, k, v).sum()


def test_second_derivatives_through_flash_attention_raise_in_both(
        monkeypatch):
    from paddle_tpu.autograd.engine import apply_op
    from paddle_tpu.ops.pallas import flash_attention as jfa

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    k, v = pt.to_tensor(K)._value, pt.to_tensor(V)._value

    def jax_attn(q):
        return apply_op(lambda a: jfa.flash_attention_bshd(a, k, v), [q],
                        name="flash").sum()

    jiag = pt.incubate.autograd
    with pytest.raises((TypeError, AssertionError)):
        jiag.Hessian(jax_attn, pt.to_tensor(Q))[:]
    with pytest.raises(TypeError, match="custom_vjp"):
        jiag.jvp(jax_attn, pt.to_tensor(Q))

    iag = paddle.incubate.autograd
    f = _attn(paddle)
    with pytest.raises(RuntimeError, match="no second derivative"):
        iag.Hessian(f, paddle.to_tensor(Q))[:]
    with pytest.raises(RuntimeError, match="no second derivative"):
        iag.jvp(f, paddle.to_tensor(Q))
    q = _leaf(paddle, Q)
    with pytest.raises(RuntimeError, match="no second derivative"):
        iag.forward_grad(f(q), q)
    # the first derivative is there
    _, g = iag.vjp(f, paddle.to_tensor(Q))
    assert np.isfinite(g.numpy()).all()


def test_dense_attention_hessian_matches_jax():
    """With the kernel switched off the port's attention is the dense
    version, whose Hessian (double backward) equals the JAX package's
    (its CPU attention is the dense version too)."""
    want = np.asarray(pt.incubate.autograd.Hessian(
        _attn(pt), pt.to_tensor(Q))[:].numpy())
    try:
        paddle.incubate.set_config({"kernel": {"enable": False}})
        got = np.asarray(paddle.incubate.autograd.Hessian(
            _attn(paddle), paddle.to_tensor(Q))[:].numpy())
    finally:
        paddle.incubate.set_config(None)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


class _PlainSecondOrder(torch.autograd.Function):
    """The flash function as it was before the repair: its backward's
    plain version differentiated as ordinary ops under ``create_graph``."""

    @staticmethod
    def forward(ctx, q, k, v):
        from paddle_tpu_torch.ops import flash_attention as fa

        o, lse = fa.flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        from paddle_tpu_torch.ops import flash_attention as fa

        return fa.flash_bwd(*ctx.saved_tensors, do)


def _dense(k, v):
    def f(qq):
        s = torch.einsum("bqhd,bkhd->bhqk", qq, k) / math.sqrt(32)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                            v).sum()
    return f


def test_flash_backward_is_first_order_only():
    """The fault and its repair. Observed before: the Hessian through the
    flash function's plain backward, differentiated as ops, against the
    dense attention's (expected) -- it leaves out LSE's dependence on q.
    Now the first derivative equals the dense one and a second one
    raises."""
    from paddle_tpu_torch.ops import flash_attention as fa

    k, v = torch.from_numpy(K), torch.from_numpy(V)
    q = torch.from_numpy(Q)
    expected = torch.autograd.functional.hessian(_dense(k, v), q)
    observed = torch.autograd.functional.hessian(
        lambda qq: _PlainSecondOrder.apply(qq, k, v).sum(), q)
    off = float((observed - expected).abs().max())
    assert off > 0.1 * float(expected.abs().max()), (off, expected)

    q = q.clone().requires_grad_(True)
    (g_flash,) = torch.autograd.grad(fa.flash_attention_bshd(q, k, v).sum(),
                                     q, create_graph=True)
    (g_dense,) = torch.autograd.grad(_dense(k, v)(q), q)
    np.testing.assert_allclose(g_flash.detach().numpy(), g_dense.numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(g_flash.sum(), q)
