"""Twins of ``tests/test_autograd.py``: each case runs on the JAX tape and
on the port's (torch autograd) from the same inputs, and the results are
held equal (``torch_facade_common.both``); then what only the port can
show: an update under ``no_grad`` keeps a leaf's storage, hooks' handles,
``paddle.grad(create_graph=True)``, ``PyLayer`` keyword arguments,
``saved_tensors_hooks`` and grad mode."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from torch_facade_common import both, on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401


def case_simple_backward(P):
    x = P.to_tensor([2.0, 3.0], stop_gradient=False)
    (x * x).sum().backward()
    return [x.grad]


def case_chain_rule(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = x * x
    z = y * x + y
    z.backward()
    return [x.grad]


def case_grad_accumulation_across_backwards(P):
    x = P.to_tensor(3.0, stop_gradient=False)
    (x * x).backward()
    first = x.grad.numpy()
    (x * x).backward()
    second = x.grad.numpy()
    x.clear_grad()
    return [first, second, x.grad is None]


def case_shared_input_fanout(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    (x * 3 + x * 4).backward()
    return [x.grad]


def case_retain_graph(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = x * x
    y.backward(retain_graph=True)
    y.backward()
    with pytest.raises(RuntimeError, match="second time"):
        y.backward()
    return [x.grad]


def case_backward_nonscalar_requires_grad_tensor(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="single element"):
        (x * 2).backward()
    (x * 2).backward(P.to_tensor([1.0, 10.0]))
    return [x.grad]


def case_stop_gradient_blocks(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = P.to_tensor(3.0)
    (x * y).backward()
    return [x.grad, y.grad is None]


def case_detach_cuts_graph(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = (x * x).detach()
    (y * x).backward()
    return [x.grad]


def case_no_grad(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    with P.no_grad():
        y = x * x
    return [y.stop_gradient, y._grad_node is None]


def case_hooks(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    seen = []

    def hook(g):
        seen.append(g.numpy())
        return g * 2

    x.register_hook(hook)
    (x * 3).backward()
    return [len(seen), x.grad]


def case_paddle_grad_api(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = P.to_tensor(3.0, stop_gradient=False)
    gx, gy = P.grad(x * x * y, [x, y])
    return [gx, gy, x.grad is None]


def case_paddle_grad_unused(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    u = P.to_tensor(1.0, stop_gradient=False)
    with pytest.raises(RuntimeError, match="unused"):
        P.grad(x * 2, [u])
    (g,) = P.grad(x * 2, [u], allow_unused=True)
    return [g is None]


def case_inplace_add_rebind(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    w = P.to_tensor(5.0, stop_gradient=False)
    a = x * w
    x.add_(P.to_tensor(1.0))
    b = x * 2
    (a + b).backward()
    return [w.grad, x]


def case_setitem_grad(P):
    x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    v = P.to_tensor(10.0, stop_gradient=False)
    y = x * 2
    y[1] = v
    y.sum().backward()
    return [x.grad, v.grad, y]


def case_pylayer(P):
    class Double(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * 2

    x = P.to_tensor(3.0, stop_gradient=False)
    y = Double.apply(x)
    y.backward()
    return [y, x.grad]


def case_engine_vs_jax_grad_mlp(P):
    rng = np.random.RandomState(0)
    ws = [rng.randn(4, 8).astype(np.float32), rng.randn(8, 2).astype(np.float32),
          rng.randn(3, 4).astype(np.float32)]
    w1, w2, x = [P.to_tensor(a, stop_gradient=False) for a in ws]
    (P.tanh(x @ w1) @ w2).sum().backward()
    return [w1.grad, w2.grad, x.grad]


def case_deep_chain(P):
    x = P.to_tensor(1.0, stop_gradient=False)
    y = x
    for _ in range(200):
        y = y * 1.01
    y.backward()
    return [x.grad]


def case_inplace_under_no_grad_keeps_trainable(P):
    w = P.Parameter(np.ones((2,), np.float32))
    with P.no_grad():
        w.add_(P.to_tensor([0.5, 0.5]))
    trainable = w.stop_gradient is False
    (w * 2).sum().backward()
    return [trainable, w.grad, w]


def case_single_element_tuple_output_backward(P):
    x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    (part,) = P.split(x.reshape([1, 3]), 1, axis=0)
    part.sum().backward()
    return [x.grad]


def case_split_nondivisible_raises(P):
    with pytest.raises(ValueError, match="not divisible"):
        P.split(P.ones([5]), 2)
    return []


def case_bitwise_operators(P):
    a = P.to_tensor([6])
    b = P.to_tensor([3])
    return [(a & b).tolist(), (a | b).tolist(), (a ^ b).tolist(),
            (~a).tolist()]


CASES = [case_simple_backward, case_chain_rule,
         case_grad_accumulation_across_backwards, case_shared_input_fanout,
         case_retain_graph, case_backward_nonscalar_requires_grad_tensor,
         case_stop_gradient_blocks, case_detach_cuts_graph, case_no_grad,
         case_hooks, case_paddle_grad_api, case_paddle_grad_unused,
         case_inplace_add_rebind, case_setitem_grad, case_pylayer,
         case_engine_vs_jax_grad_mlp, case_deep_chain,
         case_inplace_under_no_grad_keeps_trainable,
         case_single_element_tuple_output_backward,
         case_split_nondivisible_raises, case_bitwise_operators]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_autograd_twin(case):
    both(case, tol=1e-5)


def case_constructors_copy_what_they_are_given(P):
    """A write under ``no_grad`` to a new cell (``to_tensor`` of an array
    or of a Tensor, ``Tensor()``, ``Parameter()``) leaves its source as
    it was."""
    a = np.ones(3, np.float32)
    t = P.to_tensor(a)
    w = P.Parameter(a)
    s = P.to_tensor(t, stop_gradient=False)
    u = P.Tensor(t, stop_gradient=False)
    q = P.Parameter(t)
    with P.no_grad():
        w.add_(P.to_tensor([1.0, 1.0, 1.0]))
        s.add_(P.to_tensor([2.0, 2.0, 2.0]))
        u[0] = 7.0
        q[1:] = 5.0
    return [a, t, w, s, u, q, w.stop_gradient, s.stop_gradient]


def case_no_grad_write_to_a_view_leaves_its_source(P):
    """A write under ``no_grad`` to a reshape, a slice, a transpose, a
    split or a cast to the same dtype of a tensor (trainable or not)
    leaves that tensor as it was."""
    x = P.Parameter(np.arange(6, dtype=np.float32).reshape(2, 3))
    t = P.to_tensor(np.arange(4, dtype=np.float32))
    with P.no_grad():
        y = x.reshape([3, 2])
        y.add_(P.ones([3, 2]))
        z = x[0]
        z[1] = 9.0
        c = x.astype("float32")
        c.add_(P.ones([2, 3]))
        tr = x.transpose([1, 0])
        tr[0] = 5.0
        (sp, _, _) = P.split(x, 3, axis=1)
        sp.scale_(3.0)
        r = t.reshape([2, 2])
        r[0, 0] = -1.0
        t2 = t[1:]
        t2.add_(P.ones([3]))
    return [x, t, y, z, c, tr, sp, r, t2, x.stop_gradient]


@pytest.mark.parametrize("case", [
    case_constructors_copy_what_they_are_given,
    case_no_grad_write_to_a_view_leaves_its_source],
    ids=lambda c: c.__name__[5:])
def test_no_grad_writes_reach_no_other_tensor_twin(case):
    both(case)


def case_double_grad(P):
    """``create_graph=True`` through an elementwise and matmul chain: the
    first grads carry a graph, and differentiating them again gives the
    analytic second derivative."""
    rng = np.random.RandomState(1)
    x = P.to_tensor(rng.randn(3, 4).astype("float32"), stop_gradient=False)
    w = P.to_tensor(rng.randn(4, 2).astype("float32"), stop_gradient=False)
    y = (P.tanh(x @ w) ** 2).sum()
    (gx,) = P.grad(y, [x], create_graph=True)
    (gw2,) = P.grad(gx.sum(), [w])
    return [gx, gw2]


def test_double_grad_twin():
    got = both(case_double_grad, tol=1e-5)
    assert got  # held against the JAX package's double-grad path


def test_double_grad_is_analytic():
    """d/dx of sum(x^3) is 3x^2; of that, 6x."""
    x = paddle.to_tensor([0.5, -1.0, 2.0], stop_gradient=False)
    (g,) = paddle.grad((x * x * x).sum(), [x], create_graph=True)
    assert not g.stop_gradient
    (h,) = paddle.grad(g.sum(), [x])
    np.testing.assert_allclose(g.numpy(), 3 * x.numpy() ** 2, rtol=1e-6)
    np.testing.assert_allclose(h.numpy(), 6 * x.numpy(), rtol=1e-6)


def test_no_grad_update_keeps_storage():
    """An optimizer-style write under ``no_grad`` goes into the leaf's
    storage (a module, an optimizer or a captured graph holding it sees
    it); with grad on, an in-place op rebinds instead."""
    w = paddle.Parameter(np.ones((4,), np.float32))
    ptr = w._value.data_ptr()
    held = w._value
    with paddle.no_grad():
        w.add_(paddle.to_tensor([0.5] * 4))
        w[0] = 3.0
        paddle.assign(paddle.full([4], 2.0), output=w)
    assert w._value.data_ptr() == ptr and w._value is held
    assert not w.stop_gradient and w.is_leaf
    np.testing.assert_array_equal(held.detach().numpy(), [2.0] * 4)
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    old = x._value
    y = x * 3
    x.add_(paddle.to_tensor([1.0, 1.0]))
    assert x._value is not old and not x.is_leaf
    y.sum().backward()  # the graph kept the old value
    np.testing.assert_array_equal(old.grad.numpy(), [3.0, 3.0])


def test_hook_handle_removes_and_none_keeps_grad():
    x = paddle.to_tensor(2.0, stop_gradient=False)
    calls = []
    h = x.register_hook(lambda g: calls.append(1))  # returns None
    (x * 3).backward()
    assert calls == [1] and float(x.grad) == 3.0
    h.remove()
    x.clear_grad()
    (x * 3).backward()
    assert calls == [1] and float(x.grad) == 3.0


def test_stop_gradient_setter():
    x = paddle.to_tensor([1.0, 2.0])
    x.stop_gradient = False
    assert not x.stop_gradient and x._value.requires_grad
    y = x * 2
    z = y * 3
    y.stop_gradient = True  # later consumers are cut, earlier keep edges
    w = y * 5
    assert w.stop_gradient and not z.stop_gradient
    z.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [6.0, 6.0])
    i = paddle.to_tensor([1, 2])
    i.stop_gradient = False  # an integer tensor takes no gradient
    assert i.stop_gradient


def test_pylayer_keywords_and_two_outputs():
    class ScaleShift(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale=1.0, shift=None):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return x * scale, x + shift

        @staticmethod
        def backward(ctx, ga, gb):
            return ga * ctx.scale + gb, gb

    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    s = paddle.to_tensor([5.0, 5.0], stop_gradient=False)
    a, b = ScaleShift.apply(x, shift=s, scale=3.0)
    (a.sum() + b.sum()).backward()
    np.testing.assert_array_equal(a.numpy(), [3.0, 6.0])
    np.testing.assert_array_equal(x.grad.numpy(), [4.0, 4.0])
    np.testing.assert_array_equal(s.grad.numpy(), [1.0, 1.0])


def test_saved_tensors_hooks_and_grad_mode():
    packed = []

    def pack(t):
        packed.append(t.shape)
        return t.clone()

    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    with paddle.autograd.saved_tensors_hooks(pack, lambda t: t):
        y = (x * x).sum()
    y.backward()
    assert packed and x.grad.tolist() == [2.0, 4.0]
    assert paddle.is_grad_enabled()
    paddle.set_grad_enabled(False)
    try:
        assert not paddle.is_grad_enabled()
        assert (x * 2).stop_gradient
        with paddle.enable_grad():
            assert not (x * 2).stop_gradient
    finally:
        paddle.set_grad_enabled(True)
    with paddle.set_grad_enabled(False):
        assert not torch.is_grad_enabled()
    assert torch.is_grad_enabled()


def test_backward_errors_follow_the_jax_package():
    x = paddle.to_tensor(2.0)
    with pytest.raises(RuntimeError, match="stop_gradient=True"):
        x.backward()
    with pytest.raises(RuntimeError, match="stop_gradient=True"):
        paddle.grad(x * 2, [x])
    y = paddle.to_tensor(2.0, stop_gradient=False)
    with pytest.raises(RuntimeError, match="unused"):
        paddle.grad(y * 2, [x])
