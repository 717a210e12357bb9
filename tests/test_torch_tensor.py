"""Twins of ``tests/test_tensor.py``: each of its cases runs in the JAX
package and in ``paddle_tpu_torch`` on the same inputs, and the results
are held equal (``torch_facade_common.both``); then the port's own
choices: bf16 ``numpy()``, the dtype rules of mixed operands, the
default device and its fixture."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from torch_facade_common import both, name_of, on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401


def case_to_tensor_defaults(P):
    t = P.to_tensor([1.0, 2.0, 3.0])
    assert t.shape == [3] and t.stop_gradient is True
    return [name_of(t.dtype), t]


def case_to_tensor_int(P):
    t = P.to_tensor([1, 2, 3])
    return [name_of(t.dtype), t.tolist()]


def case_dtype_cast(P):
    t = P.to_tensor([1.5, 2.5])
    i = t.astype("int32")
    b = t.astype(P.bfloat16)
    return [name_of(i.dtype), i, name_of(b.dtype)]


def case_creation_ops(P):
    return [P.zeros([2, 3]).shape, float(P.ones([4]).numpy().sum()),
            float(P.full([2, 2], 7).numpy()[0, 0]), P.arange(5).tolist(),
            float(P.eye(3).numpy().trace()), P.linspace(0, 1, 5)]


def case_like_ops(P):
    x = P.ones([2, 3])
    return [P.zeros_like(x).shape, P.full_like(x, 2.0)]


def case_operators(P):
    a = P.to_tensor([1.0, 2.0])
    b = P.to_tensor([3.0, 4.0])
    return [a + b, a - b, a * b, b / a, a + 1, 2 * a, 1 - a, -a, a ** 2]


def case_comparison_operators(P):
    a = P.to_tensor([1.0, 2.0, 3.0])
    b = P.to_tensor([2.0, 2.0, 2.0])
    return [(a < b).tolist(), (a == b).tolist(), (a >= b).tolist()]


def case_matmul_operator(P):
    a = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    b = P.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    return [a @ b]


def case_getitem(P):
    x = P.to_tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    idx = P.to_tensor([0, 1])
    return [x[0], x[:, 1], x[0, 1, 2], x[..., -1], x[idx],
            x[P.to_tensor([5, -1, -7])], x[:, None, 1:, ::2]]


def case_setitem(P):
    x = P.zeros([3, 3])
    x[0, 0] = 5.0
    x[1] = P.ones([3])
    x[P.to_tensor([2])] = 7.0
    return [x]


def case_item_and_len(P):
    return [P.to_tensor(3.5).item(), len(P.zeros([5, 2]))]


def case_tensor_methods_patched(P):
    x = P.to_tensor(np.random.RandomState(0).rand(3, 4).astype(np.float32))
    return [x.sum(), x.mean(axis=0), x.reshape([4, 3]), x.transpose([1, 0]),
            x.unsqueeze(0), x.flatten(), x.max(axis=1), x.T,
            x.topk(2)[0], x.cumsum(axis=0)]


def case_parameter(P):
    p = P.Parameter(np.zeros((2, 2), np.float32))
    return [p.stop_gradient, p.trainable, p]


def case_detach_and_clone(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    return [x.detach().stop_gradient, x.clone().stop_gradient]


def case_iteration_terminates(P):
    x = P.to_tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    rows = list(x)
    vals = [float(v) for v in P.to_tensor([7.0, 8.0])]
    with pytest.raises(TypeError):
        iter(P.to_tensor(1.0)).__next__()
    return [len(rows), rows[1].shape, rows[2], vals]


def case_out_of_range_int_index_raises(P):
    x = P.to_tensor(np.arange(12, dtype="float32").reshape(3, 4))
    for bad in (lambda: x[3], lambda: x[-4], lambda: x[0, 9],
                lambda: x[..., 4], lambda: x[2, -5]):
        with pytest.raises(IndexError):
            bad()
    y = x.clone()
    with pytest.raises(IndexError):
        y[3, 0] = 1.0
    return [float(x[-1, -1]), x[0:99].shape, x[P.to_tensor([0, 2])].shape]


def case_scalar_bool_index_adds_axis(P):
    x = P.to_tensor(np.zeros((5, 2), np.float32))
    with pytest.raises(IndexError):
        x[True, 9]
    return [x[True, 3].shape]


CASES = [case_to_tensor_defaults, case_to_tensor_int, case_dtype_cast,
         case_creation_ops, case_like_ops, case_operators,
         case_comparison_operators, case_matmul_operator, case_getitem,
         case_setitem, case_item_and_len, case_tensor_methods_patched,
         case_parameter, case_detach_and_clone, case_iteration_terminates,
         case_out_of_range_int_index_raises,
         case_scalar_bool_index_adds_axis]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_tensor_twin(case):
    both(case)


def case_promotion(P):
    """Creation defaults and the dtypes of mixed operands under the JAX
    package's x64 rules."""
    i32 = P.to_tensor(np.arange(3, dtype="int32"))
    i64 = P.to_tensor([1, 2, 3])
    f32 = P.to_tensor([1.0, 2.0, 3.0])
    return [name_of(P.to_tensor(2.0).dtype), name_of(P.to_tensor(True).dtype),
            name_of(P.to_tensor(np.float64(2)).dtype),
            name_of(P.to_tensor([1.0], dtype="float64").dtype),
            i32 + 1.5, i32 + 1, i32 / i32, i64 / i64, i64 + f32, f32 * 2,
            P.mean(i32), P.sum(i32), P.sum(i32 > 0), P.cumsum(i32 > 0),
            P.sqrt(i64), f32 + np.float64(1.0), i32 + P.to_tensor(
                np.array(2, "int64")), f32 + [1, 2, 3], P.where(
                f32 > 1, f32, 0.0)]


def test_promotion_twin():
    both(case_promotion)


def case_out_of_range_indices(P):
    """The JAX ops' modes for indices out of range: gather-style ops fill
    (``gather``, ``index_select``, ``take_along_axis``, ``index_sample``)
    or clamp (``x[idx]``, ``gather_nd``, ``take``), scatter-style ops drop
    the update; none raises."""
    x = P.to_tensor(np.arange(12, dtype="float32").reshape(3, 4))
    i = P.to_tensor(np.array([2, -1, 3, -4]))
    upd = P.to_tensor(np.ones((2, 4), "float32"))
    return [P.gather(x, i), P.index_select(x, i, axis=1),
            P.take_along_axis(x, P.to_tensor([[0], [5], [-1]]), 1),
            P.index_sample(x, P.to_tensor([[0, 4], [1, -5], [3, 3]])),
            x[P.to_tensor([5, -9, 1])], P.gather_nd(x, P.to_tensor(
                [[0, 9], [-1, 1], [4, 0]])),
            P.take(x, P.to_tensor([0, 13, -1, -20])),
            P.scatter(x, P.to_tensor([1, 7]), upd),
            P.index_put(x, (P.to_tensor([0, 5]),), upd),
            P.put_along_axis(x, P.to_tensor([[0], [9], [2]]), 5.0, 1),
            P.scatter_nd_add(x, P.to_tensor([[1], [3]]), upd),
            P.gather(P.to_tensor(np.arange(6, dtype="int32")),
                     P.to_tensor([1, 8]))]


def case_ties_and_order(P):
    """Ties broken as the JAX ops break them: ``topk`` lower index first,
    a descending ``argsort`` the ascending one reversed, ``kthvalue``'s
    stable index, ``mode``'s smallest most-frequent value at its first
    index, ``median`` of an even count the mean of the middle two,
    ``unique``'s order, inverse and counts."""
    t = P.to_tensor(np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0]], "float32"))
    v, i = P.topk(t, 2)
    sv, si = P.topk(t, 3, largest=False)
    k, ki = P.kthvalue(t, 2, axis=1)
    m, mi = P.mode(P.to_tensor(np.array([[2., 1., 2., 1., 3.]], "float32")))
    u = P.unique(P.to_tensor(np.array([3, 1, 3, 2, 1, 3])),
                 return_index=True, return_inverse=True, return_counts=True)
    uc = P.unique_consecutive(P.to_tensor(np.array([1, 1, 2, 2, 2, 3, 1])),
                              return_inverse=True, return_counts=True)
    return [v, i, sv, si, P.argsort(t, axis=1, descending=True),
            P.argsort(t, axis=1), P.sort(t, axis=1, descending=True), k, ki,
            m, mi, P.median(P.to_tensor([4.0, 1.0, 3.0, 2.0])),
            P.median(t, axis=1), list(u), list(uc)]


def case_setitem_out_of_range_index_drops(P):
    """``x[idx] = v`` with an integer array index out of range drops that
    write, as JAX's ``.at[].set`` does: with grad on and off, on a
    trainable leaf under ``no_grad``, and in the grads of x and v."""
    x = P.to_tensor(np.arange(5, dtype="float32"))
    x[P.to_tensor([1, 7, -1, -9])] = 9.0
    y = P.to_tensor(np.arange(12, dtype="float32").reshape(3, 4))
    y[P.to_tensor([0, 3]), 1:] = P.to_tensor(np.full((2, 3), 5.0, "float32"))
    y[:, [2, -7]] = 1.0
    w = P.Parameter(np.zeros(4, "float32"))
    with P.no_grad():
        w[P.to_tensor([2, 4])] = 3.0
    g = P.to_tensor(np.ones(4, "float32"), stop_gradient=False)
    v = P.to_tensor(np.array([2.0, 5.0], "float32"), stop_gradient=False)
    h = g * 2
    h[P.to_tensor([1, 6])] = v
    (h * h).sum().backward()
    return [x, y, w, h, g.grad, v.grad, w.stop_gradient]


@pytest.mark.parametrize("case", [case_out_of_range_indices,
                                  case_ties_and_order,
                                  case_setitem_out_of_range_index_drops],
                         ids=lambda c: c.__name__[5:])
def test_index_modes_and_ties_twin(case):
    both(case)


def test_bf16_numpy_is_exact_f32():
    """A bf16 tensor's ``numpy()`` is its values in f32 (numpy has no
    bf16): ``np.asarray(t.numpy(), "float32")`` equals the JAX
    package's, bit for bit, as the bench step reads its loss."""
    import paddle_tpu as pt

    vals = np.array([1.0, -2.5, 3.140625, 1e-3, 65280.0], "float32")
    jt = pt.to_tensor(vals).astype("bfloat16")
    t = paddle.to_tensor(vals).astype("bfloat16")
    got = t.numpy()
    assert got.dtype == np.float32
    want = np.asarray(jt.numpy(), dtype="float32")
    np.testing.assert_array_equal(np.asarray(t.numpy(), dtype="float32"),
                                  want)
    assert float(t[1]) == -2.5 and t.tolist()[2] == 3.140625
    assert np.asarray(t).dtype == np.float32


def test_numpy_is_a_copy_and_repr_names_the_dtype():
    t = paddle.to_tensor([1.0, 2.0])
    a = t.numpy()
    a[0] = 9.0
    assert t.tolist() == [1.0, 2.0]
    assert "dtype=float32" in repr(t) and "place=cpu" in repr(t)
    assert f"{paddle.to_tensor(2.5):.1f}" == "2.5"
    assert hash(t) == id(t)


def test_set_device_is_the_default_and_its_fixture_restores_it():
    """Inside a test the autouse fixture has set the CPU; creation follows
    ``set_device``; ``gpu`` without a card raises."""
    assert paddle.get_device() == "cpu"
    assert paddle.zeros([2]).place == "cpu"
    assert paddle.to_tensor([1]).place == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            paddle.set_device("gpu")
        assert paddle.get_device() == "cpu"


def test_fixture_left_the_card_as_default():
    """After the fixture, the process default is the card again: without
    one, an entry point given no device raises."""
    from paddle_tpu_torch import device

    assert paddle.get_device() == "cpu"
    # what the fixture restores on exit: the state before it
    saved = device._current
    device._current = None
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                paddle.zeros([2])
            with pytest.raises(RuntimeError):
                paddle.get_device()
    finally:
        device._current = saved
