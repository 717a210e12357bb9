"""Shared twin harness of the op library: every ``tests/op_registry.py``
case through the JAX package and through ``paddle_tpu_torch``.

Each op's inputs are the registry spec's ``make`` arrays (the port reads
them from its numpy-only copy, ``paddle_tpu_torch.tools.op_cases``,
which ``test_torch_ops_coverage.py`` holds equal to the registry). The
JAX side calls the registry's own ``spec.fn``; the port side the case's
``call(paddle_tpu_torch, ...)``. Outputs are held at the spec's tolerance
(``op_cases.tol``) and their dtype names must be equal; grad specs are
differentiated through both tapes (the sum of every output, from f32
inputs) and the grads held at 1e-4, the registry's grad tolerance.

``CUSTOM`` checks and ``EXCLUDED`` entries get twins written against a
namespace ``P`` in :data:`CUSTOM_TWINS` and :data:`EXCLUDED_TWINS`: each
returns its outputs as numpy arrays (or None for random draws, which
cannot match JAX's threefry bits and are held by shape, range and
determinism under ``seed``), and the test compares the two packages'.
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from op_registry import CUSTOM, EXCLUDED, REGISTRY
from paddle_tpu_torch import dtypes as tdt
from paddle_tpu_torch.tools.op_cases import CASES, tol

GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's default device is the CPU for the test, then what it
    was (another test in the worker expects the card)."""
    from paddle_tpu_torch import device

    prev = device._current
    paddle.set_device("cpu")
    yield
    device._current = prev


def jax_module_names(module: str):
    import importlib

    return set(importlib.import_module(f"paddle_tpu.ops.{module}").__all__)


def registry_ids(module: str):
    names = jax_module_names(module)
    return sorted(n for n in REGISTRY if n in names)


def grad_ids(module: str):
    return [n for n in registry_ids(module) if REGISTRY[n].grad]


def custom_ids(module: str):
    names = jax_module_names(module)
    return sorted(n for n in CUSTOM if n in names)


def excluded_ids(module: str):
    names = jax_module_names(module)
    return sorted(n for n in EXCLUDED if n in names)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _dtype_name(o) -> str:
    if isinstance(o, pt.Tensor):
        return np.dtype(o.dtype).name
    if isinstance(o, paddle.Tensor):
        return tdt.dtype_name(o.dtype)
    return type(o).__name__


def _np(o):
    if isinstance(o, (pt.Tensor, paddle.Tensor)):
        return np.asarray(o.numpy())
    return np.asarray(o)


def held(jout, tout, atol, rtol, what=""):
    j, t = _flat(jout), _flat(tout)
    assert len(j) == len(t), f"{what}: {len(j)} outputs vs {len(t)}"
    for i, (a, b) in enumerate(zip(j, t)):
        assert _dtype_name(a) == _dtype_name(b), \
            f"{what} output {i}: dtype {_dtype_name(b)} != JAX {_dtype_name(a)}"
        na, nb = _np(a), _np(b)
        assert na.shape == nb.shape, f"{what} output {i}: shape"
        np.testing.assert_allclose(
            nb.astype(na.dtype) if na.dtype != nb.dtype else nb, na,
            atol=atol, rtol=rtol, equal_nan=True,
            err_msg=f"{what} output {i}")


def check_output(name):
    spec, case = REGISTRY[name], CASES[name]
    for dt in spec.dtypes:
        inputs = spec.make(dt)
        jout = spec.fn(*[pt.to_tensor(x) for x in inputs])
        tout = case.call(paddle, *[paddle.to_tensor(x) for x in inputs])
        t = tol(case, dt)
        held(jout, tout, t, t, f"{name}[{dt}]")


def _loss(outs):
    loss = None
    for o in _flat(outs):
        s = o.sum() if o.ndim > 0 else o
        loss = s if loss is None else loss + s
    return loss


def check_grad(name):
    spec, case = REGISTRY[name], CASES[name]
    inputs = spec.make("float32")
    jts = [pt.to_tensor(x, stop_gradient=False) for x in inputs]
    _loss(spec.fn(*jts)).backward()
    tts = [paddle.to_tensor(x, stop_gradient=False) for x in inputs]
    _loss(case.call(paddle, *tts)).backward()
    for i, (a, b) in enumerate(zip(jts, tts)):
        assert a.grad is not None, f"{name}: the JAX tape gave no grad {i}"
        assert b.grad is not None, f"{name}: the port gave no grad {i}"
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a.grad.numpy()),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"{name} grad {i}")


# ------------------------------------------------------------ CUSTOM twins
def _np_list(outs):
    return [_np(o) for o in _flat(outs)]


def _inplace(op_name):
    def check(P):
        x = P.to_tensor(np.ones((2, 3), np.float32))
        y = P.to_tensor(np.full((2, 3), 2.0, np.float32))
        getattr(x, op_name)(y)
        return _np_list(x)
    return check


def _rng():
    return np.random.RandomState(1234)


def _spd():
    a = _rng().randn(3, 3)
    return a @ a.T + 3 * np.eye(3)


def _recon(op, make, reconstruct, atol=1e-3):
    def check(P):
        x = make()
        outs = _np_list(op(P, P.to_tensor(x)))
        np.testing.assert_allclose(reconstruct(outs), x, atol=atol)
        return None  # signs and phases differ by library
    return check


def _lu(P):
    lu_mat, pivots = P.lu(P.to_tensor(_spd()))
    assert np.isfinite(lu_mat.numpy()).all()
    assert pivots.numpy().shape[-1] == 3
    return [lu_mat.numpy(), pivots.numpy()]


def _eig(P):
    x = _spd()
    w, v = P.eigh(P.to_tensor(x))
    wn, vn = w.numpy(), v.numpy()
    np.testing.assert_allclose(x @ vn, vn @ np.diag(wn), atol=1e-6)
    w2, _ = P.eig(P.to_tensor(x))
    np.testing.assert_allclose(np.sort(np.real(w2.numpy())), np.sort(wn),
                               atol=1e-6)
    w3 = P.eigvals(P.to_tensor(x)).numpy()
    np.testing.assert_allclose(np.sort(np.real(w3)), np.sort(wn), atol=1e-6)
    w4 = P.eigvalsh(P.to_tensor(x)).numpy()
    np.testing.assert_allclose(np.sort(w4), np.sort(wn), atol=1e-6)
    return [np.sort(wn), np.sort(np.real(w2.numpy())), np.sort(np.real(w3)),
            np.sort(w4)]


def _random(fn, shape, lo=None, hi=None, integer=False):
    def check(P):
        P.seed(77)
        a = np.asarray(fn(P).numpy())
        assert a.shape == tuple(shape)
        assert np.isfinite(a.astype("float64")).all()
        if lo is not None:
            assert (a >= lo).all() and (a <= hi).all()
        if integer:
            assert a.dtype.kind in "iu"
        P.seed(77)
        np.testing.assert_array_equal(a, np.asarray(fn(P).numpy()))
        return None
    return check


def _inplace_random(fn_name):
    def check(P):
        x = P.zeros([16, 16])
        P.seed(3)
        getattr(P, fn_name)(x)
        assert not np.allclose(x.numpy(), 0.0)
        return None
    return check


def _multiplex(P):
    i1 = np.array([[1, 2], [3, 4]], "float32")
    i2 = np.array([[5, 6], [7, 8]], "float32")
    out = P.multiplex([P.to_tensor(i1), P.to_tensor(i2)],
                      P.to_tensor(np.array([1, 0], "int32")))
    np.testing.assert_array_equal(out.numpy(), [[5, 6], [3, 4]])
    return _np_list(out)


def _index_add(P):
    x = P.to_tensor(np.zeros((3, 2), "float32"))
    out = P.index_add(x, P.to_tensor(np.array([0, 2])), 0,
                      P.to_tensor(np.ones((2, 2), "float32")))
    np.testing.assert_array_equal(out.numpy(), [[1, 1], [0, 0], [1, 1]])
    return _np_list(out)


def _polar(P):
    out = P.polar(P.to_tensor(np.array([2.0], "float32")),
                  P.to_tensor(np.array([0.0], "float32")))
    np.testing.assert_allclose(out.numpy(), [2 + 0j], atol=1e-6)
    return _np_list(out)


def _frexp(P):
    m, e = P.frexp(P.to_tensor(np.array([8.0, 0.5], "float32")))
    nm, ne = np.frexp(np.array([8.0, 0.5], "float32"))
    np.testing.assert_allclose(m.numpy(), nm)
    np.testing.assert_array_equal(e.numpy(), ne)
    return [m.numpy(), e.numpy()]


def _add_n(P):
    ts = [P.to_tensor(np.full((2, 2), float(i), "float32")) for i in range(3)]
    out = P.add_n(ts)
    np.testing.assert_array_equal(out.numpy(), np.full((2, 2), 3.0))
    return _np_list(out)


def _scatter_nd(P):
    out = P.scatter_nd(P.to_tensor(np.array([[1], [1]], "int64")),
                       P.to_tensor(np.array([2.0, 3.0], "float32")), [4])
    np.testing.assert_array_equal(out.numpy(), [0, 5, 0, 0])
    return _np_list(out)


def _broadcast_tensors(P):
    a, b = P.broadcast_tensors([P.to_tensor(np.ones((1, 3), "float32")),
                                P.to_tensor(np.ones((2, 1), "float32"))])
    assert tuple(a.shape) == (2, 3) and tuple(b.shape) == (2, 3)
    return [a.numpy(), b.numpy()]


def _vsplit(P):
    parts = P.vsplit(P.to_tensor(np.arange(40, dtype="float32").reshape(10, 4)),
                     [2, 5])
    assert [tuple(t.shape) for t in parts] == [(2, 4), (3, 4), (5, 4)]
    return _np_list(parts)


def _increment(P):
    t = P.to_tensor(np.array([1.0], "float32"))
    P.increment(t, 2.0)
    np.testing.assert_allclose(t.numpy(), [3.0])
    return _np_list(t)


def _tanh_inplace(P):
    t = P.to_tensor(np.array([0.5], "float32"))
    P.tanh_(t)
    np.testing.assert_allclose(t.numpy(), [np.tanh(0.5)], rtol=1e-6)
    return _np_list(t)


def _index_add_inplace(P):
    t = P.to_tensor(np.zeros((3, 2), "float32"))
    P.index_add_(t, P.to_tensor(np.array([0, 2])), 0,
                 P.to_tensor(np.ones((2, 2), "float32")))
    np.testing.assert_allclose(t.numpy(), [[1, 1], [0, 0], [1, 1]])
    return _np_list(t)


CUSTOM_TWINS = {
    "add_": _inplace("add_"),
    "multiply_": _inplace("multiply_"),
    "svd": _recon(lambda P, t: P.svd(t), lambda: _rng().randn(4, 3),
                  lambda o: o[0] @ np.diag(o[1]) @ o[2]),
    "qr": _recon(lambda P, t: P.qr(t), lambda: _rng().randn(4, 3),
                 lambda o: o[0] @ o[1]),
    "lu": _lu,
    "eig": _eig, "eigh": _eig, "eigvals": _eig, "eigvalsh": _eig,
    "rand": _random(lambda P: P.rand([64, 64]), (64, 64), 0.0, 1.0),
    "randn": _random(lambda P: P.randn([64, 64]), (64, 64)),
    "uniform": _random(lambda P: P.uniform([32, 32], min=-2.0, max=2.0),
                       (32, 32), -2.0, 2.0),
    "gaussian": _random(lambda P: P.gaussian([32, 32]), (32, 32)),
    "normal": _random(lambda P: P.normal(0.0, 1.0, [32]), (32,)),
    "standard_normal": _random(lambda P: P.standard_normal([32]), (32,)),
    "randint": _random(lambda P: P.randint(0, 10, [32]), (32,), 0, 9,
                       integer=True),
    "randperm": _random(lambda P: P.randperm(16), (16,), 0, 15,
                        integer=True),
    "rand_like": _random(lambda P: P.rand_like(P.zeros([8, 8])), (8, 8),
                         0.0, 1.0),
    "randint_like": _random(lambda P: P.randint_like(P.zeros([8]), 0, 5),
                            (8,), 0, 4),
    "normal_like": _random(lambda P: P.normal_like(P.zeros([8, 8])), (8, 8)),
    "bernoulli": _random(lambda P: P.bernoulli(P.full([64], 0.5)), (64,),
                         0.0, 1.0),
    "poisson": _random(lambda P: P.poisson(P.full([32], 3.0)), (32,), 0.0,
                       np.inf),
    "multinomial": _random(lambda P: P.multinomial(P.to_tensor(
        np.array([0.2, 0.3, 0.5], "float32")), 8, replacement=True), (8,),
        0, 2, integer=True),
    "uniform_": _inplace_random("uniform_"),
    "exponential_": _inplace_random("exponential_"),
    "multiplex": _multiplex,
    "index_add": _index_add,
    "polar": _polar,
    "frexp": _frexp,
    "add_n": _add_n,
    "scatter_nd": _scatter_nd,
    "broadcast_tensors": _broadcast_tensors,
    "vsplit": _vsplit,
    "increment": _increment,
    "tanh_": _tanh_inplace,
    "index_add_": _index_add_inplace,
}


def check_custom(name):
    CUSTOM[name]()  # the registry's own check, on the JAX package
    got = CUSTOM_TWINS[name](paddle)
    want = CUSTOM_TWINS[name](pt)
    if got is None:
        return
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.dtype.name == b.dtype.name, f"{name}: {b.dtype} != {a.dtype}"
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------- EXCLUDED twins
def _x(P):
    return P.to_tensor(np.arange(6, dtype="float32").reshape(2, 3) / 7 + 0.2)


def _inplace_alias(call):
    """An in-place variant: the cell written by the op equals the
    out-of-place op's result in both packages."""
    def check(P):
        x = _x(P)
        out = call(P, x)
        assert out is x or out is None
        return [x.numpy()]
    return check


EXCLUDED_TWINS = {
    "broadcast_shape": lambda P: [np.asarray(P.broadcast_shape([2, 1], [1, 3]))],
    "is_complex": lambda P: [np.asarray(P.is_complex(_x(P)))],
    "is_integer": lambda P: [np.asarray(P.is_integer(_x(P)))],
    "is_floating_point": lambda P: [np.asarray(P.is_floating_point(_x(P)))],
    "rank": lambda P: [P.rank(_x(P)).numpy()],
    "shape": lambda P: [P.shape(_x(P)).numpy()],
    "tolist": lambda P: [np.asarray(P.tolist(_x(P)))],
    "reshape_": _inplace_alias(lambda P, x: P.reshape_(x, [3, 2])),
    "unsqueeze_": _inplace_alias(lambda P, x: P.unsqueeze_(x, 0)),
    "squeeze_": _inplace_alias(
        lambda P, x: P.squeeze_(P.unsqueeze_(x, 1), 1)),
    "scatter_": _inplace_alias(lambda P, x: P.scatter_(
        x, P.to_tensor(np.array([1])), P.to_tensor(np.ones((1, 3), "float32")))),
    "ceil_": _inplace_alias(lambda P, x: P.ceil_(x)),
    "clip_": _inplace_alias(lambda P, x: P.clip_(x, 0.3, 0.6)),
    "erfinv_": _inplace_alias(lambda P, x: P.erfinv_(x)),
    "exp_": _inplace_alias(lambda P, x: P.exp_(x)),
    "flatten_": _inplace_alias(lambda P, x: P.flatten_(x)),
    "floor_": _inplace_alias(lambda P, x: P.floor_(x)),
    "lerp_": _inplace_alias(lambda P, x: P.lerp_(x, P.ones([2, 3]), 0.25)),
    "put_along_axis_": _inplace_alias(lambda P, x: P.put_along_axis_(
        x, P.to_tensor(np.array([[0], [2]])), 9.0, 1)),
    "reciprocal_": _inplace_alias(lambda P, x: P.reciprocal_(x)),
    "remainder_": _inplace_alias(lambda P, x: P.remainder_(x, 0.5)),
    "round_": _inplace_alias(lambda P, x: P.round_(P.scale_(x, 3.0))),
    "rsqrt_": _inplace_alias(lambda P, x: P.rsqrt_(x)),
    "scale_": _inplace_alias(lambda P, x: P.scale_(x, 2.0, 1.0)),
    "sigmoid_": _inplace_alias(lambda P, x: P.sigmoid_(x)),
    "sqrt_": _inplace_alias(lambda P, x: P.sqrt_(x)),
    "subtract_": _inplace_alias(lambda P, x: P.subtract_(x, P.ones([2, 3]))),
}


def check_excluded(name):
    assert EXCLUDED[name], f"{name} is excluded without a reason"
    want, got = EXCLUDED_TWINS[name](pt), EXCLUDED_TWINS[name](paddle)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype.name == b.dtype.name, f"{name}: {b.dtype} != {a.dtype}"
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)
