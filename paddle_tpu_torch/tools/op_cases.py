"""The op library's cases without the JAX package: the input factories,
dtypes, grad flags and tolerances of ``tests/op_registry.py``'s
``REGISTRY``, in numpy alone, with each op's call written against a
namespace argument ``P`` (``paddle_tpu_torch``, or the JAX package in a
test), so ``chip_smoke.py`` can run every case on the card.

``CASES[name]`` is a :class:`Case`: ``call(P, *tensors)`` runs the op on
``P.to_tensor`` of ``make(dtype)``'s arrays, for each of ``dtypes``;
``grad`` cases are also differentiated (the sum of every output, from
float32 inputs with ``stop_gradient=False``); the tolerance is ``atol``
when set, else 1e-6 for float64 and 1e-4 for the rest (``tol``).
``tests/test_torch_ops_coverage.py`` holds this copy equal to the registry:
the same names, dtypes, flags and input arrays.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

__all__ = ["Case", "CASES", "tol", "F", "F1", "I", "FI", "B"]

F = ("float32", "float64")
F1 = ("float32",)
I = ("int32", "int64")  # noqa: E741 - the registry's name
FI = F + I
B = ("bool",)


class Case:
    def __init__(self, call: Callable, make: Callable, dtypes=F,
                 grad: bool = False, atol: Optional[float] = None):
        self.call, self.make = call, make
        self.dtypes: Sequence[str] = dtypes
        self.grad, self.atol = grad, atol


def tol(case: Case, dtype: str) -> float:
    if case.atol is not None:
        return case.atol
    return 1e-6 if dtype == "float64" else 1e-4


def _rng():
    return np.random.RandomState(1234)


def r(*shape):
    def make(dt):
        a = _rng().randn(*shape)
        if dt in ("int32", "int64"):
            return (a * 4).astype(dt)
        if dt == "bool":
            return a > 0
        return a.astype(dt)
    return make


def pos(*shape):
    def make(dt):
        a = np.abs(_rng().randn(*shape)) + 0.5
        return (a * 3).astype(dt) if dt in I else a.astype(dt)
    return make


def unit(*shape):  # open interval (-1, 1)
    return lambda dt: (np.tanh(_rng().randn(*shape)) * 0.98).astype(dt)


def spd(dt):  # symmetric positive definite
    a = _rng().randn(3, 3).astype(dt)
    return a @ a.T + 3 * np.eye(3, dtype=dt)


def _nan_arr(dt):
    a = _rng().randn(3, 4).astype(dt)
    a[0, 1] = np.nan
    return a


def _randn(*shape):
    return lambda dt: _rng().randn(*shape).astype(dt)


def _by_name(name):
    return lambda P, *xs: getattr(P, name)(*xs)


CASES: Dict[str, Case] = {}


def S(name, call=None, make=None, dtypes=F, grad=False, atol=None):
    CASES[name] = Case(call or _by_name(name), make, dtypes, grad, atol)


def u(name, make=r(2, 3), dtypes=F, grad=True, **kw):
    S(name, None, lambda dt: [make(dt)], dtypes, grad, **kw)


def b2(name, mk1=r(2, 3), mk2=None, dtypes=F, grad=True, **kw):
    mk2 = mk2 or mk1
    S(name, None, lambda dt: [mk1(dt), mk2(dt)], dtypes, grad, **kw)


def _t(P, a):
    return P.to_tensor(np.asarray(a))


# ───────────────────────────── math ─────────────────────────────
u("abs")
u("acos", unit(2, 3))
u("acosh", lambda dt: (pos(2, 3)(dt) + 1.0).astype(dt))
u("asin", unit(2, 3))
u("asinh")
u("atan")
u("atanh", unit(2, 3))
u("ceil", grad=False)
u("cos")
u("cosh")
u("erf")
u("erfinv", unit(2, 3))
u("lgamma", pos(2, 3))
u("digamma", pos(2, 3))
u("i0")
u("i0e")
u("i1")
u("i1e")
u("exp")
u("expm1")
u("floor", grad=False)
u("frac", grad=False)
u("log", pos(2, 3))
u("log10", pos(2, 3))
u("log1p", pos(2, 3))
u("log2", pos(2, 3))
u("neg")
u("reciprocal", pos(2, 3))
u("round", grad=False)
u("rsqrt", pos(2, 3))
u("sigmoid")
u("sign", grad=False)
u("sin")
u("sinh")
u("sqrt", pos(2, 3))
u("square")
u("stanh")
u("tan")
u("tanh")
u("trunc", grad=False)
u("t")

b2("add", dtypes=FI)
b2("atan2")
b2("divide", r(2, 3), pos(2, 3))
b2("floor_divide", pos(2, 3), pos(2, 3), dtypes=I, grad=False)
b2("fmax")
b2("fmin")
b2("hypot")
b2("maximum", dtypes=FI, grad=False)
b2("minimum", dtypes=FI, grad=False)
b2("mod", r(2, 3), pos(2, 3), dtypes=FI, grad=False)
b2("remainder", r(2, 3), pos(2, 3), dtypes=FI, grad=False)
b2("multiply", dtypes=FI)
b2("pow", pos(2, 3), r(2, 3))
b2("subtract", dtypes=FI)

b2("matmul", _randn(4, 3), _randn(3, 5))
b2("mm", _randn(4, 3), _randn(3, 5))
b2("bmm", _randn(2, 4, 3), _randn(2, 3, 5))
b2("dot", r(5), r(5))
b2("inner", r(2, 4), r(3, 4))
b2("outer", r(3), r(4))
b2("kron", r(2, 2), r(2, 3))
S("addmm", None, lambda dt: [_randn(4, 5)(dt), _randn(4, 3)(dt),
                             _randn(3, 5)(dt)], grad=True)
S("lerp", None, lambda dt: [r(2, 3)(dt), r(2, 3)(dt),
                            np.float64(0.3).astype(dt)])
S("einsum", lambda P, a, b: P.einsum("ij,jk->ik", a, b),
  lambda dt: [_randn(4, 3)(dt), _randn(3, 5)(dt)], grad=True)

S("all", None, lambda dt: [r(2, 3)(dt)], B)
S("any", None, lambda dt: [r(2, 3)(dt)], B)
S("amax", lambda P, x: P.amax(x, axis=1), lambda dt: [r(3, 4)(dt)])
S("amin", lambda P, x: P.amin(x, axis=1), lambda dt: [r(3, 4)(dt)])
u("argmax", grad=False)
u("argmin", grad=False)
S("max", lambda P, x: P.max(x, axis=0), lambda dt: [r(3, 4)(dt)], grad=True)
S("min", lambda P, x: P.min(x, axis=0), lambda dt: [r(3, 4)(dt)], grad=True)
S("mean", lambda P, x: P.mean(x, axis=-1), lambda dt: [r(3, 4)(dt)],
  grad=True)
S("sum", lambda P, x: P.sum(x, axis=0), lambda dt: [r(3, 4)(dt)], FI,
  grad=True)
S("prod", lambda P, x: P.prod(x, axis=0), lambda dt: [pos(2, 3)(dt)],
  grad=True)
S("nanmean", None, lambda dt: [_nan_arr(dt)])
S("nansum", None, lambda dt: [_nan_arr(dt)])
S("cumsum", lambda P, x: P.cumsum(x, axis=0), lambda dt: [r(3, 4)(dt)], FI,
  grad=True)
S("cumprod", lambda P, x: P.cumprod(x, dim=0), lambda dt: [pos(2, 3)(dt)],
  grad=True)
S("diff", None, lambda dt: [r(3, 5)(dt)], FI, grad=True)
S("logsumexp", None, lambda dt: [r(3, 4)(dt)], grad=True)
S("logcumsumexp", lambda P, x: P.logcumsumexp(x, axis=0),
  lambda dt: [r(3, 4)(dt)], grad=True)
b2("allclose", grad=False)
b2("isclose", grad=False)
S("clip", lambda P, x: P.clip(x, -0.5, 0.5), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("scale", lambda P, x: P.scale(x, 2.0, 1.0), lambda dt: [r(2, 3)(dt)],
  grad=True)

# ───────────────────────────── logic ─────────────────────────────
for _name in ("equal", "not_equal", "greater_equal", "greater_than",
              "less_equal", "less_than", "equal_all"):
    b2(_name, dtypes=FI, grad=False)
for _name in ("logical_and", "logical_or", "logical_xor"):
    b2(_name, dtypes=B, grad=False)
u("logical_not", dtypes=B, grad=False)
for _name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    b2(_name, dtypes=I, grad=False)
u("bitwise_not", dtypes=I, grad=False)
for _name in ("isnan", "isinf", "isfinite"):
    u(_name, _nan_arr, grad=False)
S("is_empty", None, lambda dt: [r(2, 3)(dt)])
S("isin", None, lambda dt: [(r(2, 3)(dt) * 2).astype(dt), r(4)(dt)], I)

# ─────────────────────────── manipulation ───────────────────────────
_MASK = np.tile(np.array([True, False, True]), (2, 1))
S("reshape", lambda P, x: P.reshape(x, [3, 2]), lambda dt: [r(2, 3)(dt)], FI,
  grad=True)
S("view", lambda P, x: P.view(x, [3, 2]), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("view_as", lambda P, x, y: P.view_as(x, y),
  lambda dt: [r(2, 3)(dt), r(3, 2)(dt)])
S("transpose", lambda P, x: P.transpose(x, [1, 0]), lambda dt: [r(2, 3)(dt)],
  FI, grad=True)
S("moveaxis", lambda P, x: P.moveaxis(x, 0, 1), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("swapaxes", lambda P, x: P.swapaxes(x, 0, 1), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("concat", lambda P, x, y: P.concat([x, y], axis=0),
  lambda dt: [r(2, 3)(dt), r(2, 3)(dt)], FI, grad=True)
S("stack", lambda P, x, y: P.stack([x, y], axis=0),
  lambda dt: [r(2, 3)(dt), r(2, 3)(dt)], grad=True)
S("unstack", lambda P, x: P.unstack(x, axis=0), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("unbind", lambda P, x: P.unbind(x, axis=0), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("split", lambda P, x: P.split(x, 2, axis=1), lambda dt: [r(2, 4)(dt)],
  grad=True)
S("chunk", lambda P, x: P.chunk(x, 2, axis=1), lambda dt: [r(2, 4)(dt)],
  grad=True)
S("squeeze", lambda P, x: P.squeeze(x, axis=1),
  lambda dt: [_randn(2, 1, 3)(dt)], grad=True)
S("unsqueeze", lambda P, x: P.unsqueeze(x, 0), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("expand", lambda P, x: P.expand(x, [4, 2, 3]), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("broadcast_to", lambda P, x: P.broadcast_to(x, [4, 2, 3]),
  lambda dt: [r(2, 3)(dt)], grad=True)
S("expand_as", lambda P, x, y: P.expand_as(x, y),
  lambda dt: [r(1, 3)(dt), r(4, 3)(dt)])
S("tile", lambda P, x: P.tile(x, [2, 2]), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("flatten", None, lambda dt: [r(2, 3)(dt)], grad=True)
S("flip", lambda P, x: P.flip(x, axis=0), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("rot90", None, lambda dt: [r(2, 3)(dt)], grad=True)
S("roll", lambda P, x: P.roll(x, 1, axis=0), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("gather", lambda P, x: P.gather(x, _t(P, [2, 0])),
  lambda dt: [r(3, 4)(dt)], grad=True)
S("gather_nd", lambda P, x: P.gather_nd(x, _t(P, [[0, 1], [2, 3]])),
  lambda dt: [r(3, 4)(dt)], grad=True)
S("take_along_axis",
  lambda P, x: P.take_along_axis(x, _t(P, [[0], [2]]), 1),
  lambda dt: [r(2, 3)(dt)], grad=True)
S("put_along_axis",
  lambda P, x: P.put_along_axis(x, _t(P, [[0], [2]]), 9.0, 1),
  lambda dt: [r(2, 3)(dt)])
S("index_select",
  lambda P, x: P.index_select(x, _t(P, [2, 0]), axis=1),
  lambda dt: [r(2, 3)(dt)], grad=True)
S("index_sample",
  lambda P, x: P.index_sample(x, _t(P, [[0, 2], [1, 0]])),
  lambda dt: [r(2, 3)(dt)], grad=True)
S("masked_select", lambda P, x: P.masked_select(x, _t(P, _MASK)),
  lambda dt: [r(2, 3)(dt)])
S("masked_fill", lambda P, x: P.masked_fill(x, _t(P, _MASK), 0.0),
  lambda dt: [r(2, 3)(dt)], grad=True)
S("where", lambda P, c, x, y: P.where(c, x, y),
  lambda dt: [r(2, 3)("bool"), r(2, 3)(dt), r(2, 3)(dt)])
S("nonzero", None, lambda dt: [(r(2, 3)(dt) > 0).astype(dt)], F1)
S("scatter", lambda P, x, u_: P.scatter(x, _t(P, [1, 0]), u_),
  lambda dt: [r(3, 4)(dt), r(2, 4)(dt)])
S("scatter_nd_add",
  lambda P, x, u_: P.scatter_nd_add(x, _t(P, [[1], [0]]), u_),
  lambda dt: [r(3, 4)(dt), r(2, 4)(dt)])
S("index_put",
  lambda P, x: P.index_put(x, (_t(P, [0, 1]),),
                           P.to_tensor(np.zeros((2, 3), "float32"))),
  lambda dt: [r(3, 3)(dt)], F1)
S("slice", lambda P, x: P.slice(x, axes=[0, 1], starts=[0, 1], ends=[2, 3]),
  lambda dt: [r(3, 4)(dt)], grad=True)
S("strided_slice",
  lambda P, x: P.strided_slice(x, axes=[1], starts=[0], ends=[4],
                               strides=[2]),
  lambda dt: [r(3, 4)(dt)], grad=True)
S("crop", lambda P, x: P.crop(x, shape=[2, 2], offsets=[1, 0]),
  lambda dt: [r(3, 4)(dt)], grad=True)
S("pad", lambda P, x: P.pad(x, [1, 2, 0, 0], value=0.0),
  lambda dt: [r(2, 3)(dt)], grad=True)
S("cast", lambda P, x: P.cast(x, "float64"), lambda dt: [r(2, 3)(dt)], F1)
S("topk", lambda P, x: P.topk(x, 2, axis=1), lambda dt: [r(3, 5)(dt)])
S("sort", lambda P, x: P.sort(x, axis=1), lambda dt: [r(3, 5)(dt)], FI,
  grad=True)
S("argsort", lambda P, x: P.argsort(x, axis=1), lambda dt: [r(3, 5)(dt)])
S("searchsorted", lambda P, s, v: P.searchsorted(s, v),
  lambda dt: [np.sort(r(6)(dt)), r(4)(dt)])
S("bucketize", lambda P, v, s: P.bucketize(v, s),
  lambda dt: [r(4)(dt), np.sort(r(6)(dt))])
S("unique", None, lambda dt: [(r(2, 3)(dt) * 2).astype(dt)], I)
S("unique_consecutive", None,
  lambda dt: [np.array([1, 1, 2, 2, 2, 3, 1], dt)], I)
S("repeat_interleave", lambda P, x: P.repeat_interleave(x, 2, axis=0),
  lambda dt: [r(2, 3)(dt)], grad=True)
S("numel", None, lambda dt: [r(2, 3)(dt)])
S("shard_index",
  lambda P, x: P.shard_index(x, index_num=8, nshards=2, shard_id=0),
  lambda dt: [np.array([[0], [3], [5], [7]], dt)], ("int64",))
S("as_complex", None, lambda dt: [r(2, 3, 2)(dt)], F1)
S("as_real", lambda P, x: P.as_real(P.as_complex(x)),
  lambda dt: [r(2, 3, 2)(dt)], F1)
S("diagonal", None, lambda dt: [r(3, 4)(dt)], grad=True)
S("tensordot", lambda P, x, y: P.tensordot(x, y, axes=1),
  lambda dt: [r(2, 3)(dt), r(3, 4)(dt)], grad=True)

# ───────────────────────────── creation ─────────────────────────────
S("zeros", lambda P: P.zeros([2, 3]), lambda dt: [], F1)
S("ones", lambda P: P.ones([2, 3]), lambda dt: [], F1)
S("full", lambda P: P.full([2, 3], 7.0), lambda dt: [], F1)
S("zeros_like", None, lambda dt: [r(2, 3)(dt)])
S("ones_like", None, lambda dt: [r(2, 3)(dt)])
S("full_like", lambda P, x: P.full_like(x, 3.0), lambda dt: [r(2, 3)(dt)])
S("arange", lambda P: P.arange(0, 10, 2), lambda dt: [], F1)
S("linspace", lambda P: P.linspace(0.0, 1.0, 5), lambda dt: [], F1)
S("logspace", lambda P: P.logspace(0.0, 2.0, 3), lambda dt: [], F1)
S("eye", lambda P: P.eye(3, 4), lambda dt: [], F1)
S("diag", None, lambda dt: [r(4)(dt)])
S("diagflat", None, lambda dt: [r(2, 2)(dt)])
S("tril", None, lambda dt: [r(3, 3)(dt)], grad=True)
S("triu", None, lambda dt: [r(3, 3)(dt)], grad=True)
S("tril_indices", lambda P: P.tril_indices(3, 3), lambda dt: [], F1)
S("triu_indices", lambda P: P.triu_indices(3, 3), lambda dt: [], F1)
S("meshgrid", lambda P, x, y: P.meshgrid(x, y),
  lambda dt: [r(3)(dt), r(4)(dt)])
S("assign", None, lambda dt: [r(2, 3)(dt)])
S("clone", None, lambda dt: [r(2, 3)(dt)], grad=True)
S("complex", None, lambda dt: [r(2, 3)(dt), r(2, 3)(dt)], F1)
S("empty", lambda P: P.empty([2, 3]).shape and P.zeros([1]), lambda dt: [],
  F1)
S("empty_like",
  lambda P, x: P.to_tensor(np.zeros(P.empty_like(x).shape, "float32")),
  lambda dt: [r(2, 3)(dt)], F1)
S("to_tensor", None, lambda dt: [r(2, 3)(dt)], FI)

# ───────────────────────────── linalg ─────────────────────────────
S("norm", None, lambda dt: [r(3, 4)(dt)], grad=True)
S("cholesky", None, lambda dt: [spd(dt)])
S("inverse", None, lambda dt: [spd(dt)], atol=1e-3)
S("pinv", None, lambda dt: [r(3, 4)(dt)], atol=1e-3)
S("solve", None, lambda dt: [spd(dt), r(3, 2)(dt)], atol=1e-3)
S("triangular_solve", lambda P, a, b: P.triangular_solve(a, b, upper=False),
  lambda dt: [np.tril(spd(dt)), r(3, 2)(dt)], atol=1e-3)
S("cholesky_solve", lambda P, b, l: P.cholesky_solve(b, l, upper=False),
  lambda dt: [r(3, 2)(dt), np.linalg.cholesky(spd(dt))], atol=1e-3)
S("det", None, lambda dt: [spd(dt)], grad=True, atol=1e-3)
S("slogdet", None, lambda dt: [spd(dt)], atol=1e-3)
S("matrix_power", lambda P, x: P.matrix_power(x, 3),
  lambda dt: [r(3, 3)(dt)], atol=1e-3)
S("matrix_rank", None, lambda dt: [spd(dt)])
S("trace", None, lambda dt: [r(3, 4)(dt)], grad=True)
S("dist", None, lambda dt: [r(2, 3)(dt), (r(2, 3)(dt) * 0.5).astype(dt)],
  grad=True)
S("cdist", None, lambda dt: [r(3, 4)(dt), (r(2, 4)(dt) * 0.5).astype(dt)],
  atol=1e-3)
S("cross", None, lambda dt: [r(4, 3)(dt), (r(4, 3)(dt) * 0.5).astype(dt)],
  grad=True)
S("cov", None, lambda dt: [r(3, 6)(dt)], atol=1e-3)
S("corrcoef", None, lambda dt: [r(3, 6)(dt)], atol=1e-3)
S("histogram", lambda P, x: P.histogram(x, bins=4, min=-2, max=2),
  lambda dt: [r(20)(dt)])
S("bincount", None, lambda dt: [np.array([0, 1, 1, 3, 2, 1], dt)],
  ("int64",))
S("lstsq", lambda P, a, b: P.lstsq(a, b)[0],
  lambda dt: [r(5, 3)(dt), r(5, 2)(dt)], atol=1e-3)

# ───────────────────────────── stat ─────────────────────────────
S("var", None, lambda dt: [r(3, 4)(dt)], grad=True)
S("std", None, lambda dt: [r(3, 4)(dt)], grad=True)
S("median", None, lambda dt: [r(3, 5)(dt)])
S("nanmedian", None, lambda dt: [_nan_arr(dt)])
S("quantile", lambda P, x: P.quantile(x, 0.5), lambda dt: [r(3, 5)(dt)])
S("nanquantile", lambda P, x: P.nanquantile(x, 0.5),
  lambda dt: [_nan_arr(dt)])
S("kthvalue", lambda P, x: P.kthvalue(x, 2, axis=1),
  lambda dt: [r(3, 5)(dt)])
S("mode", lambda P, x: P.mode(x, axis=-1),
  lambda dt: [np.array([[1., 2., 2.], [3., 3., 1.]], dt)])

# ───────────────────────── extras (top-level API tail) ─────────────────────
u("logit", lambda dt: (np.abs(np.tanh(_rng().randn(2, 3))) * 0.4
                       + 0.3).astype(dt))
b2("heaviside")
u("nan_to_num", grad=False)
u("sgn", grad=False)
u("rad2deg")
u("deg2rad")
b2("gcd", mk1=lambda dt: (np.abs(_rng().randn(2, 3)) * 20 + 1).astype(dt),
   mk2=lambda dt: (np.abs(_rng().randn(2, 3)) * 7 + 2).astype(dt),
   dtypes=I, grad=False)
b2("lcm", mk1=lambda dt: (np.abs(_rng().randn(2, 3)) * 10 + 1).astype(dt),
   mk2=lambda dt: (np.abs(_rng().randn(2, 3)) * 5 + 3).astype(dt),
   dtypes=I, grad=False)
u("count_nonzero", dtypes=FI, grad=False)
b2("floor_mod", mk2=lambda dt: (np.abs(_rng().randn(2, 3)) * 2
                                + 0.5).astype(dt), grad=False)
S("mv", None, lambda dt: [r(3, 4)(dt), r(4)(dt)], grad=True)
u("real", grad=False)
u("imag", grad=False)
u("conj")
u("angle", grad=False)
S("reverse", lambda P, x: P.reverse(x, 1), lambda dt: [r(2, 3)(dt)],
  grad=True)
S("renorm", lambda P, x: P.renorm(x, 2.0, 0, 2.0), lambda dt: [r(3, 4)(dt)],
  grad=True)
S("vander", lambda P, x: P.vander(x, 4), lambda dt: [r(5)(dt)])
S("take", None, lambda dt: [r(3, 4)(dt), np.array([0, 5, 11], "int64")])
S("trapezoid", None, lambda dt: [r(3, 5)(dt)], grad=True)
S("cumulative_trapezoid", None, lambda dt: [r(3, 5)(dt)], grad=True)
