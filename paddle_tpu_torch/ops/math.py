"""Elementwise math, matmul, reductions (``paddle_tpu/ops/math.py``).

Each op is one torch call (or a few) on its inputs' values; dtypes
follow the JAX package under ``jax_enable_x64`` (``_apply``): an integer
input to an op that gives floats becomes float32 (int64: float64),
``sum``/``prod`` of int32 or bool give int64 and ``cumsum``/``cumprod``
keep their input's integer dtype (bool: int64). ``matmul`` of f32 runs at full f32
precision (TF32 stays off, as the JAX package runs f32 matmuls at
``highest``).
"""
from __future__ import annotations

import torch

from .. import dtypes
from ..autograd.engine import apply_op, inplace_rebind
from ..tensor import Tensor
from ._apply import binary, ensure_tensor, inexact, unary

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder", "mod",
    "pow", "matmul", "scale", "exp", "expm1", "log", "log2", "log10", "log1p",
    "sqrt", "rsqrt", "square", "abs", "neg", "sign", "floor", "ceil", "round",
    "trunc", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "sigmoid", "reciprocal", "maximum",
    "minimum", "fmax", "fmin", "clip", "sum", "mean", "max", "min", "prod",
    "all", "any", "argmax", "argmin", "cumsum", "cumprod", "logsumexp",
    "logcumsumexp", "einsum", "dot", "mm", "bmm", "t", "multiply_", "add_",
    "addmm", "inner", "outer", "kron", "diff", "nanmean", "nansum", "amax",
    "amin", "lerp", "erf", "erfinv", "stanh", "atan2", "hypot", "frac",
    "isclose", "allclose", "lgamma", "digamma", "i0", "i0e", "i1", "i1e",
]


def _tensors(fn, to_inexact=False):
    """``fn`` of two values where torch wants tensors: a scalar becomes a
    tensor of the other's dtype and device."""
    def op(a, b):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        elif not isinstance(b, torch.Tensor):
            b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        if to_inexact:
            a, b = inexact(a), inexact(b)
        return fn(a, b)

    op.__name__ = fn.__name__
    return op


# -------------------------------------------------------------- elementwise
def add(x, y, name=None):
    return binary(torch.add, x, y, name="add")


def subtract(x, y, name=None):
    return binary(torch.subtract, x, y, name="subtract")


def multiply(x, y, name=None):
    return binary(torch.multiply, x, y, name="multiply")


_div = _tensors(torch.true_divide, to_inexact=True)


def divide(x, y, name=None):
    return binary(_div, x, y, name="divide")


def floor_divide(x, y, name=None):
    return binary(torch.floor_divide, x, y, differentiable=False,
                  name="floor_divide")


def remainder(x, y, name=None):
    return binary(torch.remainder, x, y, differentiable=False,
                  name="remainder")


mod = remainder


def pow(x, y, name=None):
    return binary(torch.pow, x, y, name="pow")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    """``out = x * scale + bias`` (or ``(x + bias) * scale``)."""
    s, b = scale, bias

    def fn(a):
        if not a.is_floating_point() and isinstance(s + b, float):
            a = a.to(torch.float64)
        return a * s + b if bias_after_scale else (a + b) * s

    out = unary(fn, x, name="scale")
    if act is not None:
        from ..nn import functional as F

        out = apply_op(getattr(F, act), [out], name=act)
    return out


# ------------------------------------------- JAX's gradients at the kinks
class _Abs(torch.autograd.Function):
    """``torch.abs``'s values, ``jnp.abs``'s gradient: ``g`` where
    ``x >= 0`` (0 and -0.0 included), ``-g`` elsewhere (NaN included);
    ``torch.abs`` gives 0 at 0."""

    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return torch.abs(a)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return torch.where(a >= 0, g, -g)


def abs_tensor(a: torch.Tensor) -> torch.Tensor:
    """``|a|`` with the JAX package's gradient at 0 (:class:`_Abs`) for a
    real floating tensor that needs one; else ``torch.abs``."""
    if a.requires_grad and a.is_floating_point():
        return _Abs.apply(a)
    return torch.abs(a)


def clip_tensor(a: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip(a, lo, hi)`` (and ``jnp.maximum``/``minimum`` against a
    bound), with its gradient: half at a tie, as torch's ``maximum`` and
    ``minimum`` give it, where ``clamp`` passes all of it. A scalar bound
    becomes a 0-d fill of ``a``'s dtype on its device (no host copy);
    a non-float ``a`` takes ``clamp`` (no gradient to split)."""
    if not a.is_floating_point():
        return torch.clamp(a, lo, hi)
    if lo is not None:
        a = torch.maximum(a, lo if isinstance(lo, torch.Tensor)
                          else a.new_full((), lo))
    if hi is not None:
        a = torch.minimum(a, hi if isinstance(hi, torch.Tensor)
                          else a.new_full((), hi))
    return a


def _unary_factory(fn, name, differentiable=True, floats=True):
    """An elementwise op; ``floats``: an integer input becomes inexact
    first (``_apply.inexact``)."""
    f = (lambda a: fn(inexact(a))) if floats else fn

    def op(x, name_=None):
        return unary(f, x, differentiable=differentiable, name=name)

    op.__name__ = name
    return op


exp = _unary_factory(torch.exp, "exp")
expm1 = _unary_factory(torch.expm1, "expm1")
log = _unary_factory(torch.log, "log")
log2 = _unary_factory(torch.log2, "log2")
log10 = _unary_factory(torch.log10, "log10")
log1p = _unary_factory(torch.log1p, "log1p")
sqrt = _unary_factory(torch.sqrt, "sqrt")
rsqrt = _unary_factory(torch.rsqrt, "rsqrt")
square = _unary_factory(torch.square, "square", floats=False)
abs = _unary_factory(abs_tensor, "abs", floats=False)
neg = _unary_factory(torch.neg, "neg", floats=False)
sign = _unary_factory(torch.sign, "sign", differentiable=False, floats=False)
floor = _unary_factory(torch.floor, "floor", differentiable=False,
                       floats=False)
ceil = _unary_factory(torch.ceil, "ceil", differentiable=False, floats=False)
round = _unary_factory(torch.round, "round", differentiable=False,
                       floats=False)
trunc = _unary_factory(torch.trunc, "trunc", differentiable=False,
                       floats=False)
sin = _unary_factory(torch.sin, "sin")
cos = _unary_factory(torch.cos, "cos")
tan = _unary_factory(torch.tan, "tan")
asin = _unary_factory(torch.asin, "asin")
acos = _unary_factory(torch.acos, "acos")
atan = _unary_factory(torch.atan, "atan")
sinh = _unary_factory(torch.sinh, "sinh")
cosh = _unary_factory(torch.cosh, "cosh")
tanh = _unary_factory(torch.tanh, "tanh")
asinh = _unary_factory(torch.asinh, "asinh")
acosh = _unary_factory(torch.acosh, "acosh")
atanh = _unary_factory(torch.atanh, "atanh")
sigmoid = _unary_factory(torch.sigmoid, "sigmoid")
reciprocal = _unary_factory(torch.reciprocal, "reciprocal")
erf = _unary_factory(torch.erf, "erf")
erfinv = _unary_factory(torch.erfinv, "erfinv")
lgamma = _unary_factory(torch.lgamma, "lgamma")
digamma = _unary_factory(torch.digamma, "digamma")
i0 = _unary_factory(torch.i0, "i0")
i0e = _unary_factory(torch.special.i0e, "i0e")
i1 = _unary_factory(torch.special.i1, "i1")
i1e = _unary_factory(torch.special.i1e, "i1e")


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return unary(lambda a: scale_b * torch.tanh(scale_a * inexact(a)), x,
                 name="stanh")


def frac(x, name=None):
    return unary(lambda a: a - torch.trunc(a), x, name="frac")


def atan2(x, y, name=None):
    return binary(_tensors(torch.atan2, to_inexact=True), x, y, name="atan2")


def hypot(x, y, name=None):
    return binary(_tensors(torch.hypot, to_inexact=True), x, y, name="hypot")


def maximum(x, y, name=None):
    return binary(_tensors(torch.maximum), x, y, name="maximum")


def minimum(x, y, name=None):
    return binary(_tensors(torch.minimum), x, y, name="minimum")


def _fmax(a, b):
    # jnp.fmax's select: a tie takes b, so b gets the whole gradient there
    return torch.where((a > b) | torch.isnan(b), a, b)


def _fmin(a, b):
    return torch.where((a < b) | torch.isnan(b), a, b)


def fmax(x, y, name=None):
    return binary(_tensors(_fmax), x, y, name="fmax")


def fmin(x, y, name=None):
    return binary(_tensors(_fmin), x, y, name="fmin")


def lerp(x, y, weight, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    if isinstance(weight, Tensor):
        return apply_op(lambda a, b, w: a + w * (b - a), [x, y, weight],
                        name="lerp")
    return apply_op(lambda a, b: a + weight * (b - a), [x, y], name="lerp")


def clip(x, min=None, max=None, name=None):
    lo = min._value if isinstance(min, Tensor) else min
    hi = max._value if isinstance(max, Tensor) else max
    return unary(lambda a: clip_tensor(a, lo, hi), x, name="clip")


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    fn = _tensors(lambda a, b: torch.isclose(a, b, rtol, atol, equal_nan))
    return binary(fn, x, y, differentiable=False, name="isclose")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    fn = _tensors(lambda a, b: torch.isclose(a, b, rtol, atol,
                                             equal_nan).all())
    return binary(fn, x, y, differentiable=False, name="allclose")


# ------------------------------------------------------------------- matmul
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x and a.dim() >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() >= 2:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return binary(fn, x, y, name="matmul")


def dot(x, y, name=None):
    return binary(lambda a, b: (a * b).sum(-1), x, y, name="dot")


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return matmul(x, y)


def t(x, name=None):
    return unary(lambda a: a.permute(*reversed(range(a.dim()))), x, name="t")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply_op(lambda i, a, b: beta * i + alpha * torch.matmul(a, b),
                    [ensure_tensor(input), ensure_tensor(x), ensure_tensor(y)],
                    name="addmm")


def inner(x, y, name=None):
    return binary(torch.inner, x, y, name="inner")


def outer(x, y, name=None):
    return binary(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)), x, y,
                  name="outer")


def kron(x, y, name=None):
    return binary(torch.kron, x, y, name="kron")


def einsum(equation, *operands):
    ts = [ensure_tensor(o) for o in operands]
    return apply_op(lambda *vs: torch.einsum(equation, *vs), ts, name="einsum")


# --------------------------------------------------------------- reductions
def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    if isinstance(axis, Tensor):
        return tuple(int(a) for a in axis.numpy().reshape(-1))
    return int(axis)


def _dims(a, ax):
    """``ax`` as torch's ``dim``: every axis for None."""
    if ax is None:
        return tuple(range(a.dim()))
    return ax


def _reduce(fn, a, ax, keepdim):
    if ax is None and not keepdim:
        return fn(a)
    return fn(a, dim=_dims(a, ax), keepdim=keepdim)


def _prod(a, dim=None, keepdim=False):
    if dim is None:
        return torch.prod(a)
    dims = (dim,) if isinstance(dim, int) else dim
    out = a
    for d in sorted((d % a.dim() for d in dims), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _mean(a, dim=None, keepdim=False):
    a = inexact(a)
    return torch.mean(a) if dim is None else torch.mean(a, dim, keepdim)


def _nanmean(a, dim=None, keepdim=False):
    a = inexact(a)
    return torch.nanmean(a) if dim is None else torch.nanmean(a, dim, keepdim)


def _reduce_factory(fn, name, differentiable=True):
    def op(x, axis=None, keepdim=False, name_=None):
        ax = _norm_axis(axis)
        return unary(lambda a: _reduce(fn, a, ax, keepdim), x,
                     differentiable=differentiable, name=name)

    op.__name__ = name
    return op


sum = _reduce_factory(torch.sum, "sum")
mean = _reduce_factory(_mean, "mean")
max = _reduce_factory(torch.amax, "max")
min = _reduce_factory(torch.amin, "min")
prod = _reduce_factory(_prod, "prod")
amax = _reduce_factory(torch.amax, "amax")
amin = _reduce_factory(torch.amin, "amin")
all = _reduce_factory(torch.all, "all", differentiable=False)
any = _reduce_factory(torch.any, "any", differentiable=False)
nansum = _reduce_factory(torch.nansum, "nansum")
nanmean = _reduce_factory(_nanmean, "nanmean")


def _arg_factory(fn, name):
    def op(x, axis=None, keepdim=False, dtype="int64", name_=None):
        dt = dtypes.convert_dtype(dtype)

        def f(a):
            if axis is None:
                out = fn(a.reshape(-1))
                return (out.reshape((1,) * a.dim()) if keepdim else out).to(dt)
            return fn(a, dim=int(axis), keepdim=keepdim).to(dt)

        return unary(f, x, differentiable=False, name=name)

    op.__name__ = name
    return op


argmax = _arg_factory(torch.argmax, "argmax")
argmin = _arg_factory(torch.argmin, "argmin")


def _keep_int(out, a, dt):
    """A scan of an integer input keeps its dtype, as ``jnp.cumsum`` and
    ``jnp.cumprod`` do (torch widens to int64); bool becomes int64."""
    if dt is None and not (a.is_floating_point() or a.is_complex()
                           or a.dtype == torch.bool):
        return out.to(a.dtype)
    return out


def cumsum(x, axis=None, dtype=None, name=None):
    dt = dtypes.convert_dtype(dtype)

    def fn(a):
        if axis is None:
            a, ax = a.reshape(-1), 0
        else:
            ax = int(axis)
        return _keep_int(torch.cumsum(a, ax, dtype=dt), a, dt)

    return unary(fn, x, name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    dt = dtypes.convert_dtype(dtype)

    def fn(a):
        if dim is None:
            a, ax = a.reshape(-1), 0
        else:
            ax = int(dim)
        return _keep_int(torch.cumprod(a, ax, dtype=dt), a, dt)

    return unary(fn, x, name="cumprod")


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return unary(lambda a: torch.logsumexp(inexact(a), _dims(a, ax), keepdim),
                 x, name="logsumexp")


def logcumsumexp(x, axis=None, name=None):
    def fn(a):
        if axis is None:
            return torch.logcumsumexp(inexact(a).reshape(-1), 0)
        return torch.logcumsumexp(inexact(a), int(axis))

    return unary(fn, x, name="logcumsumexp")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = ensure_tensor(x)
    pre = None if prepend is None else ensure_tensor(prepend, x)._value
    app = None if append is None else ensure_tensor(append, x)._value
    return unary(lambda a: torch.diff(a, n, axis, pre, app), x, name="diff")


# --------------------------------------------------------------- inplace-ish
def add_(x, y, name=None):
    return inplace_rebind(x, add(x, y))


def multiply_(x, y, name=None):
    return inplace_rebind(x, multiply(x, y))
