"""The rest of the top-level tensor API (``paddle_tpu/ops/extras.py``):
numerics, complex helpers, integer math, manipulation and the
trailing-underscore in-place variants (``autograd.engine.inplace_rebind``:
out of place and rebound with grad on, in place on a leaf under
``no_grad``). ``take`` follows the JAX op's modes: ``raise`` wraps a
negative index once, then clamps, as the JAX package's does."""
from __future__ import annotations

import torch

from ..autograd.engine import apply_op, inplace_rebind
from ..tensor import Tensor
from ._apply import binary, ensure_tensor, inexact, unary
from .math import _tensors, clip_tensor

__all__ = [
    "logit", "mv", "floor_mod", "multiplex", "real", "imag", "conj",
    "rad2deg", "deg2rad", "gcd", "lcm", "count_nonzero", "increment",
    "scatter_nd", "reverse", "add_n", "angle", "renorm", "nan_to_num",
    "heaviside", "index_add", "index_add_", "sgn", "take", "frexp", "trapezoid",
    "cumulative_trapezoid", "polar", "vander", "broadcast_tensors",
    "broadcast_shape", "is_complex", "is_integer", "is_floating_point",
    "rank", "shape", "tolist", "tanh_", "reshape_", "unsqueeze_",
    "squeeze_", "scatter_", "vsplit", "ceil_", "exp_", "floor_",
    "reciprocal_", "round_", "rsqrt_", "sqrt_", "scale_", "remainder_",
    "subtract_", "clip_", "flatten_", "lerp_", "erfinv_", "sigmoid_",
    "put_along_axis_",
]

_wrap = Tensor._wrap


# ------------------------------------------------------------- numerics
def logit(x, eps=None, name=None):
    def fn(v):
        v = inexact(v)
        if eps is not None:
            v = clip_tensor(v, eps, 1.0 - eps)
        return torch.log(v) - torch.log1p(-v)

    return unary(fn, x, name="logit")


def _heaviside(a, b):
    """jnp.heaviside's selects (torch.heaviside has no derivative): ``a``
    gets a zero gradient through ``sign``, as in JAX, not none."""
    s = torch.sign(a)
    return torch.where((s == 0) | torch.isnan(a), b, (s + 1) / 2)


def heaviside(x, y, name=None):
    return binary(_tensors(_heaviside), x, y, name="heaviside")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return unary(lambda v: torch.nan_to_num(v, nan, posinf, neginf), x,
                 name="nan_to_num")


def sgn(x, name=None):
    """Sign; for complex inputs ``x / |x|``."""
    return unary(torch.sgn, x, name="sgn")


def frexp(x, name=None):
    return apply_op(lambda v: tuple(torch.frexp(v)), [ensure_tensor(x)],
                    name="frexp")


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = ensure_tensor(y)
    if x is not None:
        return apply_op(lambda yy, xx: torch.trapezoid(yy, xx, dim=axis),
                        [y, ensure_tensor(x, y)], name="trapezoid")
    d = 1.0 if dx is None else dx
    return apply_op(lambda yy: torch.trapezoid(yy, dx=d, dim=axis), [y],
                    name="trapezoid")


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = ensure_tensor(y)

    def fn(yy, xx=None):
        n = yy.shape[axis]
        lo = torch.narrow(yy, axis, 0, n - 1)
        hi = torch.narrow(yy, axis, 1, n - 1)
        if xx is not None:
            widths = (torch.narrow(xx, axis, 1, n - 1)
                      - torch.narrow(xx, axis, 0, n - 1))
        else:
            widths = 1.0 if dx is None else dx
        return torch.cumsum((lo + hi) * 0.5 * widths, axis)

    if x is not None:
        return apply_op(fn, [y, ensure_tensor(x, y)],
                        name="cumulative_trapezoid")
    return apply_op(fn, [y], name="cumulative_trapezoid")


def rad2deg(x, name=None):
    return unary(lambda v: torch.rad2deg(
        v if v.is_floating_point() else v.to(torch.float32)), x,
        name="rad2deg")


def deg2rad(x, name=None):
    return unary(lambda v: torch.deg2rad(
        v if v.is_floating_point() else v.to(torch.float32)), x,
        name="deg2rad")


def gcd(x, y, name=None):
    return binary(_tensors(torch.gcd), x, y, name="gcd")


def lcm(x, y, name=None):
    return binary(_tensors(torch.lcm), x, y, name="lcm")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def fn(v):
        nz = v != 0
        if axis is None and not keepdim:
            return nz.sum()
        dims = tuple(range(v.dim())) if axis is None else axis
        return nz.sum(dims, keepdim=keepdim)

    return unary(fn, x, differentiable=False, name="count_nonzero")


def increment(x, value=1.0, name=None):
    """In-place add of a scalar."""
    x = ensure_tensor(x)
    out = unary(lambda v: v + torch.tensor(value, dtype=v.dtype,
                                           device=v.device), x,
                name="increment")
    return inplace_rebind(x, out)


def floor_mod(x, y, name=None):
    from .math import mod

    return mod(x, y)


def mv(x, vec, name=None):
    x = ensure_tensor(x)
    return apply_op(lambda m, v: m @ v, [x, ensure_tensor(vec, x)],
                    name="mv")


# -------------------------------------------------------------- complex
def real(x, name=None):
    return unary(torch.real, x, name="real")


def imag(x, name=None):
    return unary(lambda v: torch.imag(v) if v.is_complex()
                 else torch.zeros_like(v), x, name="imag")


def conj(x, name=None):
    return unary(lambda v: torch.conj(v).resolve_conj(), x, name="conj")


def angle(x, name=None):
    return unary(torch.angle, x, name="angle")


def polar(abs, angle, name=None):
    r = ensure_tensor(abs)
    return apply_op(lambda m, t: torch.polar(m.float(), t.float()),
                    [r, ensure_tensor(angle, r)], name="polar")


# --------------------------------------------------------- manipulation
def multiplex(inputs, index, name=None):
    """Row-wise select: ``out[i] = inputs[index[i]][i]``."""
    ts = [ensure_tensor(t) for t in inputs]
    idx = ensure_tensor(index, ts[0])

    def fn(ix, *cands):
        stacked = torch.stack(cands)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        from .manipulation import clip_index

        return stacked[clip_index(ix.reshape(-1), len(cands)), rows]

    return apply_op(fn, [idx] + ts, name="multiplex")


def _index_add_impl(v, ix, axis, val):
    from .manipulation import checked_index

    moved = torch.movedim(v, axis, 0)
    valm = torch.movedim(val, axis, 0).to(v.dtype)
    safe, ok = checked_index(ix.reshape(-1), moved.shape[0])
    ok = ok.reshape((-1,) + (1,) * (valm.dim() - 1))
    out = moved.index_add(0, safe, torch.where(ok, valm,
                                               torch.zeros_like(valm)))
    return torch.movedim(out, 0, axis)


def index_add(x, index, axis, value, name=None):
    x = ensure_tensor(x)
    return apply_op(lambda v, ix, val: _index_add_impl(v, ix, axis, val),
                    [x, ensure_tensor(index, x), ensure_tensor(value, x)],
                    name="index_add")


def index_add_(x, index, axis, value, name=None):
    """In-place ``index_add``."""
    x = ensure_tensor(x)
    return inplace_rebind(x, index_add(x, index, axis, value))


def take(x, index, mode="raise", name=None):
    """Flat-index gather."""
    if mode not in ("raise", "wrap", "clip"):
        raise ValueError("mode must be 'raise', 'wrap' or 'clip'")

    def fn(v, ix):
        flat = v.reshape(-1)
        n = flat.shape[0]
        ixf = ix.to(torch.int64)
        if mode == "wrap":
            ixf = torch.remainder(ixf, n)
        elif mode == "clip":
            ixf = ixf.clamp(0, n - 1)
        else:  # as the JAX package: a negative index wraps once, then clamps
            ixf = torch.where(ixf < 0, ixf + n, ixf)
            ixf = torch.where(ixf < 0, ixf + n, ixf).clamp(0, n - 1)
        return flat[ixf]

    x = ensure_tensor(x)
    return apply_op(fn, [x, ensure_tensor(index, x)], name="take")


def reverse(x, axis, name=None):
    from .manipulation import flip

    return flip(x, axis)


def add_n(inputs, name=None):
    seq = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    ts = [ensure_tensor(t) for t in seq]

    def fn(*vs):
        out = vs[0]
        for v in vs[1:]:
            out = out + v
        return out

    return apply_op(fn, ts, name="add_n")


def scatter_nd(index, updates, shape, name=None):
    up = ensure_tensor(updates)

    def fn(ix, u):
        from .manipulation import _nd_index

        out = torch.zeros(tuple(int(s) for s in shape), dtype=u.dtype,
                          device=u.device)
        parts, ok = _nd_index(ix, out.shape)
        ok = ok.reshape(ok.shape + (1,) * (u.dim() - ok.dim()))
        return out.index_put(parts, torch.where(ok, u, torch.zeros_like(u)),
                             accumulate=True)

    return apply_op(fn, [ensure_tensor(index, up), up], name="scatter_nd")


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` clamped to p-norm <= ``max_norm``."""
    def fn(v):
        moved = torch.movedim(v, axis, 0)
        flat = moved.reshape(moved.shape[0], -1)
        norms = torch.linalg.vector_norm(flat, p, dim=1)
        scale = torch.where(norms > max_norm,
                            max_norm / torch.clamp(norms, min=1e-12),
                            torch.ones_like(norms))
        out = flat * scale[:, None]
        return torch.movedim(out.reshape(moved.shape), 0, axis)

    return unary(fn, x, name="renorm")


def vander(x, n=None, increasing=False, name=None):
    return unary(lambda v: torch.vander(v, N=n, increasing=increasing), x,
                 name="vander")


def broadcast_tensors(inputs, name=None):
    ts = [ensure_tensor(t) for t in inputs]
    shape = torch.broadcast_shapes(*[t._value.shape for t in ts])
    return [apply_op(lambda v: torch.broadcast_to(v, shape), [t],
                     name="broadcast_tensors") for t in ts]


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def vsplit(x, num_or_indices, name=None):
    x = ensure_tensor(x)
    if x.ndim < 2:
        raise ValueError("vsplit expects a tensor of rank >= 2")
    n = x.shape[0]
    if isinstance(num_or_indices, int):
        if n % num_or_indices != 0:
            raise ValueError(f"dim 0 ({n}) not divisible by "
                             f"{num_or_indices}")
        bounds = [n // num_or_indices * i for i in range(1, num_or_indices)]
    else:
        # a list is split indices (numpy's meaning), not section sizes
        bounds = [int(i) for i in num_or_indices]
    edges = [0] + bounds + [n]
    return [apply_op(lambda v, lo=lo, hi=hi: v[lo:hi], [x], name="vsplit")
            for lo, hi in zip(edges[:-1], edges[1:])]


# ----------------------------------------------------------- predicates
def is_complex(x) -> bool:
    return ensure_tensor(x)._value.is_complex()


def is_integer(x) -> bool:
    v = ensure_tensor(x)._value
    return not (v.is_floating_point() or v.is_complex()
                or v.dtype == torch.bool)


def is_floating_point(x) -> bool:
    return ensure_tensor(x)._value.is_floating_point()


def rank(input):
    v = ensure_tensor(input)._value
    return _wrap(torch.tensor(v.dim(), dtype=torch.int32, device=v.device))


def shape(input):
    v = ensure_tensor(input)._value
    return _wrap(torch.tensor(list(v.shape), dtype=torch.int32,
                              device=v.device))


def tolist(x):
    return ensure_tensor(x).numpy().tolist()


# -------------------------------------------------------------- inplace
def _inplace(fn_name, x, *args, **kwargs):
    from . import manipulation, math

    x = ensure_tensor(x)
    fn = getattr(math, fn_name, None) or getattr(manipulation, fn_name)
    return inplace_rebind(x, fn(x, *args, **kwargs))


def tanh_(x, name=None):
    return _inplace("tanh", x)


def reshape_(x, shape, name=None):
    return _inplace("reshape", x, shape)


def unsqueeze_(x, axis, name=None):
    return _inplace("unsqueeze", x, axis)


def squeeze_(x, axis=None, name=None):
    return _inplace("squeeze", x, axis)


def scatter_(x, index, updates, overwrite=True, name=None):
    from .manipulation import scatter

    x = ensure_tensor(x)
    return inplace_rebind(x, scatter(x, index, updates, overwrite=overwrite))


def ceil_(x, name=None):
    return _inplace("ceil", x)


def exp_(x, name=None):
    return _inplace("exp", x)


def floor_(x, name=None):
    return _inplace("floor", x)


def reciprocal_(x, name=None):
    return _inplace("reciprocal", x)


def round_(x, name=None):
    return _inplace("round", x)


def rsqrt_(x, name=None):
    return _inplace("rsqrt", x)


def sqrt_(x, name=None):
    return _inplace("sqrt", x)


def scale_(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
           name=None):
    return _inplace("scale", x, scale, bias, bias_after_scale, act)


def remainder_(x, y, name=None):
    return _inplace("mod", x, y)


def subtract_(x, y, name=None):
    return _inplace("subtract", x, y)


def clip_(x, min=None, max=None, name=None):
    return _inplace("clip", x, min, max)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _inplace("flatten", x, start_axis, stop_axis)


def lerp_(x, y, weight, name=None):
    return _inplace("lerp", x, y, weight)


def erfinv_(x, name=None):
    return _inplace("erfinv", x)


def sigmoid_(x, name=None):
    return _inplace("sigmoid", x)


def put_along_axis_(arr, indices, values, axis, reduce="assign", name=None):
    return _inplace("put_along_axis", arr, indices, values, axis, reduce)
