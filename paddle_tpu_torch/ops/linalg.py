"""Linear algebra ops (``paddle_tpu/ops/linalg.py``), on ``torch.linalg``.

Where the two libraries differ, the port follows the JAX package:
``eig``/``eigvals`` return real arrays when every eigenvalue is real (as
numpy, which the JAX package calls, does); ``lu``'s pivots are 1-based
int32; ``lstsq`` is the minimum-norm solution through the
pseudo-inverse, computed in f64 for f32 inputs (``torch.linalg.lstsq``
takes only the ``gels`` LAPACK routine on CUDA, which needs full rank), with
numpy's residuals (when M > N at full rank), rank and singular values;
``histogram`` is ``torch.histc`` (``torch.histogram`` has no CUDA
kernel); ``cdist`` is the direct difference formula.
"""
from __future__ import annotations

import torch

from ..autograd.engine import apply_op
from ..tensor import Tensor
from ._apply import as_value, binary, ensure_tensor, unary

__all__ = [
    "norm", "cholesky", "inverse", "pinv", "solve", "triangular_solve",
    "cholesky_solve", "svd", "qr", "eig", "eigh", "eigvals", "eigvalsh",
    "matrix_power", "matrix_rank", "det", "slogdet", "lu", "lstsq", "cov",
    "corrcoef", "histogram", "bincount", "cross", "trace", "dist", "cdist",
]

_INF = float("inf")


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    ax = _axes(axis)

    def red(fn, a):
        if ax is None and not keepdim:
            return fn(a)
        return fn(a, dim=tuple(range(a.dim())) if ax is None else ax,
                  keepdim=keepdim)

    def fn(a):
        if axis is None and p == "fro":
            return torch.sqrt(torch.sum(a * a))
        if p == "fro":
            return torch.linalg.vector_norm(a, 2, dim=ax, keepdim=keepdim)
        if p == _INF:
            return red(torch.amax, torch.abs(a))
        if p == -_INF:
            return red(torch.amin, torch.abs(a))
        if p == 0:
            return red(torch.sum, (a != 0).to(a.dtype))
        return red(torch.sum, torch.abs(a) ** p) ** (1.0 / p)

    return unary(fn, x, name="norm")


def cholesky(x, upper=False, name=None):
    return unary(lambda a: torch.linalg.cholesky(a, upper=upper), x,
                 name="cholesky")


def inverse(x, name=None):
    return unary(torch.linalg.inv, x, name="inverse")


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return unary(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                             hermitian=hermitian), x,
                 name="pinv")


def solve(x, y, name=None):
    return binary(torch.linalg.solve, x, y, name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def fn(a, b):
        if transpose:
            a, up = a.mT, not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return binary(fn, x, y, name="triangular_solve")


def cholesky_solve(x, y, upper=False, name=None):
    return binary(lambda b, chol: torch.cholesky_solve(b, chol, upper=upper),
                  x, y, name="cholesky_solve")


def svd(x, full_matrices=False, name=None):
    return apply_op(lambda a: torch.linalg.svd(a, full_matrices=full_matrices),
                    [ensure_tensor(x)], name="svd")


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return unary(lambda a: torch.linalg.qr(a, mode="r").R, x, name="qr")
    return apply_op(lambda a: torch.linalg.qr(a, mode=mode),
                    [ensure_tensor(x)], name="qr")


def _real_if_real(w: torch.Tensor) -> torch.Tensor:
    """numpy's rule for a real matrix's eigen-decomposition: real arrays
    when no eigenvalue has an imaginary part."""
    return w.real if bool((w.imag == 0).all()) else w


def eig(x, name=None):
    a = ensure_tensor(x)._value.detach()
    w, v = torch.linalg.eig(a)
    if not a.is_complex() and bool((w.imag == 0).all()):
        w, v = w.real, v.real
    return Tensor._wrap(w), Tensor._wrap(v)


def eigh(x, UPLO="L", name=None):
    return apply_op(lambda a: torch.linalg.eigh(a, UPLO=UPLO),
                    [ensure_tensor(x)], name="eigh")


def eigvals(x, name=None):
    a = ensure_tensor(x)._value.detach()
    w = torch.linalg.eigvals(a)
    return Tensor._wrap(w if a.is_complex() else _real_if_real(w))


def eigvalsh(x, UPLO="L", name=None):
    return unary(lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO), x,
                 name="eigvalsh")


def matrix_power(x, n, name=None):
    return unary(lambda a: torch.linalg.matrix_power(a, n), x,
                 name="matrix_power")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return unary(lambda a: torch.linalg.matrix_rank(
        a, rtol=tol, hermitian=hermitian).to(torch.int64), x,
        differentiable=False, name="matrix_rank")


def det(x, name=None):
    return unary(torch.linalg.det, x, name="det")


def slogdet(x, name=None):
    return unary(lambda a: torch.stack(torch.linalg.slogdet(a)), x,
                 name="slogdet")


def lu(x, pivot=True, get_infos=False, name=None):
    lu_mat, piv = apply_op(lambda a: torch.linalg.lu_factor(a, pivot=pivot),
                           [ensure_tensor(x)], name="lu")
    if get_infos:
        info = torch.zeros((), dtype=torch.int32, device=piv._value.device)
        return lu_mat, piv, Tensor._wrap(info)
    return lu_mat, piv


def lstsq(x, y, rcond=None, driver=None, name=None):
    def fn(a, b):
        dt = a.dtype
        if dt == torch.float32:
            a, b = a.double(), b.double()
        m, n = a.shape[-2], a.shape[-1]
        vec = b.dim() == a.dim() - 1
        bm = b.unsqueeze(-1) if vec else b
        sol = torch.linalg.pinv(a, rtol=rcond) @ bm
        sv = torch.linalg.svdvals(a)
        rank = torch.linalg.matrix_rank(a, rtol=rcond).to(torch.int64)
        if m > n and int(rank) == n:
            res = ((a @ sol - bm) ** 2).sum(-2)
        else:
            res = sol.new_zeros((0,))
        if vec:
            sol = sol.squeeze(-1)
        return sol.to(dt), res.to(dt), rank, sv.to(dt)

    return apply_op(fn, [ensure_tensor(x), ensure_tensor(y)], name="lstsq")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = ensure_tensor(x)
    fw = None if fweights is None else as_value(fweights, x)
    aw = None if aweights is None else as_value(aweights, x)
    return unary(lambda a: torch.cov(a if rowvar else a.T,
                                     correction=1 if ddof else 0,
                                     fweights=fw, aweights=aw), x, name="cov")


def corrcoef(x, rowvar=True, name=None):
    return unary(lambda a: torch.corrcoef(a if rowvar else a.T), x,
                 name="corrcoef")


def histogram(input, bins=100, min=0, max=0, name=None):
    x = ensure_tensor(input)
    if min != 0 or max != 0:
        lo, hi = float(min), float(max)
    else:
        lo, hi = float(x._value.min()), float(x._value.max())
    return unary(lambda a: torch.histc(a.double(), bins, lo, hi).to(
        torch.int64), x, differentiable=False, name="histogram")


def bincount(x, weights=None, minlength=0, name=None):
    x = ensure_tensor(x)
    w = None if weights is None else as_value(weights, x)

    def fn(a):
        out = torch.bincount(a.reshape(-1), w, minlength)
        return out if w is None else out.to(w.dtype)

    return unary(fn, x, differentiable=False, name="bincount")


def cross(x, y, axis=9, name=None):
    x = ensure_tensor(x)
    ax = -1
    if axis != 9:
        ax = axis
    else:
        for i, d in enumerate(x.shape):
            if d == 3:
                ax = i
                break
    return binary(lambda a, b: torch.linalg.cross(a, b, dim=ax), x, y,
                  name="cross")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return unary(lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1), x,
                 name="trace")


def dist(x, y, p=2, name=None):
    return binary(lambda a, b: torch.linalg.vector_norm((a - b).reshape(-1),
                                                        p), x, y, name="dist")


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    def fn(a, b):
        diff = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.sum(diff * diff, -1) + 1e-30)
        return torch.sum(torch.abs(diff) ** p, -1) ** (1.0 / p)

    return binary(fn, x, y, name="cdist")
