"""``paddle.linalg`` (``paddle_tpu/linalg.py``): the linear algebra ops
of :mod:`.ops.linalg` re-exported, ``inv``, and the three ops that live
only here, ``cond``, ``multi_dot`` and ``lu_unpack``, each an op of the
tape (``apply_op``) on torch.linalg.
"""
from __future__ import annotations

import torch

from .autograd.engine import apply_op
from .ops._apply import ensure_tensor, unary
from .ops.linalg import (  # noqa: F401
    bincount,
    cdist,
    cholesky,
    cholesky_solve,
    corrcoef,
    cov,
    cross,
    det,
    dist,
    eig,
    eigh,
    eigvals,
    eigvalsh,
    histogram,
    inverse,
    lstsq,
    lu,
    matrix_power,
    matrix_rank,
    norm,
    pinv,
    qr,
    slogdet,
    solve,
    svd,
    trace,
    triangular_solve,
)

inv = inverse  # Paddle's alias

_INF = float("inf")


def _matrix_norm(v: torch.Tensor, p) -> torch.Tensor:
    """The JAX package's ``cond`` norms over the last two dims."""
    if p == "fro":
        return torch.sqrt(torch.sum(v * v, dim=(-2, -1)))
    if p == "nuc":
        return torch.linalg.svdvals(v).sum(-1)
    if p in (1, -1):
        col = torch.abs(v).sum(-2)
        return col.amax(-1) if p == 1 else col.amin(-1)
    row = torch.abs(v).sum(-1)
    return row.amax(-1) if p == _INF else row.amin(-1)


def cond(x, p=None, name=None):
    """Condition number under ``p`` (None = 2): the ratio of the extreme
    singular values for ±2, else ``norm(x) * norm(inv(x))`` for
    ``"fro"``, ``"nuc"``, ±1 and ±inf. Other ``p`` raise ``ValueError``."""
    p_ = 2 if p is None else p
    if p_ in (2, -2):
        def fn(v):
            s = torch.linalg.svdvals(v)
            return (s[..., 0] / s[..., -1]) if p_ == 2 \
                else (s[..., -1] / s[..., 0])
        return unary(fn, x, name="cond")
    if p_ in ("fro", "nuc", 1, -1, _INF, -_INF):
        return unary(lambda v: _matrix_norm(v, p_)
                     * _matrix_norm(torch.linalg.inv(v), p_), x,
                     name="cond")
    raise ValueError(f"unsupported p for cond: {p!r}")


def multi_dot(x, name=None):
    """The product of a list of matrices in the cheapest association
    order (a leading or trailing 1-D vector as numpy takes it)."""
    xs = [ensure_tensor(t) for t in x]
    return apply_op(lambda *vs: torch.linalg.multi_dot(list(vs)), xs,
                    name="multi_dot")


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` from :func:`lu`'s packed factors ``x`` and 1-based
    pivots ``y`` (batched too), with ``P @ L @ U`` the factored matrix;
    ``L`` and ``U`` are None unless ``unpack_ludata``, ``P`` None unless
    ``unpack_pivots``."""
    P, L, U = apply_op(
        lambda a, piv: torch.lu_unpack(a, piv.to(torch.int32)),
        [ensure_tensor(x), ensure_tensor(y)], name="lu_unpack")
    if not unpack_ludata:
        L, U = None, None
    if not unpack_pivots:
        P = None
    return P, L, U


__all__ = [
    "cholesky", "norm", "cond", "cov", "corrcoef", "inv", "inverse", "eig",
    "eigvals", "eigh", "eigvalsh", "multi_dot", "matrix_rank", "svd", "qr",
    "lu", "lu_unpack", "matrix_power", "det", "slogdet", "solve",
    "triangular_solve", "cholesky_solve", "lstsq", "pinv", "trace", "cross",
    "dist", "cdist", "histogram", "bincount",
]
