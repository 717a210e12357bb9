"""BFGS, L-BFGS and the strong-Wolfe line search in torch: the iterations
of ``jax.scipy.optimize`` (``bfgs.py``, ``_lbfgs.py``,
``line_search.py``), written as Python loops.

Each quantity keeps the dtype it has there: the position, the values and
the step lengths are f32 tensors on the position's device; counts and
flags are Python values. jax evaluates every branch of a step and
selects; here the branch taken is read on the host (one scalar a
decision), which gives the same iterates. Constants as there: c1 1e-4,
c2 0.9; the first trial step 1, or for BFGS ``min(1, 2.02 (f - f_prev)
/ g.p)``; zoom by cubic, else quadratic, else bisection (guards 0.2 and
0.1 of the bracket), failing at 30 trials or at a bracket of 1e-5
(f32), a bracket of negative length included; a step below 1e-8 set to
1e-8 (with its sign).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

C1, C2 = 1e-4, 0.9
ZOOM_MAXITER = 30
ZOOM_MIN_BRACKET = 1e-5   # jax's threshold below 64 bits
MIN_STEP = 1e-8


class Result(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    jac: torch.Tensor
    success: bool
    nfev: int
    nit: int


class _Search(NamedTuple):
    failed: bool
    nfev: int
    a_k: torch.Tensor
    f_k: torch.Tensor
    g_k: torch.Tensor


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d2_0 = fb - fa - C * db
    d2_1 = fc - fa - C * dc
    A = (dc ** 2 * d2_0 + (-db ** 2) * d2_1) / denom
    B = ((-dc ** 3) * d2_0 + db ** 3 * d2_1) / denom
    radical = B * B - 3. * A * C
    return a + (-B + torch.sqrt(radical)) / (3. * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2. * B)


def _zoom(restricted, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo, a_hi,
          phi_hi, dphi_hi, g_0):
    """jax's ``_zoom``: ``(failed, nfev, a_star, phi_star, g_star)``."""
    a_rec = (a_lo + a_hi) / 2.
    phi_rec = (phi_lo + phi_hi) / 2.
    a_star = torch.ones_like(a_lo)
    phi_star, g_star = phi_lo, g_0
    done = failed = False
    j = nfev = 0
    while not done and not failed:
        dalpha = a_hi - a_lo
        a = torch.minimum(a_hi, a_lo)
        b = torch.maximum(a_hi, a_lo)
        cchk = 0.2 * dalpha
        qchk = 0.1 * dalpha
        failed = failed or bool(dalpha <= ZOOM_MIN_BRACKET)
        a_j = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec, phi_rec)
        if not (j > 0 and bool((a_j > a + cchk) & (a_j < b - cchk))):
            a_j = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
            if not bool((a_j > a + qchk) & (a_j < b - qchk)):
                a_j = (a_lo + a_hi) / 2.
        phi_j, dphi_j, g_j = restricted(a_j)
        nfev += 1
        hi_to_j = bool(wolfe_one(a_j, phi_j) | (phi_j >= phi_lo))
        star_to_j = bool(wolfe_two(dphi_j)) and not hi_to_j
        if hi_to_j:
            a_rec, phi_rec = a_hi, phi_hi
            a_hi, phi_hi, dphi_hi = a_j, phi_j, dphi_j
        elif star_to_j:
            done = True
            a_star, phi_star, g_star = a_j, phi_j, g_j
        else:
            if bool(dphi_j * (a_hi - a_lo) >= 0.):
                a_rec, phi_rec = a_hi, phi_hi
                a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
            else:
                a_rec, phi_rec = a_lo, phi_lo
            a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
        j += 1
        failed = failed or j >= ZOOM_MAXITER
    return failed, nfev, a_star, phi_star, g_star


def line_search(vg: Callable, xk, pk, old_fval, gfk, old_old_fval=None,
                maxiter: int = 20) -> _Search:
    """jax's strong-Wolfe ``line_search`` from ``xk`` along ``pk``, given
    the value and gradient there."""
    def restricted(t):
        phi, g = vg(xk + t * pk)
        return phi, g @ pk, g

    phi_0 = old_fval
    dphi_0 = gfk @ pk
    if old_old_fval is not None:
        cand = 1.01 * 2 * (phi_0 - old_old_fval) / dphi_0
        start = torch.where(cand > 1, torch.ones_like(cand), cand)
    else:
        start = torch.ones_like(phi_0)

    def wolfe_one(a_i, phi_i):
        return phi_i > phi_0 + C1 * a_i * dphi_0

    def wolfe_two(dphi_i):
        return torch.abs(dphi_i) <= -C2 * dphi_0

    done = failed = False
    i, nfev = 1, 0
    a_i1, phi_i1, dphi_i1 = torch.zeros_like(phi_0), phi_0, dphi_0
    a_star, phi_star, g_star = torch.zeros_like(phi_0), phi_0, gfk
    while not done and i <= maxiter and not failed:
        a_i = start if i == 1 else a_i1 * 2.
        phi_i, dphi_i, g_i = restricted(a_i)
        nfev += 1
        to_zoom1 = bool(wolfe_one(a_i, phi_i)) or (
            i > 1 and bool(phi_i >= phi_i1))
        if to_zoom1:
            zoom = _zoom(restricted, wolfe_one, wolfe_two, a_i1, phi_i1,
                         dphi_i1, a_i, phi_i, dphi_i, gfk)
        elif bool(wolfe_two(dphi_i)):
            done = True
            a_star, phi_star, g_star = a_i, phi_i, g_i
            zoom = None
        elif bool(dphi_i >= 0.):
            zoom = _zoom(restricted, wolfe_one, wolfe_two, a_i, phi_i,
                         dphi_i, a_i1, phi_i1, dphi_i1, gfk)
        else:
            zoom = None
        if zoom is not None:
            z_failed, z_nfev, a_star, phi_star, g_star = zoom
            nfev += z_nfev
            done, failed = True, z_failed
        i += 1
        a_i1, phi_i1, dphi_i1 = a_i, phi_i, dphi_i
    if bool(torch.abs(a_star) < MIN_STEP):
        a_star = torch.sign(a_star) * MIN_STEP
    return _Search(failed or not done, nfev, a_star, phi_star, g_star)


def bfgs(vg: Callable, x0: torch.Tensor, maxiter: Optional[int] = None,
         gtol: float = 1e-5, line_search_maxiter: int = 10) -> Result:
    """jax's ``minimize_bfgs`` (norm inf)."""
    if maxiter is None:
        maxiter = x0.numel() * 200
    d = x0.shape[0]
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    H = eye
    f, g = vg(x0)
    x = x0
    converged = bool(g.abs().max() < gtol)
    failed = False
    k, nfev = 0, 1
    old_old = f + torch.linalg.vector_norm(g) / 2
    while not converged and not failed and k < maxiter:
        p = -(H @ g)
        ls = line_search(vg, x, p, f, g, old_old_fval=old_old,
                         maxiter=line_search_maxiter)
        nfev += ls.nfev
        failed = ls.failed
        s = ls.a_k * p
        y = ls.g_k - g
        rho = torch.reciprocal(y @ s)
        w = eye - rho * (s[:, None] * y[None, :])
        H_new = torch.einsum("ij,jk,lk", w, H, w) \
            + rho * s[:, None] * s[None, :]
        if bool(torch.isfinite(rho)):
            H = H_new
        converged = bool(ls.g_k.abs().max() < gtol)
        k += 1
        x, old_old, f, g = x + s, f, ls.f_k, ls.g_k
    return Result(x, f, g, converged and not failed, nfev, k)


def lbfgs(vg: Callable, x0: torch.Tensor, maxiter: Optional[int] = None,
          maxcor: int = 10, ftol: float = 2.220446049250313e-09,
          gtol: float = 1e-5, maxls: int = 20) -> Result:
    """jax's ``_minimize_lbfgs`` (norm inf; no limit on evaluations)."""
    if maxiter is None:
        maxiter = x0.numel() * 200
    f, g = vg(x0)
    x = x0
    s_hist, y_hist, rho_hist = [], [], []   # newest last, at most maxcor
    gamma = torch.ones_like(f)
    converged = failed = False
    k, nfev = 0, 1
    while not converged and not failed:
        q = -g
        alphas = []
        for s_i, y_i, rho_i in zip(reversed(s_hist), reversed(y_hist),
                                   reversed(rho_hist)):
            a_i = rho_i * (s_i @ q)
            alphas.append(a_i)
            q = q - a_i * y_i
        q = gamma * q
        for s_i, y_i, rho_i, a_i in zip(s_hist, y_hist, rho_hist,
                                        reversed(alphas)):
            b_i = rho_i * (y_i @ q)
            q = q + (a_i - b_i) * s_i
        ls = line_search(vg, x, q, f, g, maxiter=maxls)
        s = ls.a_k * q
        y = ls.g_k - g
        rho_inv = y @ s
        rho = torch.reciprocal(rho_inv)
        gamma = rho_inv / (y @ y)
        stop = (bool(f - ls.f_k < ftol) or k >= maxiter or ls.failed)
        converged = bool(ls.g_k.abs().max() < gtol)
        failed = stop and not converged
        k += 1
        nfev += ls.nfev
        x, f, g = x + s, ls.f_k, ls.g_k
        s_hist, y_hist, rho_hist = ((h + [v])[-maxcor:] for h, v in
                                    ((s_hist, s), (y_hist, y),
                                     (rho_hist, rho)))
    return Result(x, f, g, converged and not failed, nfev, k)
