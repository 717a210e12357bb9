"""``paddle.incubate.optimizer.functional`` of the port
(``paddle_tpu/incubate/optimizer/functional/__init__.py``):
``minimize_bfgs`` and ``minimize_lbfgs``.

The JAX package runs ``jax.scipy.optimize.minimize`` (``"BFGS"`` and
``"l-bfgs-experimental-do-not-rely-on-this"``) on an f32 position. The
port cannot import jax, so :mod:`._solvers` holds the same iterations
in torch -- BFGS (Nocedal and Wright, algorithm 6.1), L-BFGS (7.5) and
their strong-Wolfe line search with its zoom (3.5, 3.6) -- with jax's
constants, start values and iteration limits, in f32 on the position's
device, so the evaluations counted are the same. Both return the
reference's tuple ``(is_converge, num_func_calls, position,
objective_value, objective_gradient)``; ``is_converge`` is the solver's
success or a final gradient within ``tolerance_grad`` (largest entry),
as in the JAX package.
"""
from __future__ import annotations

import torch

from ....ops._apply import ensure_tensor
from ....tensor import Tensor
from . import _solvers

__all__ = ["minimize_bfgs", "minimize_lbfgs"]


def _objective(objective_func):
    """``x -> (f(x), grad f(x))`` over f32 torch tensors: ``f`` takes and
    returns facade Tensors, as the user's function does."""
    def value(x):
        out = objective_func(Tensor._wrap(x))
        out = out._value if isinstance(out, Tensor) else torch.as_tensor(out)
        return out.reshape(())

    def value_and_grad(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            v = value(xx)
            (g,) = torch.autograd.grad(v, xx)
        return v.detach(), g.detach()

    return value_and_grad


def _run(solver, objective_func, initial_position, tolerance_grad, **opts):
    x0 = ensure_tensor(initial_position)._value.detach().to(torch.float32)
    vg = _objective(objective_func)
    res = solver(vg, x0, gtol=float(tolerance_grad), **opts)
    _, grad = vg(res.x)
    converged = bool(res.success) or float(grad.abs().max()) <= tolerance_grad
    dev = x0.device
    return (Tensor(torch.tensor(converged, device=dev)),
            Tensor(torch.tensor(res.nfev, dtype=torch.int32, device=dev)),
            Tensor(res.x), Tensor(res.fun), Tensor(grad))


def minimize_bfgs(objective_func, initial_position, max_iters=50,
                  tolerance_grad=1e-7, tolerance_change=1e-9,
                  initial_inverse_hessian_estimate=None,
                  line_search_fn="strong_wolfe", max_line_search_iters=50,
                  initial_step_length=1.0, dtype="float32", name=None):
    """reference: incubate/optimizer/functional/bfgs.py minimize_bfgs
    (module docstring)."""
    if line_search_fn != "strong_wolfe":
        raise NotImplementedError("only strong_wolfe line search is "
                                  "supported")
    return _run(_solvers.bfgs, objective_func, initial_position,
                tolerance_grad, maxiter=int(max_iters))


def minimize_lbfgs(objective_func, initial_position, history_size=100,
                   max_iters=50, tolerance_grad=1e-8, tolerance_change=1e-8,
                   initial_inverse_hessian_estimate=None,
                   line_search_fn="strong_wolfe", max_line_search_iters=50,
                   initial_step_length=1.0, dtype="float32", name=None):
    """reference: incubate/optimizer/functional/lbfgs.py minimize_lbfgs:
    the tuple of :func:`minimize_bfgs`, over ``history_size`` curvature
    pairs."""
    if line_search_fn != "strong_wolfe":
        raise NotImplementedError("only strong_wolfe line search is "
                                  "supported")
    return _run(_solvers.lbfgs, objective_func, initial_position,
                tolerance_grad, maxiter=int(max_iters),
                maxcor=int(history_size))
