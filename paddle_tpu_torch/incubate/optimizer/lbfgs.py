"""L-BFGS over the whole batch, with an optional strong-Wolfe line search
(``paddle_tpu/incubate/optimizer/lbfgs.py``).

``step(closure)`` runs up to ``max_iter`` quasi-Newton iterations: the
two-loop recursion over at most ``history_size`` curvature pairs, then a
step of the learning rate (the first one scaled by ``1 / |g|_1``), or
the strong-Wolfe search (doubling, then bisection). The closure zeroes
nothing itself: each evaluation clears the grads, runs it with grad on
and reads the loss and the flat gradient. The flat parameter, gradient
and history vectors are f64 tensors on the parameters' device, as the
JAX package's are f64 numpy arrays; only the scalars the iteration
branches on (losses, ``g.d``, the largest gradient) are read on the host.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ...optimizer.optimizer import Optimizer, _value

__all__ = ["LBFGS"]


class LBFGS(Optimizer):
    def __init__(self, learning_rate: float = 1.0, max_iter: int = 20,
                 max_eval: Optional[int] = None, tolerance_grad: float = 1e-7,
                 tolerance_change: float = 1e-9, history_size: int = 100,
                 line_search_fn: Optional[str] = None, parameters=None,
                 weight_decay=None, grad_clip=None, name: str = None):
        if max_eval is None:
            max_eval = max_iter * 5 // 4
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         name=name)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None or 'strong_wolfe'")
        self.max_iter = max_iter
        self.max_eval = max_eval
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s: List[torch.Tensor] = []  # parameter deltas
        self._y: List[torch.Tensor] = []  # gradient deltas

    # -- flat view over the parameter list --------------------------------
    def _params(self) -> List[torch.Tensor]:
        return [_value(p) for p in self._parameter_list
                if _value(p).requires_grad]

    def _flat_grad(self) -> torch.Tensor:
        return torch.cat([
            torch.zeros(p.numel(), dtype=torch.float64, device=p.device)
            if p.grad is None else p.grad.detach().reshape(-1).double()
            for p in self._params()])

    def _flat_params(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1).double()
                          for p in self._params()])

    def _set_flat_params(self, flat: torch.Tensor) -> None:
        i = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[i:i + n].reshape(p.shape))
            i += n

    def _evaluate(self, closure, x, t, d):
        self._set_flat_params(x + t * d)
        loss = float(closure())
        return loss, self._flat_grad()

    # -- two-loop recursion ------------------------------------------------
    def _direction(self, g: torch.Tensor) -> torch.Tensor:
        if not self._s:
            return -g
        q = g.clone()
        alphas = []
        rhos = [1.0 / torch.clamp_min(y @ s, 1e-10)
                for s, y in zip(self._s, self._y)]
        for s, y, rho in zip(reversed(self._s), reversed(self._y),
                             reversed(rhos)):
            a = rho * (s @ q)
            alphas.append(a)
            q -= a * y
        y_last, s_last = self._y[-1], self._s[-1]
        gamma = (s_last @ y_last) / torch.clamp_min(y_last @ y_last, 1e-10)
        r = gamma * q
        for (s, y, rho), a in zip(zip(self._s, self._y, rhos),
                                  reversed(alphas)):
            b = rho * (y @ r)
            r += (a - b) * s
        return -r

    # -- strong-Wolfe line search (doubling, then bisection) ---------------
    def _strong_wolfe(self, closure, x, t, d, f, g, gtd,
                      c1=1e-4, c2=0.9, max_ls=25):
        d_norm = float(d.abs().max())
        f_prev, g_prev, t_prev = f, g.clone(), 0.0
        done = False
        ls_iter = 0
        f_new, g_new = self._evaluate(closure, x, t, d)
        gtd_new = float(g_new @ d)
        while ls_iter < max_ls:
            if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
                bracket, bracket_f = [t_prev, t], [f_prev, f_new]
                bracket_g = [g_prev, g_new.clone()]
                break
            if abs(gtd_new) <= -c2 * gtd:
                bracket, bracket_f = [t, t], [f_new, f_new]
                bracket_g = [g_new, g_new]
                done = True
                break
            if gtd_new >= 0:
                bracket, bracket_f = [t_prev, t], [f_prev, f_new]
                bracket_g = [g_prev, g_new.clone()]
                break
            min_step = t + 0.01 * (t - t_prev)
            max_step = t * 10
            tmp = t
            t = min(max(2 * t, min_step), max_step)
            t_prev = tmp
            f_prev, g_prev = f_new, g_new.clone()
            f_new, g_new = self._evaluate(closure, x, t, d)
            gtd_new = float(g_new @ d)
            ls_iter += 1
        else:
            bracket, bracket_f = [0.0, t], [f, f_new]
            bracket_g = [g, g_new]
        while not done and ls_iter < max_ls:
            lo, hi = (0, 1) if bracket_f[0] <= bracket_f[1] else (1, 0)
            if abs(bracket[1] - bracket[0]) * d_norm < self.tolerance_change:
                break
            t = 0.5 * (bracket[0] + bracket[1])
            f_new, g_new = self._evaluate(closure, x, t, d)
            gtd_new = float(g_new @ d)
            ls_iter += 1
            if f_new > (f + c1 * t * gtd) or f_new >= bracket_f[lo]:
                bracket[hi], bracket_f[hi] = t, f_new
                bracket_g[hi] = g_new.clone()
            else:
                if abs(gtd_new) <= -c2 * gtd:
                    done = True
                elif gtd_new * (bracket[hi] - bracket[lo]) >= 0:
                    bracket[hi] = bracket[lo]
                    bracket_f[hi] = bracket_f[lo]
                    bracket_g[hi] = bracket_g[lo]
                bracket[lo], bracket_f[lo] = t, f_new
                bracket_g[lo] = g_new.clone()
        lo = 0 if bracket_f[0] <= bracket_f[1] else 1
        return bracket_f[lo], bracket_g[lo], bracket[lo]

    @torch.no_grad()
    def step(self, closure: Callable):
        """One L-BFGS outer step. ``closure`` computes the loss, calls
        backward and returns the loss Tensor; returns its first value."""
        def eval_closure():
            self.clear_grad()
            with torch.enable_grad():
                return closure()

        loss = eval_closure()
        f = float(loss)
        g = self._flat_grad()
        if float(g.abs().max()) <= self.tolerance_grad:
            return loss
        n_eval = 1
        for _ in range(self.max_iter):
            d = self._direction(g)
            gtd = float(g @ d)
            if gtd > -self.tolerance_change:
                break
            t = (min(1.0, 1.0 / max(float(g.abs().sum()), 1e-10))
                 * self.get_lr() if not self._s else self.get_lr())
            x = self._flat_params()
            if self.line_search_fn == "strong_wolfe":
                f_new, g_new, t = self._strong_wolfe(
                    eval_closure, x, t, d, f, g, gtd)
                self._set_flat_params(x + t * d)
            else:
                self._set_flat_params(x + t * d)
                f_new = float(eval_closure())
                g_new = self._flat_grad()
            n_eval += 1
            s = self._flat_params() - x
            y = g_new - g
            if float(y @ s) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)
            delta_f = abs(f_new - f)
            f, g = f_new, g_new
            if float(g.abs().max()) <= self.tolerance_grad:
                break
            if delta_f < self.tolerance_change:
                break
            if n_eval >= self.max_eval:
                break
        return loss
