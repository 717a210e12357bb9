"""The optimizer family (``paddle_tpu/optimizer/optimizers.py``): SGD,
Momentum, Adam, AdamW, Adamax, Adagrad, Adadelta, RMSProp and Lamb.

Each ``_update`` is Paddle's formula on tensors, in the parameter's dtype
(f32 on the master copy under master weights), returning the new value
and state, which the base class writes in place. Python constants enter
at the precision of the tensor they meet (``optimizer._weak``), as JAX's
weak-typed scalars do. Adam, for instance:

    m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g^2
    lr_t = lr sqrt(1 - b2^t) / (1 - b1^t)      (f32, then the param dtype)
    p = p - lr_t m / (sqrt(v) + eps)

AdamW first decays the parameter, ``p * (1 - lr * coeff)``, decoupled
from the gradient (a group's ``weight_decay`` is its coefficient).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .optimizer import Optimizer, _weak

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb"]


def _one(p: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=p.device)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p)


class SGD(Optimizer):
    """``p - lr g``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, p, g, accs, lr, name):
        return p - lr.to(p.dtype) * g, accs


class Momentum(Optimizer):
    """``v = mu v + g``; ``p - lr v`` (Nesterov: ``p - lr (g + mu v)``)."""

    _accumulator_specs = {"velocity": _zeros}

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _update(self, p, g, accs, lr, name):
        lr = lr.to(p.dtype)
        vel = accs["velocity"]
        v = _weak(self._momentum, vel.dtype) * vel + g
        if self._use_nesterov:
            new_p = p - lr * (g + _weak(self._momentum, v.dtype) * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}


class Adam(Optimizer):
    """Adam; an L2 ``weight_decay`` is coupled (added to the gradient by
    the base class)."""

    _accumulator_specs = {
        "moment1": _zeros,
        "moment2": _zeros,
        "beta1_pow": _one,
        "beta2_pow": _one,
    }

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 lazy_mode: bool = False, multi_precision: bool = False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._multi_precision = bool(multi_precision)

    def _update(self, p, g, accs, lr, name):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        dt = p.dtype
        b1p = accs["beta1_pow"] * b1
        b2p = accs["beta2_pow"] * b2
        # moments in the promoted type of their state and the grad, as jnp
        m = (_weak(b1, accs["moment1"].dtype) * accs["moment1"]
             + _weak(1 - b1, g.dtype) * g)
        v = (_weak(b2, accs["moment2"].dtype) * accs["moment2"]
             + _weak(1 - b2, g.dtype) * g * g)
        lr_t = (lr * torch.sqrt(1 - b2p) / (1 - b1p)).to(dt)
        new_p = p - lr_t * m / (torch.sqrt(v) + _weak(eps, v.dtype))
        return new_p, {"moment1": m, "moment2": v, "beta1_pow": b1p,
                       "beta2_pow": b2p}


class AdamW(Adam):
    """Adam with decoupled weight decay ``coeff`` (default 0.01; a group's
    ``weight_decay`` replaces it for the group's parameters), skipped for
    parameters whose name ``apply_decay_param_fun`` rejects;
    ``lr_ratio(param)`` scales a parameter's learning rate."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: Optional[float] = 0.01,
                 lr_ratio: Optional[Callable] = None,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 grad_clip=None, lazy_mode: bool = False,
                 multi_precision: bool = False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._coeff = float(weight_decay) if weight_decay is not None else 0.0
        # a group's float weight_decay is its decoupled coefficient; a
        # callable one stays a coupled grad transform
        self._decay_by_idx = {i: w for i, w in self._group_wd.items()
                              if isinstance(w, float)}
        self._group_wd = {i: w for i, w in self._group_wd.items()
                          if not isinstance(w, float)}
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _param_lr(self, idx: int) -> float:
        base = super()._param_lr(idx)
        if self._lr_ratio is not None:
            base *= float(self._lr_ratio(self._parameter_list[idx]))
        return base

    def _update(self, p, g, accs, lr, name):
        decay = self._decay_by_idx.get(self._current_idx, self._coeff)
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(name)):
            decay = 0.0
        if decay:
            p = p * (1 - lr.to(p.dtype) * _weak(decay, p.dtype))
        return super()._update(p, g, accs, lr, name)


class Adamax(Optimizer):
    """Adam with the infinity norm: ``u = max(b2 u, |g|)``, ``p - lr /
    (1 - b1^t) m / (u + eps)``."""

    _accumulator_specs = {
        "moment": _zeros,
        "inf_norm": _zeros,
        "beta1_pow": _one,
    }

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, p, g, accs, lr, name):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = accs["beta1_pow"] * b1
        mom, inf = accs["moment"], accs["inf_norm"]
        m = _weak(b1, mom.dtype) * mom + _weak(1 - b1, g.dtype) * g
        u = torch.maximum(_weak(b2, inf.dtype) * inf, torch.abs(g))
        new_p = p - (lr / (1 - b1p)).to(p.dtype) * m / (u + _weak(eps,
                                                                  u.dtype))
        return new_p, {"moment": m, "inf_norm": u, "beta1_pow": b1p}


class Adagrad(Optimizer):
    """``G += g^2``; ``p - lr g / (sqrt(G) + eps)``, G starting at
    ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        init = float(initial_accumulator_value)
        self._accumulator_specs = {
            "moment": lambda v: torch.full_like(v, init)}

    def _update(self, p, g, accs, lr, name):
        moment = accs["moment"] + g * g
        new_p = p - lr.to(p.dtype) * g / (torch.sqrt(moment)
                                          + _weak(self._epsilon,
                                                  moment.dtype))
        return new_p, {"moment": moment}


class Adadelta(Optimizer):
    """Zeiler's Adadelta, scaled by ``lr``."""

    _accumulator_specs = {
        "avg_squared_grad": _zeros,
        "avg_squared_update": _zeros,
    }

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _update(self, p, g, accs, lr, name):
        rho, eps = self._rho, self._epsilon
        asg, asu = accs["avg_squared_grad"], accs["avg_squared_update"]
        sg = _weak(rho, asg.dtype) * asg + _weak(1 - rho, g.dtype) * g * g
        update = -torch.sqrt((asu + _weak(eps, asu.dtype))
                             / (sg + _weak(eps, sg.dtype))) * g
        su = (_weak(rho, asu.dtype) * asu
              + _weak(1 - rho, update.dtype) * update * update)
        new_p = p + lr.to(p.dtype) * update
        return new_p, {"avg_squared_grad": sg, "avg_squared_update": su}


class RMSProp(Optimizer):
    """RMSProp with momentum, optionally centered."""

    _accumulator_specs = {
        "mean_square": _zeros,
        "mean_grad": _zeros,
        "momentum_acc": _zeros,
    }

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update(self, p, g, accs, lr, name):
        rho, eps = self._rho, self._epsilon
        ms0 = accs["mean_square"]
        ms = _weak(rho, ms0.dtype) * ms0 + _weak(1 - rho, g.dtype) * g * g
        mg = accs["mean_grad"]
        if self._centered:
            mg = _weak(rho, mg.dtype) * mg + _weak(1 - rho, g.dtype) * g
            denom = torch.sqrt(ms - mg * mg + _weak(eps, ms.dtype))
        else:
            denom = torch.sqrt(ms + _weak(eps, ms.dtype))
        macc = accs["momentum_acc"]
        mom = (_weak(self._momentum, macc.dtype) * macc
               + lr.to(p.dtype) * g / denom)
        return p - mom, {"mean_square": ms, "mean_grad": mg,
                         "momentum_acc": mom}


class Lamb(Optimizer):
    """Layer-wise adaptive Adam: the Adam direction plus decoupled decay,
    scaled by the trust ratio ``||p|| / ||r||`` (1 where either is 0);
    ``exclude_from_weight_decay_fn(param)`` turns the decay off."""

    _accumulator_specs = {
        "moment1": _zeros,
        "moment2": _zeros,
        "beta1_pow": _one,
        "beta2_pow": _one,
    }

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lamb_weight_decay = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, p, g, accs, lr, name):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = accs["beta1_pow"] * b1
        b2p = accs["beta2_pow"] * b2
        m1, m2 = accs["moment1"], accs["moment2"]
        m = _weak(b1, m1.dtype) * m1 + _weak(1 - b1, g.dtype) * g
        v = _weak(b2, m2.dtype) * m2 + _weak(1 - b2, g.dtype) * g * g
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        decay = self._lamb_weight_decay
        if (self._exclude_fn is not None
                and self._exclude_fn(self._current_param)):
            decay = 0.0
        r = (m_hat / (torch.sqrt(v_hat) + _weak(eps, v_hat.dtype))
             + _weak(decay, p.dtype) * p)
        w_norm = torch.linalg.vector_norm(p.float())
        r_norm = torch.linalg.vector_norm(r.float())
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        new_p = p - (lr * trust).to(p.dtype) * r
        return new_p, {"moment1": m, "moment2": v, "beta1_pow": b1p,
                       "beta2_pow": b2p}
