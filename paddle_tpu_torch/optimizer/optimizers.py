"""Adam and AdamW (``paddle_tpu/optimizer/optimizers.py``).

Paddle's Adam update, in the parameter's dtype (bf16 throughout for a
bf16 parameter without master weights):

    m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g^2
    lr_t = lr sqrt(1 - b2^t) / (1 - b1^t)      (f32, then the param dtype)
    p = p - lr_t m / (sqrt(v) + eps)

AdamW first decays the parameter, ``p * (1 - lr * coeff)``, decoupled
from the gradient. Python constants enter at the parameter's precision
(``optimizer._weak``), as JAX's weak-typed scalars do.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .optimizer import Optimizer, _weak

__all__ = ["Adam", "AdamW"]


def _one(p: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=p.device)


class Adam(Optimizer):
    _accumulator_specs = {
        "moment1": torch.zeros_like,
        "moment2": torch.zeros_like,
        "beta1_pow": _one,
        "beta2_pow": _one,
    }

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: Optional[float] = None,
                 multi_precision: bool = False):
        super().__init__(learning_rate, parameters, weight_decay)
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
    """Adam with decoupled weight decay ``coeff`` (default 0.01), skipped
    for parameters whose name ``apply_decay_param_fun`` rejects;
    ``lr_ratio(param)`` scales a parameter's learning rate."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: Optional[float] = 0.01,
                 lr_ratio: Optional[Callable] = None,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 multi_precision: bool = False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, multi_precision)
        self._coeff = float(weight_decay) if weight_decay is not None else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _param_lr(self, idx: int) -> float:
        if self._lr_ratio is None:
            return 1.0
        return float(self._lr_ratio(self._parameter_list[idx]))

    def _update(self, p, g, accs, lr, name):
        decay = self._coeff
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(name)):
            decay = 0.0
        if decay:
            p = p * (1 - lr.to(p.dtype) * _weak(decay, p.dtype))
        return super()._update(p, g, accs, lr, name)
