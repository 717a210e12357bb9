"""LookAhead ("k steps forward, 1 step back", Zhang et al. 2019), the
port's ``paddle_tpu/incubate/optimizer/lookahead.py``.

Wraps an inner optimizer; every ``k`` inner steps the slow weights move
``alpha`` of the way toward the fast ones and the fast ones take the new
slow value (the first sync point starts the slow weights at the fast
ones). The slow weights are tensors on each parameter's device, and both
writes are in place.
"""
from __future__ import annotations

import torch

from ...optimizer.optimizer import Optimizer, _value

__all__ = ["LookAhead"]


class LookAhead(Optimizer):
    def __init__(self, inner_optimizer: Optimizer, alpha: float = 0.5,
                 k: int = 5, name: str = None):
        if inner_optimizer is None:
            raise ValueError("inner optimizer cannot be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be within [0, 1]")
        if not (isinstance(k, int) and k > 0):
            raise ValueError("k must be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        super().__init__(learning_rate=self.alpha,
                         parameters=inner_optimizer._parameter_list,
                         name=name)
        self._slow: dict = {}  # parameter index -> slow weights
        self._k_step = 0

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._k_step += 1
        if self._k_step % self.k:
            return
        for i, param in enumerate(self._parameter_list):
            p = _value(param)
            if not p.requires_grad:
                continue
            slow = self._slow.get(i)
            if slow is None:
                slow = self._slow[i] = p.detach().clone()
            slow.copy_(slow + self.alpha * (p - slow))
            p.copy_(slow)

    def clear_grad(self, set_to_zero: bool = False):
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return [], []

    def state_dict(self) -> dict:
        return {"inner": self.inner_optimizer.state_dict(),
                "k_step": self._k_step,
                "slow": {i: v.detach().clone() for i, v in self._slow.items()}}

    def set_state_dict(self, state_dict: dict):
        self.inner_optimizer.set_state_dict(state_dict["inner"])
        self._k_step = int(state_dict.get("k_step", 0))
        self._slow = {}
        for i, v in state_dict.get("slow", {}).items():
            p = _value(self._parameter_list[int(i)])
            self._slow[int(i)] = torch.as_tensor(
                getattr(v, "_value", v)).to(p.device, p.dtype, copy=True)
