"""ModelAverage -- evaluate with a sliding-window average of the
parameters (``paddle_tpu/incubate/optimizer/modelaverage.py``).

The ``average_accumulates`` op's window bookkeeping: ``step()`` adds the
current values into ``sum_1`` and, once the window (``average_window_rate``
x updates, clipped to ``[min_average_window, max_average_window]``) is
full, demotes the sums one level (``sum_3 <- sum_2 <- sum_1 <- 0``).
``apply()`` swaps in (sum_1 + sum_2 + sum_3) / accumulated count, as a
context manager that restores on exit unless ``need_restore=False``;
``restore()`` puts the trained values back. The sums live on each
parameter's device and every write is in place.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ...optimizer.optimizer import Optimizer, _value

__all__ = ["ModelAverage"]


class ModelAverage(Optimizer):
    def __init__(self, average_window_rate, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name: str = None):
        super().__init__(learning_rate=0.0, parameters=parameters, name=name)
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._state: dict = {}   # parameter index -> window state
        self._backup: dict = {}  # parameter index -> trained values

    def _trainable(self):
        for i, param in enumerate(self._parameter_list):
            p = _value(param)
            if p.requires_grad:
                yield i, p

    def _param_state(self, i, p):
        st = self._state.get(i)
        if st is None:
            st = self._state[i] = {
                "sum_1": torch.zeros_like(p.detach()),
                "sum_2": torch.zeros_like(p.detach()),
                "sum_3": torch.zeros_like(p.detach()),
                "num_accumulates": 0, "old_num_accumulates": 0,
                "num_updates": 0}
        return st

    @torch.no_grad()
    def step(self):
        """Accumulate the current parameter values into the window."""
        for i, p in self._trainable():
            st = self._param_state(i, p)
            st["sum_1"].add_(p)
            st["num_accumulates"] += 1
            st["num_updates"] += 1
            window = max(
                self.min_average_window,
                min(self.max_average_window,
                    int(self.average_window * st["num_updates"])))
            if st["num_accumulates"] >= window:
                st["sum_3"].copy_(st["sum_2"])
                st["sum_2"].copy_(st["sum_1"])
                st["sum_1"].zero_()
                st["old_num_accumulates"] += st["num_accumulates"]
                st["num_accumulates"] = 0

    def _average_value(self, i, p):
        st = self._param_state(i, p)
        total = st["num_accumulates"] + st["old_num_accumulates"]
        if total == 0:
            return p
        s = st["sum_1"] + st["sum_2"] + st["sum_3"]
        return (s / total).to(p.dtype)

    @contextmanager
    def apply(self, executor=None, need_restore: bool = True):
        """Swap the window-averaged weights in (and back out on exit)."""
        with torch.no_grad():
            for i, p in self._trainable():
                self._backup[i] = p.detach().clone()
                p.copy_(self._average_value(i, p))
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    @torch.no_grad()
    def restore(self, executor=None):
        """Put back the weights ``apply`` swapped out."""
        for i, p in self._trainable():
            if i in self._backup:
                p.copy_(self._backup.pop(i))

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()
        return [], []
