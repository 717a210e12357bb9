"""Learning-rate schedulers: a copy of ``paddle_tpu/optimizer/lr.py``
(jax-free there), so the two packages give the same values and
``state_dict`` at every step.

reference parity: python/paddle/optimizer/lr.py (20+ scheduler classes over an
``LRScheduler`` base with step/get_lr/state_dict). Schedulers are pure-Python
host-side state. In the port the lr enters a step through the optimizer's
0-d f32 lr buffer, written in place before each step (before each replay of
a captured one), so stepping the scheduler never triggers a new capture.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Union

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "ExponentialDecay",
    "MultiStepDecay", "StepDecay", "LambdaDecay", "ReduceOnPlateau",
    "CosineAnnealingDecay", "MultiplicativeDecay", "OneCycleLR", "CyclicLR",
    "LinearLR", "CosineAnnealingWarmRestarts",
]


class LRScheduler:
    """Base scheduler (reference: python/paddle/optimizer/lr.py LRScheduler)."""

    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self) -> float:
        return self.last_lr

    def step(self, epoch: Optional[int] = None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: {type(self).__name__} set learning rate to {self.last_lr}.")

    def get_lr(self) -> float:
        raise NotImplementedError

    # progress state only — hyperparameters belong to the constructor, so a
    # resume with a new schedule config is not silently overwritten
    # (reference: lr.py keys = ['last_epoch', 'last_lr'])
    _state_keys = ("last_epoch", "last_lr")

    def state_dict(self) -> dict:
        return {k: self.__dict__[k] for k in self._state_keys if k in self.__dict__}

    def set_state_dict(self, state: dict):
        for k in self._state_keys:
            if k in state:
                self.__dict__[k] = state[k]

    load_state_dict = set_state_dict


class NoamDecay(LRScheduler):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: Sequence[int], values: Sequence[float],
                 last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * max(div, 1)
        else:
            step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = learning_rate if not isinstance(learning_rate, LRScheduler) else end_lr
        super().__init__(float(base), last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / max(
                self.warmup_steps, 1) + self.start_lr
        if self.lr_sched is not None:
            # explicit-epoch step keeps get_lr idempotent (calling it twice,
            # or jumping via step(epoch=N), lands on the same inner state)
            self.lr_sched.step(self.last_epoch - self.warmup_steps)
            return self.lr_sched()
        return self.base_lr

    def state_dict(self):
        sd = super().state_dict()
        if self.lr_sched is not None:
            sd["LinearWarmup_LR"] = self.lr_sched.state_dict()
        return sd

    def set_state_dict(self, state):
        state = dict(state)
        inner = state.pop("LinearWarmup_LR", None)
        if inner is not None and self.lr_sched is not None:
            self.lr_sched.set_state_dict(inner)
        super().set_state_dict(state)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones: Sequence[int], gamma=0.1,
                 last_epoch=-1, verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size: int, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable[[int], float],
                 last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable[[int], float],
                 last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        # incremental like the reference: last_lr * lambda(epoch), O(1)/step
        if self.last_epoch > 0:
            return self.last_lr * self.lr_lambda(self.last_epoch)
        return self.base_lr


class CosineAnnealingDecay(LRScheduler):
    """Cosine-annealed learning rate (reference: optimizer/lr.py
    CosineAnnealingDecay).

    Examples:
        >>> sched = paddle.optimizer.lr.CosineAnnealingDecay(0.1, T_max=10)
        >>> sched.get_lr()
        0.1
        >>> sched.step()
        >>> round(sched.get_lr(), 6) < 0.1
        True
    """

    def __init__(self, learning_rate, T_max: int, eta_min=0.0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0: int, T_mult: int = 1, eta_min=0.0,
                 last_epoch=-1, verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        epoch = max(self.last_epoch, 0)
        T_i, T_cur = self.T_0, epoch
        while T_cur >= T_i:
            T_cur -= T_i
            T_i *= self.T_mult if self.T_mult > 1 else 1
            if self.T_mult == 1:
                T_cur = epoch % self.T_0
                break
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * T_cur / T_i)) / 2


class ReduceOnPlateau(LRScheduler):
    """reference: lr.py ReduceOnPlateau — metric-driven, step(metric)."""

    _state_keys = ("last_epoch", "last_lr", "cooldown_counter", "best",
                   "num_bad_epochs")

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        assert mode in ("min", "max")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.verbose = verbose
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.cooldown_counter = 0
        self.best = None
        self.num_bad_epochs = 0

    def step(self, metrics, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        metrics = float(metrics)
        if self.best is None or self._is_better(metrics, self.best):
            self.best = metrics
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        elif self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
                if self.verbose:
                    print(f"Epoch {self.last_epoch}: ReduceOnPlateau set learning rate to {new_lr}.")
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def _is_better(self, cur, best):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return cur < best * (1 - self.threshold)
            return cur < best - self.threshold
        if self.threshold_mode == "rel":
            return cur > best * (1 + self.threshold)
        return cur > best + self.threshold

    def get_lr(self):
        return self.last_lr


class LinearLR(LRScheduler):
    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        frac = self.start_factor + (self.end_factor - self.start_factor) * t / self.total_steps
        return self.base_lr * frac


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = float(max_learning_rate)
        self.total_steps = total_steps
        self.initial_lr = self.max_lr / divide_factor
        self.end_lr = float(end_learning_rate)
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return (end - start) * pct + start

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up_steps = float(self.phase_pct * self.total_steps) - 1
        if self.three_phase:
            down_steps = 2 * up_steps + 1
            if step <= up_steps:
                return self._interp(self.initial_lr, self.max_lr, step / max(up_steps, 1))
            if step <= down_steps:
                return self._interp(self.max_lr, self.initial_lr,
                                    (step - up_steps) / max(up_steps, 1))
            return self._interp(self.initial_lr, self.end_lr,
                                (step - down_steps) / max(self.total_steps - 1 - down_steps, 1))
        if step <= up_steps:
            return self._interp(self.initial_lr, self.max_lr, step / max(up_steps, 1))
        return self._interp(self.max_lr, self.end_lr,
                            (step - up_steps) / max(self.total_steps - 1 - up_steps, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1, verbose=False):
        self.max_lr = float(max_learning_rate)
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self._scale_fn = scale_fn
        self.scale_mode = scale_mode if scale_fn is not None else (
            "iterations" if mode == "exp_range" else "cycle")
        super().__init__(base_learning_rate, last_epoch, verbose)

    def _scale(self, x):
        if self._scale_fn is not None:
            return self._scale_fn(x)
        if self.mode == "triangular":
            return 1.0
        if self.mode == "triangular2":
            return 1.0 / (2 ** (x - 1))
        return self.exp_gamma ** x

    def get_lr(self):
        total = self.step_size_up + self.step_size_down
        cycle = math.floor(1 + self.last_epoch / total)
        iter_in_cycle = self.last_epoch - (cycle - 1) * total
        if iter_in_cycle <= self.step_size_up:
            pct = iter_in_cycle / self.step_size_up
        else:
            pct = 1 - (iter_in_cycle - self.step_size_up) / self.step_size_down
        amp = (self.max_lr - self.base_lr) * pct
        x = cycle if self.scale_mode == "cycle" else self.last_epoch
        return self.base_lr + amp * self._scale(x)
