"""Optimizer base class (``paddle_tpu/optimizer/optimizer.py``).

Per-parameter state ("accumulators") is a dict of tensors on the
parameter's device, created at the first step from each name's
initialiser applied to the parameter (so Adam's moments start in the
parameter's dtype, as there). ``step`` computes each parameter's new
value and state with the subclass's ``_update`` on tensors and writes
the value into the parameter in place.

Master weights (``multi_precision``, set by ``amp.decorate(level="O2")``
unless ``master_weight=False``): a bf16/fp16 parameter keeps an f32 copy
under ``"@master"``; the update runs on it with the f32 grad, and the
parameter holds its down-cast. Without them a low-precision parameter's
whole update runs in its own dtype.

Parameters may be torch parameters or facade ``Parameter``s
(``tensor.py``), whose torch value the step writes in place (the cell
keeps its storage, as a module's parameter does).

Not ported yet: grad clipping, the ``_found_inf`` skip of GradScaler, LR
schedulers and param groups.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch

__all__ = ["Optimizer"]

_LOW = (torch.bfloat16, torch.float16)


def _value(p) -> torch.Tensor:
    """The torch tensor of a parameter: a facade Parameter's value."""
    return getattr(p, "_value", p)


def _named(parameters) -> List[Tuple[str, torch.nn.Parameter]]:
    """``(name, param)`` pairs from params or ``named_parameters()``
    pairs; a facade Parameter by its name, a torch parameter by its
    position."""
    out = []
    for i, p in enumerate(parameters):
        if isinstance(p, tuple):
            out.append(p)
        else:
            out.append((p.name if hasattr(p, "_value") else f"param_{i}", p))
    return out


class Optimizer:
    """Subclasses implement ``_update(p, g, accs, lr, name)`` returning
    ``(new_p, new_accs)`` and list their accumulators' initialisers in
    ``_accumulator_specs``. ``lr`` is a 0-dim f32 tensor on the
    parameter's device; ``name`` is the parameter's name."""

    _accumulator_specs: Dict[str, object] = {}

    def __init__(self, learning_rate: float = 0.001,
                 parameters: Optional[Iterable] = None,
                 weight_decay: Optional[float] = None):
        if parameters is None:
            raise ValueError("pass parameters=model.parameters() (or "
                             "model.named_parameters())")
        named = _named(list(parameters))
        self._names = [n for n, _ in named]
        self._parameter_list = [p for _, p in named]
        self._learning_rate = float(learning_rate)
        # coupled L2 decay added to the gradient (regularizer.L2Decay)
        self.regularization = (float(weight_decay) if weight_decay
                               is not None else None)
        self._multi_precision = False
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    # -------------------------------------------------------------- lr
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        self._learning_rate = float(value)

    # ---------------------------------------------------------- state
    def _get_accumulators(self, idx: int, p: torch.Tensor) -> dict:
        accs = self._accumulators.get(idx)
        if accs is None:
            accs = {name: init(p.detach())
                    for name, init in self._accumulator_specs.items()}
            self._accumulators[idx] = accs
        return accs

    def _update(self, p, g, accs: dict, lr, name: str):
        raise NotImplementedError

    def _param_lr(self, idx: int) -> float:
        return 1.0

    # ---------------------------------------------------------- step
    @torch.no_grad()
    @torch.profiler.record_function("optimizer.step")
    def step(self) -> None:
        """One update of every parameter that has a grad."""
        base_lr: Dict[torch.device, torch.Tensor] = {}
        for idx, param in enumerate(self._parameter_list):
            p = _value(param)
            if p.grad is None or not p.requires_grad:
                continue
            if p.device not in base_lr:  # a fill kernel: no host sync
                base_lr[p.device] = torch.full((), self.get_lr(),
                                               dtype=torch.float32,
                                               device=p.device)
            g = p.grad
            use_master = self._multi_precision and p.dtype in _LOW
            accs = self._get_accumulators(idx, p)
            if use_master:
                if "@master" not in accs:
                    accs["@master"] = p.detach().float()
                pv, gv = accs["@master"], g.float()
            else:
                pv = p.detach()
                gv = g if g.dtype == pv.dtype else g.to(pv.dtype)
            if self.regularization is not None:
                gv = gv + _weak(self.regularization, pv.dtype) * pv
            plr = self._param_lr(idx)
            lr = base_lr[p.device] * plr if plr != 1.0 else base_lr[p.device]
            new_val, new_accs = self._update(pv, gv, accs, lr,
                                             self._names[idx])
            if use_master:
                new_accs["@master"] = new_val
            p.copy_(new_val)  # the down-cast, under master weights
            self._accumulators[idx] = new_accs
        self._global_step += 1

    @torch.no_grad()
    def clear_grad(self) -> None:
        """Every parameter's grad to None."""
        for p in self._parameter_list:
            _value(p).grad = None

    # ------------------------------------------------------ state dict
    def state_dict(self) -> dict:
        """``pos:{index}.{accumulator}`` -> tensor, and ``@global_step``
        (the JAX package's keys: a parameter by its position)."""
        sd: Dict[str, Union[torch.Tensor, int]] = {
            f"pos:{idx}.{name}": val
            for idx, accs in self._accumulators.items()
            for name, val in accs.items()}
        sd["@global_step"] = self._global_step
        return sd

    def set_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self._global_step = int(state_dict.pop("@global_step", 0))
        for key, val in state_dict.items():
            pkey, _, name = key.rpartition(".")
            if not pkey.startswith("pos:"):
                continue
            idx = int(pkey[4:])
            if idx >= len(self._parameter_list):
                raise KeyError(
                    f"optimizer state refers to parameter index {idx} but "
                    f"this optimizer has {len(self._parameter_list)}")
            dev = _value(self._parameter_list[idx]).device
            self._accumulators.setdefault(idx, {})[name] = torch.as_tensor(
                val).to(dev)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.get_lr()})"


_weak_cache: Dict[Tuple[float, torch.dtype], float] = {}


def _weak(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: a Python scalar meets a bf16 array in
    JAX as a bf16 value (a weak type), while torch would apply it at f32
    precision. Exact for f32 use."""
    key = (x, dtype)
    val = _weak_cache.get(key)
    if val is None:
        val = float(torch.tensor(x, dtype=dtype))
        _weak_cache[key] = val
    return val
