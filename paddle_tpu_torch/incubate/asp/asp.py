"""ASP's workflow (``paddle_tpu/incubate/asp/asp.py``): prune the
supported layers' weights to an n:m pattern, then train with an
optimizer wrapper that multiplies the masks back in after every
``step``, so pruned entries stay zero (reference: asp.py:216
``decorate``, :302 ``prune_model``, the excluded-layer registry :40 and
:127).

Masks are computed on the host (:mod:`.utils`) and kept as tensors on
each parameter's device; the prune and every re-mask multiply in place,
so an optimizer and a captured step keep the parameters' storage.
Supported: 2-D weights (a ``Linear``'s ``[in, out]``, pruned in groups
along the input axis) and 4-D ones (a convolution's OIHW, flattened per
output channel), and whatever ``add_supported_layer`` registers.
Hopper's 2:4 sparse tensor cores are not used (the JAX package has no
such path).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .utils import check_sparsity, create_mask

__all__ = ["decorate", "prune_model", "set_excluded_layers",
           "reset_excluded_layers", "add_supported_layer", "ASPHelper"]


class ASPHelper:
    """The process's masks and exclusions."""

    _excluded_param_names: set = set()
    # id(parameter) -> (parameter, mask on its device)
    _masks: Dict[int, tuple] = {}
    _custom_pruning: Dict[str, object] = {}

    MASK_ALGO_MAP = {
        "mask_1d": "mask_1d",
        "mask_2d_greedy": "mask_2d_greedy",
        "mask_2d_best": "mask_2d_best",
    }

    @classmethod
    def _is_supported_param(cls, name: str, value) -> bool:
        if name in cls._excluded_param_names:
            return False
        return value.ndim in (2, 4)   # weights; biases and norms stay dense

    @classmethod
    def prune_model(cls, model, n: int = 2, m: int = 4,
                    mask_algo: str = "mask_1d",
                    with_mask: bool = True) -> Dict[str, np.ndarray]:
        if mask_algo not in cls.MASK_ALGO_MAP:
            raise ValueError(f"mask_algo must be one of "
                             f"{sorted(cls.MASK_ALGO_MAP)}, got {mask_algo!r}")
        algo = cls.MASK_ALGO_MAP[mask_algo]
        masks: Dict[str, np.ndarray] = {}
        for name, p in model.named_parameters():
            if name in cls._excluded_param_names:  # exclusion always wins
                continue
            v = np.asarray(p.numpy())
            # a registration makes the parameter prunable whatever its
            # rank: False = not registered, None = the default pruning
            registered = next(
                (fn for key, fn in cls._custom_pruning.items()
                 if key in name), False)
            if registered is False and not cls._is_supported_param(name, v):
                continue
            if callable(registered):
                pruned, mask = registered(v, m, n, mask_algo, name)
                v, mask = np.asarray(pruned), np.asarray(mask)
            elif v.ndim == 2:
                # [in, out]: groups run down the input axis
                mask = create_mask(v.T, algo, n, m).T
            elif v.ndim >= 3:
                mask = create_mask(v, algo, n, m)
            else:
                mask = create_mask(v.reshape(1, -1), algo, n,
                                   m).reshape(v.shape)
            t = p._value
            mask_t = torch.as_tensor(np.ascontiguousarray(mask)).to(
                t.device, t.dtype)
            with torch.no_grad():
                if callable(registered):
                    t.copy_(torch.as_tensor(v).to(t.device, t.dtype))
                t.mul_(mask_t)
            masks[name] = mask
            if with_mask:
                cls._masks[id(p)] = (p, mask_t)
        return masks

    @classmethod
    @torch.no_grad()
    def reapply_masks(cls) -> None:
        for p, mask in cls._masks.values():
            p._value.mul_(mask)

    @classmethod
    def check_model_sparsity(cls, model, n: int = 2, m: int = 4,
                             func_name: str = "mask_1d") -> bool:
        ok = True
        for _, p in model.named_parameters():
            if id(p) in cls._masks:
                v = np.asarray(p.numpy())
                ok &= check_sparsity(v.T if v.ndim == 2 else v,
                                     func_name, n, m)
        return bool(ok)


def set_excluded_layers(param_names: List[str], main_program=None) -> None:
    """Leave these parameters (by name) unpruned (reference: asp.py:40)."""
    ASPHelper._excluded_param_names.update(param_names)


def reset_excluded_layers(main_program=None) -> None:
    """Clear the exclusions (reference: asp.py:127)."""
    ASPHelper._excluded_param_names.clear()


def add_supported_layer(layer, pruning_func=None) -> None:
    """Register a layer (a name, a Layer subclass or an instance) as
    prunable, with an optional ``pruning_func(weight, m, n, func_name,
    param_name) -> (pruned_weight, mask)``; with None the default n:m
    mask applies to the parameters whose name contains the registered
    name (reference: incubate/asp/supported_layer_list.py:85)."""
    if isinstance(layer, str):
        name = layer
    elif isinstance(layer, type):
        name = layer.__name__.lower()
    else:
        name = type(layer).__name__.lower()
    ASPHelper._custom_pruning[name] = pruning_func


def prune_model(model, n: int = 2, m: int = 4, mask_algo: str = "mask_1d",
                with_mask: bool = True):
    """Prune ``model``'s supported weights to n:m; with ``with_mask`` the
    masks are kept for a decorated optimizer (reference: asp.py:302)."""
    return ASPHelper.prune_model(model, n, m, mask_algo, with_mask)


class OptimizerWithSparsityGuarantee:
    """Re-applies the masks after every ``step`` (reference: asp.py:548)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def step(self, *args, **kwargs):
        out = self._optimizer.step(*args, **kwargs)
        ASPHelper.reapply_masks()
        return out

    def minimize(self, loss, *args, **kwargs):
        out = self._optimizer.minimize(loss, *args, **kwargs)
        ASPHelper.reapply_masks()
        return out

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(optimizer) -> OptimizerWithSparsityGuarantee:
    """``optimizer`` wrapped so pruned weights stay pruned (reference:
    asp.py:216)."""
    return OptimizerWithSparsityGuarantee(optimizer)
