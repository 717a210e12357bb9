"""MoE-aware global-norm gradient clipping
(``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``).

The reference all-reduces the expert parameters' squared norm over the
moe group, since each rank holds only its own experts, and adds it to
the other parameters' (replicated, equal on every rank). The JAX
package's single program sees every expert, so there the sum is one
global reduction. The port runs a rank's own experts, so with a moe
group of several ranks the expert part (``is_expert_param_func``) is
all-reduced over it, and nothing else is.
"""
from __future__ import annotations

import torch

from .....distributed import collective, topology
from .....nn.clip import ClipGradBase, _clips, _factor, _scaled

__all__ = ["ClipGradForMOEByGlobalNorm"]


def _moe_group(group):
    if isinstance(group, str):
        return topology.get_mesh().group(group)
    return group


class ClipGradForMOEByGlobalNorm(ClipGradBase):
    """reference: grad_clip.py:23: every clipped grad scaled by one factor
    so that the global norm, expert and other parameters together, is at
    most ``clip_norm``."""

    def __init__(self, clip_norm: float, is_expert_param_func=None,
                 moe_group=None, group_name: str = "default_moe_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.moe_group = _moe_group(moe_group)
        if self._split():
            assert is_expert_param_func is not None, (
                "When moe group size > 1, a function for selecting expert "
                "params must be specified.")
        self.is_expert_param_func = is_expert_param_func

    def __str__(self):
        return f"Gradient Clip By GlobalNorm, global_norm={self.clip_norm}"

    def _split(self) -> bool:
        return self.moe_group is not None \
            and getattr(self.moe_group, "nranks", 1) > 1

    def _clip(self, params_grads):
        split = self._split()
        normal = expert = None
        clippable = set()
        for p, g in params_grads:
            if not _clips(p, g):
                continue
            s = torch.sum(g.float() ** 2)
            if split and self.is_expert_param_func(p):
                expert = s if expert is None else expert + s
            else:
                normal = s if normal is None else normal + s
            clippable.add(id(p))
        if not clippable:
            return params_grads
        if split:
            # every rank adds its experts' part, zero where it has none
            dev = (normal if normal is not None else expert).device
            expert = (expert if expert is not None
                      else torch.zeros((), device=dev)).clone()
            collective.all_reduce(expert, group=self.moe_group)
        total = sum(x for x in (normal, expert) if x is not None)
        factor = _factor(torch.sqrt(total), self.clip_norm)
        return [(p, _scaled(g, factor) if id(p) in clippable else g)
                for p, g in params_grads]
