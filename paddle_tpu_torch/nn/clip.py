"""Gradient clipping (``paddle_tpu/nn/clip.py``): ``ClipGradByValue``,
``ClipGradByNorm`` and ``ClipGradByGlobalNorm``, a torch rewrite of the
``jnp`` code.

The optimizer calls ``clip(params_grads)`` (a list of ``(param, grad)``
with torch grads) before its update and uses the grads it returns
(facade grads, as a Paddle program passes them, come back as facade
tensors); a
parameter with ``need_clip`` False keeps its grad. Norms are f32 sums of
squares and stay on the device: the factor is a ``torch.where`` on a 0-d
tensor, never a host read, so a captured step clips inside its graph. A
grad is scaled in f32 and cast back to its dtype, as ``g * factor`` with
an f32 factor is computed in JAX.
"""
from __future__ import annotations

import torch

from ..tensor import Tensor

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _clips(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


def _scaled(g: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return (g.float() * factor).to(g.dtype)


def _factor(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    return torch.where(norm > clip_norm,
                       clip_norm / torch.clamp_min(norm, 1e-12),
                       torch.ones_like(norm))


class ClipGradBase:
    def __call__(self, params_grads):
        params_grads = list(params_grads)
        out = self._clip([(p, getattr(g, "_value", g))
                          for p, g in params_grads])
        return [(p, Tensor._wrap(c) if isinstance(g, Tensor) else c)
                for (p, g), (_, c) in zip(params_grads, out)]

    def _clip(self, params_grads):
        """The clip on torch grads."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each grad element clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clips(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each grad scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clips(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(g.float() ** 2))
            out.append((p, _scaled(g, _factor(norm, self.clip_norm))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped grad scaled by one factor, so that their joint L2
    norm is at most ``clip_norm``."""

    def __init__(self, clip_norm: float, group_name: str = "default_group",
                 auto_skip_clip: bool = False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        sq_sum = None
        clippable = set()
        for p, g in params_grads:
            if not _clips(p, g):
                continue
            s = torch.sum(g.float() ** 2)
            sq_sum = s if sq_sum is None else sq_sum + s
            clippable.add(id(p))
        if sq_sum is None:
            return params_grads
        factor = _factor(torch.sqrt(sq_sum), self.clip_norm)
        return [(p, _scaled(g, factor) if id(p) in clippable else g)
                for p, g in params_grads]
