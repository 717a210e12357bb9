"""``cross_entropy`` (``paddle_tpu/nn/functional/loss.py``), hard labels."""
from __future__ import annotations

import torch

from ...amp import cast_inputs

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index: int = -100,
                  reduction: str = "mean"):
    """Softmax cross entropy of ``input`` ``[..., C]`` against integer
    ``label`` ``[...]`` over the last axis. Labels equal to
    ``ignore_index`` give 0 and are left out of the mean's count (at
    least 1)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r}")
    (input,) = cast_inputs("cross_entropy", input)
    logp = torch.log_softmax(input, dim=-1)
    idx = label.to(torch.int64)
    valid = idx != ignore_index
    picked = logp.gather(-1, torch.where(valid, idx, 0)[..., None])[..., 0]
    loss = torch.where(valid, -picked, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.to(loss.dtype).sum().clamp_min(1.0)
    return loss.sum() if reduction == "sum" else loss
