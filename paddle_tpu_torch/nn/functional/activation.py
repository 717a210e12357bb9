"""``gelu`` and ``silu`` (``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...amp import cast_inputs

__all__ = ["gelu", "silu"]


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """erf GELU, or the tanh form with ``approximate=True``."""
    (x,) = cast_inputs("gelu", x)
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``; in the O2 dtype under ``auto_cast`` (``silu`` is
    on neither amp list)."""
    (x,) = cast_inputs("silu", x)
    return tF.silu(x)
