"""``paddle.regularizer`` (``paddle_tpu/regularizer.py``): the coupled
weight decays the port's optimizer adds to a gradient before its update
(``weight_decay=`` of an optimizer or a parameter group, or a
parameter's ``regularizer``), each a callable ``(param, grad) ->
grad``."""
import torch

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    """``grad + coeff * param``."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __call__(self, param: torch.Tensor, grad: torch.Tensor):
        return grad + self.coeff * param


class L1Decay:
    """``grad + coeff * sign(param)``."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __call__(self, param: torch.Tensor, grad: torch.Tensor):
        return grad + self.coeff * torch.sign(param)
