"""Device resolution for every entry point of the port.

The port serves on the card. An entry point given no device runs on
``cuda`` and raises when there is none: it never carries on on the CPU
unless the caller asked for the CPU by name, as the tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """``cuda`` (the current card), or ``RuntimeError`` without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """The device a constructor works on: ``device`` when given (``cuda``
    without an index becomes the current card), else
    :func:`default_device`."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
