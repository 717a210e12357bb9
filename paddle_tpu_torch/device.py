"""Device resolution for every entry point of the port.

The port serves on the card. An entry point given no device runs on
``cuda`` and raises when there is none: it never carries on on the CPU
unless the caller asked for the CPU by name, as the tests do. A caller
asks either per call (``device="cpu"``) or for the process, with
Paddle's own :func:`set_device` (``paddle.set_device("cpu")``), which
every default below then follows until it is set again.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["default_device", "resolve_device", "set_device", "get_device",
           "torch_device_name", "using_device"]

# the device set by set_device, or None: the card
_current: Optional[torch.device] = None


def set_device(device: Union[str, torch.device, None]) -> torch.device:
    """``paddle.set_device``: the device every entry point given none runs
    on from now on. Takes Paddle's names (``"gpu"``, ``"gpu:1"``,
    ``"cpu"``) and torch's (``"cuda:0"``); ``None`` goes back to the
    card. Raises ``RuntimeError`` for a card that is not there."""
    global _current
    if device is None:
        _current = None
        return default_device() if torch.cuda.is_available() else \
            torch.device("cpu")
    dev = torch.device(torch_device_name(device))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"set_device({device!r}): cpu or gpu/cuda")
    if dev.type == "cuda":
        dev = resolve_device(dev)
    _current = dev
    return dev


def torch_device_name(place):
    """A device as torch names it: Paddle's ``gpu``/``gpu:N`` become
    ``cuda``/``cuda:N``; anything else is passed through."""
    if place is None or isinstance(place, torch.device):
        return place
    name = str(place)
    return "cuda" + name[3:] if name.startswith("gpu") else name


def get_device() -> str:
    """``paddle.get_device``: ``"cpu"`` or ``"gpu:N"`` for the device an
    entry point given none runs on (``RuntimeError`` when that is the
    card and there is none)."""
    dev = default_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def default_device() -> torch.device:
    """The device set by :func:`set_device`; else ``cuda`` (the current
    card), or ``RuntimeError`` without one."""
    if _current is not None:
        return _current
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' (or call set_device('cpu')) to run the plain "
            "PyTorch path")
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


@contextlib.contextmanager
def using_device(device):
    """Within the block, :func:`set_device(device) <set_device>` (the
    card when None); the device set before is put back after."""
    global _current
    prev = _current
    set_device(device)
    try:
        yield
    finally:
        _current = prev
