"""Device resolution for every entry point of the port, and
``paddle.device`` (``paddle_tpu/device/__init__.py``) on ``torch.cuda``.

The port serves on the card. An entry point given no device runs on
``cuda`` and raises when there is none: it never carries on on the CPU
unless the caller asked for the CPU by name, as the tests do. A caller
asks either per call (``device="cpu"``) or for the process, with
Paddle's own :func:`set_device` (``paddle.set_device("cpu")``), which
every default below then follows until it is set again.

The rest of ``paddle.device`` answers for the card: the device queries,
the memory telemetry (``torch.cuda``'s allocator counters), the
``is_compiled_with_*`` predicates of this build (CUDA when torch was
built with it), and ``Stream``/``Event``/``stream_guard``, which are
:mod:`.cuda`'s (``torch.cuda`` streams: the kernels launch on PyTorch's
current stream, so a guarded block runs them on the guarded stream).
A query given no device asks the default device: the card, or
``RuntimeError`` without one unless ``set_device("cpu")``; on the CPU
the memory queries give 0 (``{}``) and ``synchronize`` does nothing.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["default_device", "resolve_device", "set_device", "get_device",
           "torch_device_name", "using_device", "get_all_devices",
           "device_count", "synchronize", "is_compiled_with_cuda",
           "memory_stats", "memory_allocated", "max_memory_allocated",
           "memory_reserved", "max_memory_reserved", "get_cudnn_version",
           "is_compiled_with_xpu", "is_compiled_with_ipu",
           "is_compiled_with_cinn", "is_compiled_with_rocm",
           "is_compiled_with_custom_device", "get_all_device_type",
           "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device", "XPUPlace", "IPUPlace", "Stream",
           "Event", "current_stream", "set_stream", "stream_guard", "cuda",
           "xpu"]

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


# ------------------------------------------------------ device queries
def _target(device) -> torch.device:
    """The device a query asks: ``device`` (an index, Paddle's or torch's
    name) or the default device."""
    if isinstance(device, int):
        device = torch.device("cuda", device)
    return resolve_device(torch_device_name(device))


def get_all_devices():
    """The cards (``torch.device``s), or the CPU without one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ([torch.device("cuda", i) for i in range(n)]
            or [torch.device("cpu")])


def device_count(device_type=None) -> int:
    """Cards for ``None``/``"gpu"``/``"cuda"``, 1 for ``"cpu"``, else 0."""
    if device_type in (None, "gpu", "cuda"):
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1 if device_type == "cpu" else 0


def synchronize(device=None) -> None:
    """Wait for the work queued on the device (``cudaDeviceSynchronize``);
    nothing to wait for on the CPU."""
    dev = _target(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def is_compiled_with_cuda() -> bool:
    """This build: True when torch was built with CUDA (the JAX package's
    TPU build says False)."""
    return torch.version.cuda is not None


def memory_stats(device=None) -> dict:
    """``torch.cuda.memory_stats`` of the card; ``{}`` on the CPU."""
    dev = _target(device)
    return dict(torch.cuda.memory_stats(dev)) if dev.type == "cuda" else {}


def _counter(fn, device) -> int:
    dev = _target(device)
    return int(fn(dev)) if dev.type == "cuda" else 0


def memory_allocated(device=None) -> int:
    """Live bytes of the caching allocator (``torch.cuda``'s)."""
    return _counter(torch.cuda.memory_allocated, device)


def max_memory_allocated(device=None) -> int:
    return _counter(torch.cuda.max_memory_allocated, device)


def memory_reserved(device=None) -> int:
    """Bytes the caching allocator holds from the driver."""
    return _counter(torch.cuda.memory_reserved, device)


def max_memory_reserved(device=None) -> int:
    return _counter(torch.cuda.max_memory_reserved, device)


def get_cudnn_version():
    """cuDNN's version as an int, or None when torch has none."""
    return torch.backends.cudnn.version() if is_compiled_with_cuda() \
        else None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_custom_device(device_type: str = None) -> bool:
    """No custom-device runtime in this build."""
    return False


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_all_custom_device_type():
    return []


def get_available_device():
    """``gpu:<i>`` for each card, or ``cpu:0`` without one."""
    return [("cpu:0" if d.type == "cpu" else f"gpu:{d.index}")
            for d in get_all_devices()]


def get_available_custom_device():
    return []


from ..framework.core_api import CPUPlace as _CPUPlace  # noqa: E402


class XPUPlace(_CPUPlace):
    def __init__(self, device_id: int = 0):
        raise RuntimeError("XPU hardware is not supported by this build")


class IPUPlace(_CPUPlace):
    def __init__(self, device_id: int = 0):
        raise RuntimeError("IPU hardware is not supported by this build")


from . import cuda, xpu  # noqa: E402
from .cuda import Event, Stream, current_stream, stream_guard  # noqa: E402


def set_stream(stream):
    """Make ``stream`` the current stream of its card; returns the one it
    replaces."""
    prev = current_stream(stream.device)
    torch.cuda.set_stream(stream)
    return prev
