"""``paddle.device.cuda`` (``paddle_tpu/device/cuda/__init__.py``) on
``torch.cuda``.

With a card it answers for the card: the counts, the allocator's memory
counters, the device's properties, and ``Stream``/``Event``, which are
``torch.cuda``'s (Paddle's stream priority 1 is high, 2 normal; torch's
-1 and 0). The port's kernels launch on PyTorch's current stream, so
work under ``stream_guard(s)`` runs on ``s``.

Without one it answers as the JAX module does, which carries the
reference's CPU-build semantics: ``device_count() == 0``, the memory
queries give 0, ``empty_cache`` does nothing, and what needs a device
(``synchronize``, ``current_stream``, ``stream_guard``, the properties,
``Stream``, ``Event``) raises ``ValueError``.
"""
import contextlib

import torch

__all__ = [
    "Stream", "Event", "current_stream", "synchronize", "device_count",
    "empty_cache", "max_memory_allocated", "max_memory_reserved",
    "memory_allocated", "memory_reserved", "stream_guard",
    "get_device_properties", "get_device_name", "get_device_capability",
]

_ERR = ("Cannot use CUDA: no CUDA device is available to this process "
        "(paddle_tpu_torch runs CUDA work on a card).")


def _card(device=None) -> torch.device:
    """The card ``device`` names (an index, ``gpu:N``, ``cuda:N``, a
    ``torch.device``; default the current one); ``ValueError`` without
    a card."""
    if not torch.cuda.is_available():
        raise ValueError(_ERR)
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    if isinstance(device, int):
        return torch.device("cuda", device)
    name = str(device)
    dev = torch.device("cuda" + name[3:] if name.startswith("gpu") else name)
    if dev.type != "cuda":
        raise ValueError(f"{device!r} is not a CUDA device")
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def empty_cache() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _bytes(fn, device) -> int:
    return int(fn(_card(device))) if torch.cuda.is_available() else 0


def memory_allocated(device=None) -> int:
    return _bytes(torch.cuda.memory_allocated, device)


def memory_reserved(device=None) -> int:
    return _bytes(torch.cuda.memory_reserved, device)


def max_memory_allocated(device=None) -> int:
    return _bytes(torch.cuda.max_memory_allocated, device)


def max_memory_reserved(device=None) -> int:
    return _bytes(torch.cuda.max_memory_reserved, device)


def synchronize(device=None):
    torch.cuda.synchronize(_card(device))


def current_stream(device=None):
    return torch.cuda.current_stream(_card(device))


@contextlib.contextmanager
def stream_guard(stream):
    """Within the block, ``stream`` is its card's current stream."""
    _card()
    with torch.cuda.stream(stream):
        yield stream


def get_device_properties(device=None):
    return torch.cuda.get_device_properties(_card(device))


def get_device_name(device=None):
    return torch.cuda.get_device_name(_card(device))


def get_device_capability(device=None):
    return torch.cuda.get_device_capability(_card(device))


class Stream(torch.cuda.Stream):
    """A CUDA stream of a card (``torch.cuda.Stream``); ``priority`` in
    Paddle's terms (1 high, 2 normal)."""

    def __new__(cls, device=None, priority=2, **kwargs):
        return super().__new__(cls, device=_card(device),
                               priority=-1 if priority == 1 else 0, **kwargs)


class Event(torch.cuda.Event):
    """A CUDA event (``torch.cuda.Event``): ``record``, ``query``,
    ``synchronize``, ``elapsed_time`` in ms."""

    def __new__(cls, enable_timing=False, blocking=False, interprocess=False):
        _card()
        return super().__new__(cls, enable_timing=enable_timing,
                               blocking=blocking, interprocess=interprocess)
