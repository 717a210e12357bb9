"""Measurement scripts of the port, run on the card (``python -m
paddle_tpu_torch.tools.<name>``)."""
from __future__ import annotations

from typing import Iterable, Tuple

import torch


def device_busy(events: Iterable, wall_ms: float,
                exclude: Tuple[str, ...] = ()) -> Tuple[float, float]:
    """``(busy ms, idle share)`` of the device over a profiled window that
    lasted ``wall_ms`` on the host's clock. Busy is the length of the union
    of the device intervals of ``events`` (a profiler's ``events()``):
    every kernel, copy and fill, each instant counted once however many
    overlap; user annotations (and the names in ``exclude``), which span
    kernels on the device timeline, are left out. Raises if busy exceeds
    the window: the two then describe different windows."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and e.name not in exclude)
    busy_us, lo, hi = 0.0, None, None
    for start, end in spans:
        if hi is None or start > hi:
            if hi is not None:
                busy_us += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    if hi is not None:
        busy_us += hi - lo
    busy_ms = busy_us / 1e3
    if busy_ms > wall_ms:
        raise RuntimeError(f"device busy {busy_ms:.3f} ms exceeds the "
                           f"profiled window of {wall_ms:.3f} ms")
    return busy_ms, 1.0 - busy_ms / wall_ms
