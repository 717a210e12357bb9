"""The profilers' busy time and idle share (``paddle_tpu_torch.tools``):
the union of device intervals inside the profiled window."""
from types import SimpleNamespace

import pytest
import torch

from paddle_tpu_torch.tools import device_busy

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _evt(name, start_us, end_us, device=CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start_us,
                                                      end=end_us))


@pytest.mark.parametrize("events, busy_ms", [
    ([], 0.0),
    # disjoint kernels add up
    ([_evt("a", 0, 1000), _evt("b", 3000, 4500)], 2.5),
    # overlapping and nested kernels count each instant once, in any order
    ([_evt("b", 500, 2000), _evt("a", 0, 1000), _evt("c", 600, 700),
      _evt("d", 2000, 2500)], 2.5),
    # host events, annotations and excluded ranges span kernels: left out
    ([_evt("a", 0, 1000), _evt("step", 0, 9000, device=CPU),
      _evt("ann", 0, 9000, annotation=True),
      _evt("optimizer.step", 0, 9000)], 1.0),
])
def test_busy_is_the_union_of_device_intervals(events, busy_ms):
    busy, idle = device_busy(events, 10.0, exclude=("optimizer.step",))
    assert busy == pytest.approx(busy_ms)
    assert idle == pytest.approx(1.0 - busy_ms / 10.0)


def test_busy_beyond_the_window_raises():
    with pytest.raises(RuntimeError, match="exceeds"):
        device_busy([_evt("a", 0, 4000), _evt("b", 5000, 9000)], 7.5)
