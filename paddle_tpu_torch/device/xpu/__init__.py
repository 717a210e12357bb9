"""``paddle.device.xpu`` (``paddle_tpu/device/xpu/__init__.py``): no XPU
in this build."""
__all__ = ["synchronize"]


def synchronize(device=None):
    raise ValueError(
        "Cannot use XPU on this build: paddle_tpu_torch is built for CUDA "
        "devices. Use paddle.device APIs for the card.")
