"""``paddle.incubate.autotune`` (``paddle_tpu/incubate/autotune.py``):
runtime tuning switches.

``set_config`` takes ``{"kernel": {...}, "layout": {...},
"dataloader": {...}}``, a path to such a JSON file, or None (every domain
on). ``kernel.enable`` is the user's switch of the flash attention
kernels: it sets ``nn.functional.attention.pallas_flash_enabled``, as
``FLAGS_use_pallas_flash_attention`` does, so False sends every
attention call to the dense version on every device. ``layout`` and
``dataloader`` are recorded (cuDNN and the DataLoader choose their own).
"""
from __future__ import annotations

import json
from typing import Optional, Union

__all__ = ["set_config", "autotune_status"]

_status = {
    "kernel": {"enable": True},
    "layout": {"enable": False},
    "dataloader": {"enable": False, "tuning_steps": 25},
}


def set_config(config: Optional[Union[dict, str]] = None) -> None:
    """Turn autotune domains on or off (module docstring); ``TypeError``
    for anything but None, a dict or a JSON path, or a domain that is
    not a dict."""
    if config is None:
        for domain in _status.values():
            domain["enable"] = True
    else:
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise TypeError("set_config expects None, a dict, or a JSON path")
        for domain in ("kernel", "layout", "dataloader"):
            if domain in config:
                if not isinstance(config[domain], dict):
                    raise TypeError(f"autotune config[{domain!r}] must be "
                                    "a dict")
                _status[domain].update(config[domain])

    from ..nn.functional import attention as _attn

    _attn.pallas_flash_enabled = bool(_status["kernel"]["enable"])


def autotune_status() -> dict:
    """A copy of the current configuration."""
    return json.loads(json.dumps(_status))
