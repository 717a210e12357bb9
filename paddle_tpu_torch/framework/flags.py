"""Global flags: ``paddle.set_flags``/``paddle.get_flags``
(``paddle_tpu/framework/flags.py``).

The JAX package's names, defaults, errors and environment pass-through:
a flag set in the environment at import is read with its default's type
and wired as if set. Unknown names that start with ``FLAGS_`` are
stored and do nothing, so configs carry over. The flags that act, and
what each does on torch:

- ``FLAGS_check_nan_inf``: every op of ``autograd.engine.apply_op``
  sweeps its floating outputs and raises ``FloatingPointError`` on a NaN
  or Inf (the JAX package's ``_nan_inf_sweep``); the sweep skips while a
  CUDA graph is being captured, as the JAX one skips tracers.
- ``FLAGS_benchmark``: the card is synchronized after each such op.
- ``FLAGS_matmul_precision``: ``"highest"``/``"float32"`` turn TF32 off
  (``torch.set_float32_matmul_precision("highest")``);
  ``"high"``/``"tensorfloat32"``/``"bfloat16_3x"`` set ``"high"``,
  ``"default"``/``"bfloat16"`` set ``"medium"``.
- ``FLAGS_use_pallas_flash_attention``: False sends
  ``nn.functional.scaled_dot_product_attention`` and ``flash_attention``
  to the plain dense attention (``_sdpa_ref``) on every device; True (the
  default) keeps them on flash attention, whose CUDA kernels K1-K3 run on
  CUDA tensors or raise.

- ``FLAGS_cudnn_deterministic``: True (the default) gives
  ``nn.functional.embedding`` (and the GPT's, Llama's and BERT's
  embeddings through it) the deterministic weight gradient of
  ``ops/embedding_grad.py``, whose CUDA kernel runs on CUDA tensors or
  raises; False gives PyTorch's own, which accumulates with atomics on
  the card.

The others (the allocator flags) are accepted and do nothing.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Union

import torch

__all__ = ["set_flags", "get_flags"]

# flag -> (default, doc), the JAX package's
_DEFS = {
    "FLAGS_check_nan_inf": (False, "per-op NaN/Inf sweep at dispatch"),
    "FLAGS_benchmark": (False, "synchronize the card after each op"),
    "FLAGS_cudnn_deterministic": (True, "deterministic embedding "
                                  "backward"),
    "FLAGS_eager_delete_tensor_gb": (0.0, "accepted; does nothing"),
    "FLAGS_allocator_strategy": ("auto_growth", "accepted; does nothing"),
    "FLAGS_fraction_of_gpu_memory_to_use": (0.92, "accepted; does nothing"),
    "FLAGS_use_pallas_flash_attention": (True,
                                         "route attention to the flash "
                                         "kernels"),
    "FLAGS_matmul_precision": ("highest", "f32 matmul precision"),
}

_PRECISION = {"highest": "highest", "float32": "highest",
              "high": "high", "tensorfloat32": "high", "bfloat16_3x": "high",
              "default": "medium", "bfloat16": "medium"}

_values: Dict[str, object] = {}


def _env_default(name: str, default):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, int):
        return int(raw)
    return raw


def _apply_side_effects(name: str, value) -> None:
    if name == "FLAGS_check_nan_inf":
        from ..autograd import engine

        engine.check_nan_inf_enabled = bool(value)
    elif name == "FLAGS_benchmark":
        from ..autograd import engine

        engine.benchmark_sync_enabled = bool(value)
    elif name == "FLAGS_matmul_precision":
        if str(value) not in _PRECISION:
            raise ValueError(f"FLAGS_matmul_precision {value!r}: one of "
                             f"{sorted(_PRECISION)}")
        torch.set_float32_matmul_precision(_PRECISION[str(value)])
    elif name == "FLAGS_use_pallas_flash_attention":
        from ..nn.functional import attention

        attention.pallas_flash_enabled = bool(value)
    elif name == "FLAGS_cudnn_deterministic":
        from ..nn.functional import common

        common.deterministic_embedding = bool(value)


def _init() -> None:
    for name, (default, _) in _DEFS.items():
        _values[name] = _env_default(name, default)
        if _values[name] != default:
            _apply_side_effects(name, _values[name])


_init()


def set_flags(flags: Dict[str, object]) -> None:
    """Set each ``FLAGS_*`` entry of ``flags`` and wire what it does."""
    if not isinstance(flags, dict):
        raise TypeError("set_flags expects a dict of FLAGS_* entries")
    for name, value in flags.items():
        if not name.startswith("FLAGS_"):
            raise ValueError(f"flag name must start with FLAGS_: {name!r}")
        _apply_side_effects(name, value)
        _values[name] = value


def get_flags(flags: Union[str, Iterable[str]]) -> Dict[str, object]:
    """``{name: value}`` for a name or names; ``ValueError`` for one never
    defined or set."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for name in names:
        if name not in _values:
            raise ValueError(f"unknown flag {name!r}")
        out[name] = _values[name]
    return out
