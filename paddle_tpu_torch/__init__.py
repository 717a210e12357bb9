"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package grows
beside it slice by slice, keeping its module layout and names so each
module has an obvious counterpart. It imports torch and numpy, never
jax or paddle_tpu.

Slice 1 is the serving data plane: ``serving.ServingEngine`` serves
``models.LlamaForCausalLM`` through the paged KV pool, the chunked-prefill
scheduler and one ragged step per engine iteration, whose attention is
the hand-written CUDA kernel ``csrc/paged_attention.cu``.

Every entry point runs on ``cuda`` unless given ``device="cpu"``
(:mod:`.device`); kernels are built from ``csrc/`` with ``nvcc`` at first
use (:mod:`.ops._build`).
"""
from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
