"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package grows
beside it slice by slice, keeping its module layout and names so each
module has an obvious counterpart. It imports torch and numpy, never
jax or paddle_tpu.

Slice 1 is the serving data plane: ``serving.ServingEngine`` serves
``models.LlamaForCausalLM`` through the paged KV pool, the chunked-prefill
scheduler and one ragged step per engine iteration, whose attention is
the hand-written CUDA kernel ``csrc/paged_attention.cu``.

Slice 2 is the GPT training step of the root ``bench.py``'s
``bench_gpt13``: ``models.GPTForCausalLM`` under ``amp`` O2 bf16 (the
JAX package's per-op cast rule), the fused chunked cross entropy and
``optimizer.AdamW``, run by ``python -m paddle_tpu_torch.bench``, whose
attention is the hand-written CUDA flash kernels of
``csrc/flash_attention.cu`` (forward, dQ, dK/dV) behind one
``torch.autograd.Function``.

Slice 3 trains Llama as the root ``bench.py``'s ``bench_llama`` does
(``models.LlamaForCausalLM.forward`` with every layer under
``distributed.fleet.recompute``, O2 bf16 with master weights, through
the same flash kernels; ``python -m paddle_tpu_torch.bench --model
llama``), and ports the last Pallas kernel, the fused AdamW step, as
``csrc/fused_adamw.cu`` behind ``ops.fused_adamw`` and its A/B tool
``python -m paddle_tpu_torch.tools.bench_adamw``.

Every entry point runs on ``cuda`` unless given ``device="cpu"``
(:mod:`.device`); kernels are built from ``csrc/`` with ``nvcc`` at first
use (:mod:`.ops._build`).
"""
from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
