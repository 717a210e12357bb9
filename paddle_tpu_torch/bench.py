"""Training throughput on the card: GPT-3 1.3B and Llama-0.76B.

    python -m paddle_tpu_torch.bench                  # gpt13 on cuda
    python -m paddle_tpu_torch.bench --model llama
    python -m paddle_tpu_torch.bench --small --device cpu [--model llama]

Counterpart of the root ``bench.py``'s ``bench_gpt13``, ``bench_llama``
and ``_time_steps``, run eagerly (CUDA graphs, the counterpart of its
``jit.StaticFunction``, are later work). Each model takes its bench's
configuration at the bench's defaults:

- ``gpt13``: GPT-3 XL (vocab 50304, hidden 2048, 24 layers, 16 heads of
  128), B 8, S 1024, no dropout, no recompute, the fused chunked cross
  entropy, ``amp.decorate(level="O2", dtype="bfloat16",
  master_weight=False)``. ``--small``: hidden 256, 4 layers, 2 heads of
  128, vocab 2048, B 2, S 256, 3 steps.
- ``llama``: Llama-0.76B (vocab 32000, hidden 2048, 12 layers, 16 heads
  = 16 KV heads, intermediate 5632), B 8, S 1024, full recompute of
  every layer, the fused cross entropy, ``amp.decorate(level="O2",
  dtype="bfloat16")`` with master weights. ``--small``:
  ``llama_tiny(recompute=False, fused_loss=True)``, B 2, S 128, 3 steps.

Both train with ``AdamW(learning_rate=1e-4)`` and the step
``loss.backward(); opt.step(); opt.clear_grad()`` under
``amp.auto_cast(level="O2")``, from ``generator.seed(0)`` and token ids
from numpy seed 0.

Timing as there: one first step (``compile_s``: here the kernels' build
and the libraries' warm-up), two warm steps, then 3 blocks of 10 steps
(3 small), each block ending in one device synchronisation; the best
block sets ``step_ms``. Prints one JSON line: tokens/s, step ms,
achieved TFLOP/s (6 x params x tokens/s), MFU against the H100's dense
bf16 peak of 989 TFLOP/s, the last loss, and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import amp, generator
from .device import resolve_device
from .models import GPTConfig, GPTForCausalLM, LlamaConfig, LlamaForCausalLM
from .models import llama_tiny
from .optimizer import AdamW

__all__ = ["gpt13_setup", "llama_setup", "SETUPS", "MASTER_WEIGHT", "build",
           "make_train_fn", "time_steps", "config_name", "bench_model",
           "bench_gpt13", "bench_llama", "card_label",
           "H100_BF16_PEAK_TFLOPS"]

H100_BF16_PEAK_TFLOPS = 989.0  # dense, SXM, 700 W (NVIDIA data sheet)


def gpt13_setup(small: bool):
    """``(config, batch, seq, steps)`` of ``bench_gpt13`` at its
    defaults."""
    if small:
        S = 256
        cfg = GPTConfig(vocab_size=2048, hidden_size=256, num_layers=4,
                        num_heads=2, max_position_embeddings=max(S, 512),
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                        fused_loss=True)
        return cfg, 2, S, 3
    S = 1024
    cfg = GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                    num_heads=16, max_position_embeddings=max(S, 1024),
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                    fused_loss=True)
    return cfg, 8, S, 10


def llama_setup(small: bool):
    """``(config, batch, seq, steps)`` of ``bench_llama`` at its
    defaults."""
    if small:
        return llama_tiny(recompute=False, fused_loss=True), 2, 128, 3
    S = 1024
    cfg = LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=12,
                      num_heads=16, num_key_value_heads=16,
                      max_position_embeddings=max(S, 1024), recompute=True,
                      recompute_policy=None, fused_loss=True)
    return cfg, 8, S, 10


SETUPS = {"gpt13": gpt13_setup, "llama": llama_setup}
# each bench's decorate: gpt13 without master weights, llama with them
MASTER_WEIGHT = {"gpt13": False, "llama": None}


def build(cfg, device, master_weight: Optional[bool] = False):
    """The bench's model and optimizer, decorated for O2 bf16, from
    ``generator.seed(0)``. ``master_weight=None`` turns master weights on,
    as ``amp.decorate`` does by default."""
    generator.seed(0)
    if isinstance(cfg, LlamaConfig):
        model = LlamaForCausalLM(cfg, device=device,
                                 seed=generator.next_seed())
    else:
        model = GPTForCausalLM(cfg, device=device)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    return amp.decorate(model, opt, level="O2", dtype="bfloat16",
                        master_weight=master_weight)


def make_train_fn(model, opt) -> Callable:
    """The bench's ``train_fn``: one step, returning the loss."""
    def train_fn(ids, labels):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            _, loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return train_fn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(step: Callable, args, steps: int, reps: int,
               device: torch.device):
    """``(best seconds per step, first step's seconds, every step's
    loss)``: one first step, two warm steps, ``reps`` blocks of ``steps``
    back-to-back steps with one synchronisation at each block's end."""
    losses: List[torch.Tensor] = []
    t0 = time.perf_counter()
    losses.append(step(*args).detach())
    _sync(device)
    first_s = time.perf_counter() - t0
    for _ in range(2):
        losses.append(step(*args).detach())
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(step(*args).detach())
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best / steps, first_s, [float(x) for x in losses]


def card_label(device: torch.device) -> str:
    """``name, power limit`` as ``nvidia-smi`` reports them (the CUDA
    device's name alone if it cannot be asked), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)
    out = smi.stdout.strip()
    return out if smi.returncode == 0 and out else \
        torch.cuda.get_device_name(device)


def config_name(model: str, cfg, B: int, S: int) -> str:
    """The record's ``config``, as the root ``bench.py`` spells it."""
    head = f"-h{cfg.hidden_size}-l{cfg.num_layers}-b{B}-s{S}-bf16"
    if model == "gpt13":
        return "gpt13" + head + "-fce-nomaster"
    rc = ""
    if cfg.recompute:
        rc = "-rc" + (f":{cfg.recompute_policy}" if cfg.recompute_policy
                      else "")
    return "llama" + head + rc + ("-fce" if cfg.fused_loss else "")


def bench_model(model: str = "gpt13", small: bool = False, device=None,
                steps: Optional[int] = None, reps: int = 3) -> dict:
    """Run the bench of ``model`` (``gpt13`` or ``llama``); returns its
    record plus ``losses`` (every step's, in order) and ``steps_run``."""
    device = resolve_device(device)
    cfg, B, S, default_steps = SETUPS[model](small)
    steps = default_steps if steps is None else int(steps)
    model_, opt = build(cfg, device, MASTER_WEIGHT[model])
    rng = np.random.default_rng(0)
    ids_np = rng.integers(0, cfg.vocab_size, (B, S))
    ids = torch.from_numpy(ids_np).to(device)
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=1)).to(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dt, first_s, losses = time_steps(make_train_fn(model_, opt),
                                     (ids, labels), steps, reps, device)
    tokens_per_s = B * S / dt
    n_params = sum(p.numel() for p in model_.parameters())
    achieved = 6 * n_params * tokens_per_s / 1e12
    record = {
        "metric": f"{model}_tokens_per_sec_per_chip",
        "value": round(tokens_per_s, 1),
        "unit": "tokens/s",
        "vs_baseline": 1.0,
        "config": config_name(model, cfg, B, S),
        "params_m": round(n_params / 1e6, 1),
        "loss": losses[-1],
        "step_ms": round(1000 * dt, 1),
        "compile_s": round(first_s, 1),
        "achieved_tflops_per_s": round(achieved, 2),
        "mfu": (round(achieved / H100_BF16_PEAK_TFLOPS, 4)
                if device.type == "cuda" else None),
        "peak_memory_gib": (round(torch.cuda.max_memory_allocated(device)
                                  / 2**30, 2)
                            if device.type == "cuda" else None),
        "device": card_label(device),
    }
    return dict(record, losses=losses, steps_run=len(losses))


def bench_gpt13(small: bool = False, device=None,
                steps: Optional[int] = None, reps: int = 3) -> dict:
    return bench_model("gpt13", small, device, steps, reps)


def bench_llama(small: bool = False, device=None,
                steps: Optional[int] = None, reps: int = 3) -> dict:
    return bench_model("llama", small, device, steps, reps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(SETUPS), default="gpt13")
    ap.add_argument("--small", action="store_true",
                    help="the bench's small configuration")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
    rec = bench_model(args.model, args.small, args.device)
    rec.pop("losses")
    rec.pop("steps_run")
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
