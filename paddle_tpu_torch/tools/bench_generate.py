"""Dense KV-cache generation throughput on the card: Llama-0.76B and
GPT-355M, greedy, through ``model.generate``.

    python -m paddle_tpu_torch.tools.bench_generate [--model llama|gpt|both]
    python -m paddle_tpu_torch.tools.bench_generate --small --device cpu

Counterpart of the JAX tool's dense rows (``tools/bench_decode.py``
``_build``/``_bench_one``): the models as ``_build`` defines them, f32
(no ``amp.decorate``), weights from seed 0, ``max_position_embeddings``
= prompt + new; B 8, prompt 128, 128 new tokens, ids from numpy seed 0;
``generate(ids, max_new_tokens=new, temperature=0.0, device_loop=True)``
once (``first_s``: the kernels' and libraries' warm-up and the programs'
eager first calls), then three times (the second call captures the
prefill program, the loop body was captured in the first), the best of
the three setting ``total_s``. There is no round trip to subtract (no
tunnel): ``generate`` returns after its one host read. ``--small``:
vocab 128, hidden 64, 2 layers, 4 heads, on the given device.

Prints one JSON line a model: tokens/s, ``total_s``, ms per token,
``first_s``, ``capture_s`` and ``compile_counts`` of each program
(prefill, decode, device loop), peak memory and the card's name and
power limit. ``--profile`` then traces one more call with
``torch.profiler`` and adds ``profile``: the call's wall and device
milliseconds, its kernel count, and the kernels with the most device
time (name, launches, total and mean µs).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import generator
from ..bench import card_label
from ..device import resolve_device
from ..models import GPTConfig, GPTForCausalLM, LlamaConfig, LlamaForCausalLM

__all__ = ["build", "bench_one", "program_stats", "MODELS"]

MODELS = ("llama", "gpt")


def build(model_name: str, prompt: int, new: int, small: bool, device):
    """``(model, vocab, label)`` of the JAX tool's ``_build``, f32 on
    ``device``, from seed 0."""
    generator.seed(0)
    if model_name == "gpt":
        cfg = GPTConfig(vocab_size=128 if small else 50304,
                        hidden_size=64 if small else 1024,
                        num_layers=2 if small else 24,
                        num_heads=4 if small else 16,
                        max_position_embeddings=prompt + new,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
        return (GPTForCausalLM(cfg, device=device, seed=0), cfg.vocab_size,
                "gpt-355m")
    cfg = LlamaConfig(vocab_size=128 if small else 32000,
                      hidden_size=64 if small else 2048,
                      num_layers=2 if small else 12,
                      num_heads=4 if small else 16,
                      num_key_value_heads=4 if small else 16,
                      max_position_embeddings=prompt + new)
    return (LlamaForCausalLM(cfg, device=device, seed=0), cfg.vocab_size,
            "llama-0.76b")


def program_stats(model) -> dict:
    """Per signature of ``model.generate``: each program's
    ``compile_counts`` and capture seconds."""
    out = {}
    for key, sig in model._generation_programs.items():
        progs = {"prefill": sig.prefill, "decode": sig.decode,
                 "loop": sig.loop}
        out[str(key)] = {
            name: {"compile_counts": p.compile_counts(),
                   "capture_s": round(sum(p.capture_seconds().values()), 4)}
            for name, p in progs.items() if p is not None}
    return out


def bench_one(model_name: str, B: int = 8, prompt: int = 128,
              new: int = 128, device=None, small: bool = False,
              built=None) -> dict:
    """One model's record (module docstring); ``built`` reuses
    :func:`build`'s ``(model, vocab, label)``."""
    model, vocab, label = built or build(model_name, prompt, new, small,
                                         resolve_device(device))
    device = model.device
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab, (B, prompt))).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new, temperature=0.0,
                         device_loop=True)
    first_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        again = model.generate(ids, max_new_tokens=new, temperature=0.0,
                               device_loop=True)
        best = min(best, time.perf_counter() - t0)
    if not torch.equal(again._value, out._value):
        raise RuntimeError(f"{label}: repeated greedy calls differ")
    stats = program_stats(model)
    captures = sum(p["capture_s"] for sig in stats.values()
                   for p in sig.values())
    return {
        "metric": f"{model_name}_generate_tokens_per_sec_per_chip",
        "value": round(B * new / best, 1), "unit": "tokens/s",
        "config": f"{label}-generate-b{B}-p{prompt}-n{new}-greedy-f32",
        "total_s": round(best, 4), "first_s": round(first_s, 3),
        "per_token_ms": round(1e3 * best / new, 3),
        "capture_s": round(captures, 4), "programs": stats,
        "peak_memory_gib": (round(torch.cuda.max_memory_allocated(device)
                                  / 2**30, 2)
                            if device.type == "cuda" else None),
        "device": card_label(device),
    }


def profile_one(model, ids, new: int, top: int = 15) -> dict:
    """One greedy device-loop call of ``model.generate`` traced with
    ``torch.profiler`` (CUDA activity): wall ms, device ms (the sum of
    every kernel's time), the kernel count, and the ``top`` kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(ids, max_new_tokens=new, temperature=0.0,
                       device_loop=True)
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            k = kernels.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += ev.time_range.end - ev.time_range.start
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {"wall_ms": round(1e3 * wall, 2),
            "device_ms": round(sum(v[1] for v in kernels.values()) / 1e3,
                               2),
            "kernels": sum(v[0] for v in kernels.values()),
            "top": [{"name": n[:90], "launches": c, "total_us": round(t, 1),
                     "mean_us": round(t / c, 2)} for n, (c, t) in
                    rows[:top]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=MODELS + ("both",), default="both")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more call (card only)")
    args = ap.parse_args(argv)
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
    for name in MODELS if args.model == "both" else (args.model,):
        built = build(name, 128, 128, args.small,
                      resolve_device(args.device))
        rec = bench_one(name, small=args.small, built=built)
        if args.profile:
            ids = torch.from_numpy(np.random.default_rng(0).integers(
                0, built[1], (8, 128))).to(built[0].device)
            rec["profile"] = profile_one(built[0], ids, 128)
        print(json.dumps(rec), flush=True)
        del built


if __name__ == "__main__":
    main()
