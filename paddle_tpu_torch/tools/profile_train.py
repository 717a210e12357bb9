"""Where a training step's device time goes, on the card.

    python -m paddle_tpu_torch.tools.profile_train [--model llama] [--steps 3]

Builds the bench's model and optimizer (``bench.build``; ``--model
gpt13``, the default: GPT-3 1.3B, B 8, S 1024, O2 bf16 without master
weights, fused cross entropy, AdamW; ``--model llama``: Llama-0.76B, B 8,
S 1024, full recompute, O2 bf16 with master weights, fused cross
entropy, AdamW), warms
two steps, times ``--steps`` steps without the profiler (one
synchronisation at the end), then ``--steps`` more under
``torch.profiler``. Prints, as one JSON line: the unprofiled step time,
peak device memory, and over the profiled steps: their wall time, the
device's busy time (the union of its kernels' intervals) and idle share
within that same window, the summed duration of every kernel they
launched, launches per step, and device time per step by group:

- ``flash_fwd``, ``flash_dq``, ``flash_dkv``: the three flash kernels;
- ``fused_ce``: every kernel launched inside the fused linear-cross-
  entropy (its f32 chunk GEMMs and their elementwise work);
- ``optimizer``: every kernel launched inside ``Optimizer.step``;
- ``gemm``: the other matrix-product kernels (cuBLAS: the model's bf16
  linears, forward and backward);
- ``other``: the rest (norms, activations, RoPE, adds, casts, copies,
  reductions, the embedding).

Under recompute the forward's kernels run again in the backward; they
count in their groups like any other launch.

It also lists the kernels that took the most device time.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from .. import bench
from . import device_busy

_RANGES = ("fused_linear_cross_entropy", "optimizer.step")
_GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas")


def _group(kernel: str, ranges) -> str:
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        # the f32 kernel and its bf16 tensor-core form
        if f"{name}_kernel" in kernel or f"{name}_bf16_kernel" in kernel:
            return name
    if "fused_linear_cross_entropy" in ranges:
        return "fused_ce"
    if "optimizer.step" in ranges:
        return "optimizer"
    low = kernel.lower()
    if any(m in low for m in _GEMM_MARKS):
        return "gemm"
    return "other"


def _ranges(evt):
    out = set()
    while evt is not None:
        if evt.name in _RANGES:
            out.add(evt.name)
        evt = evt.cpu_parent
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(bench.SETUPS), default="gpt13")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg, B, S, _ = bench.SETUPS[args.model](False)
    model, opt = bench.build(cfg, dev, bench.MASTER_WEIGHT[args.model])
    step = bench.make_train_fn(model, opt)
    rng = np.random.default_rng(0)
    ids_np = rng.integers(0, cfg.vocab_size, (B, S))
    ids = torch.from_numpy(ids_np).to(dev)
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=1)).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        step(ids, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step(ids, labels)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(ids, labels)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    # the record_function ranges also show on the device timeline (as
    # annotations spanning their kernels): leave them out of the sums
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in _RANGES]
    rows = sorted(((e.key, e.device_time_total / 1e3 / args.steps,
                    e.count / args.steps) for e in kernels),
                  key=lambda r: -r[1])
    kernel_ms = sum(ms for _k, ms, _c in rows)
    busy_ms, idle = device_busy(prof.events(), profiled_ms, _RANGES)
    groups = defaultdict(float)
    group_launches = defaultdict(float)
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or not evt.kernels:
            continue
        ranges = _ranges(evt)
        for k in evt.kernels:
            g = _group(k.name, ranges)
            groups[g] += k.duration / 1e3 / args.steps
            group_launches[g] += 1 / args.steps
    print(json.dumps({
        "device": bench.card_label(dev),
        "config": bench.config_name(args.model, cfg, B, S),
        "steps": args.steps, "loss": loss.item(),
        "step_ms": step_ms, "profiled_step_ms": profiled_ms / args.steps,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": idle,
        "kernel_ms_per_step": kernel_ms,
        "launches_per_step": sum(c for _k, _ms, c in rows),
        "groups_ms_per_step": dict(sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
        "groups_launches_per_step": dict(group_launches),
        "top": [{"kernel": k[:100], "ms_per_step": ms, "per_step": c,
                 "share_of_kernel_ms": ms / kernel_ms}
                for k, ms, c in rows[:15]],
    }))


if __name__ == "__main__":
    main()
