"""Where the serving step's device time goes, for Llama-0.76B on the card.

    python -m paddle_tpu_torch.tools.profile_serve [--steps 8] [--eager]

Builds the model and engine that ``chip_smoke.py`` serves (Llama-0.76B,
seeded random weights in bf16 by ``amp.decorate(level="O2")``'s rule, so
the norms f32 and the activations f32, as the JAX package serves it;
bf16 pages of 16, 8 slots, token budget 1024), fills all 8 slots with prompts of 64-1024 tokens, runs until
every slot decodes, then times ``--steps`` decode-only steps without
the profiler and ``--steps`` more under it. The step is the engine's
default, its program captured as a CUDA graph per token-grid bucket and
replayed; ``--eager`` runs the same program eagerly. With the graph, the
decode bucket's graph is also replayed alone ``--steps`` times between
CUDA events: the card's time for one step's kernels without the host's
(``graph_replay_ms``). Prints, as one JSON line: the
unprofiled step time; over the profiled steps, their wall time, the
device's busy time (the union of its kernels' intervals) and idle share
within that same window, and the summed duration of every kernel they
launched (a kernel's duration, once; not its parent operator's share);
the device time of K4, ragged paged attention (its attention kernel
and, where a call splits rows across blocks, its merge pass), with its
launches; and the kernels that took the most device time, with their
launch counts and shares.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import bench
from ..models import LlamaConfig, LlamaForCausalLM
from ..serving import ServingEngine
from . import device_busy

# the kernels of one K4 call: the attention kernel and its merge pass
_K4_KERNELS = ("paged_attention_kernel", "paged_merge_kernel")


def k4_time(rows):
    """``(ms, launches)`` per step of K4 over ``(kernel, ms, launches)``
    rows: both of its kernels, summed."""
    mine = [(ms, c) for k, ms, c in rows if any(n in k for n in _K4_KERNELS)]
    return sum(ms for ms, _c in mine), sum(c for _ms, c in mine)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--eager", action="store_true",
                    help="run the step eagerly instead of replaying its "
                         "CUDA graph")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=12,
                      num_heads=16, num_key_value_heads=16,
                      max_position_embeddings=2048)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    engine = ServingEngine(model, page_size=16, max_batch_slots=8,
                           max_model_len=2048, token_budget=1024,
                           kv_dtype=torch.bfloat16,
                           cuda_graph=not args.eager, device="cuda")
    rng = np.random.default_rng(0)
    for n in rng.integers(64, 1025, 8):
        engine.add_request(rng.integers(0, cfg.vocab_size, int(n)),
                           max_new_tokens=args.steps + 40)
    while any(s is None or s.prefilling for s in engine.slots):
        engine.step()
    for _ in range(3):  # warm, decode-only
        engine.step()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    replay_ms = None
    if not args.eager:
        graph = engine._programs[engine.max_batch_slots].graph
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.steps):  # rewrites the last step's KV slots
            graph.replay()
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end) / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.key, e.device_time_total / 1e3 / args.steps,
                    e.count / args.steps) for e in kernels),
                  key=lambda r: -r[1])
    kernel_ms = sum(ms for _k, ms, _c in rows)
    k4_ms, k4_launches = k4_time(rows)
    busy_ms, idle = device_busy(prof.events(), profiled_ms)
    print(json.dumps({
        "device": bench.card_label(torch.device("cuda")),
        "decode_steps": args.steps, "batch": engine.max_batch_slots,
        "step": "eager" if args.eager else "cuda_graph",
        "step_ms": step_ms, "graph_replay_ms": replay_ms,
        "profiled_step_ms": profiled_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": idle,
        "kernel_ms_per_step": kernel_ms,
        "kernels": len(rows),
        "launches_per_step": sum(c for _k, _ms, c in rows),
        "k4_ms_per_step": k4_ms, "k4_kernel_launches_per_step": k4_launches,
        "top": [{"kernel": k[:90], "ms_per_step": ms, "per_step": c,
                 "share_of_kernel_ms": ms / kernel_ms}
                for k, ms, c in rows[:12]],
    }))


if __name__ == "__main__":
    main()
