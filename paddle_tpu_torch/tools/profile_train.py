"""Where a training step's device time goes, on the card.

    python -m paddle_tpu_torch.tools.profile_train
        [--model llama|bert|resnet50] [--steps 3] [--graphed]

Builds the bench's model and optimizer (``bench.build``; ``--model
gpt13``, the default: GPT-3 1.3B, B 8, S 1024, O2 bf16 without master
weights, fused cross entropy, AdamW; ``--model llama``: Llama-0.76B, B 8,
S 1024, full recompute, O2 bf16 with master weights, fused cross
entropy, AdamW; ``--model bert``: BERT-base pretraining, B 32, S 128,
O2 bf16 with master weights, dropout 0.1, AdamW, its step on facade
tensors as ``bench.make_bert_train_fn`` writes it; ``--model
resnet50``: ResNet-50, B 64, 224 x 224, O2 bf16 with master weights,
``Momentum(0.1, 0.9)``, ``bench.make_resnet_train_fn``'s step), warms
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
- ``mlm_ce``: BERT's MLM cross entropy over ``[B * S, vocab]`` logits:
  the kernels of its forward (inside the model's ``mlm_cross_entropy``
  range: the f32 cast, the log-softmax, the gather, the mean) and of its
  ``LogSoftmaxBackward0`` and ``GatherBackward0`` nodes (not for ResNet,
  whose cross entropy is in ``other``);
- ``optimizer``: every kernel launched inside ``Optimizer.step``;
- ResNet's groups: ``conv_fwd``, ``conv_dgrad`` and ``conv_wgrad``
  (cuDNN's kernels inside ``F.conv2d`` and its ``ConvolutionBackward0``
  nodes, the backward split by the kernels' ``dgrad``/``wgrad`` names),
  ``conv_gemm`` (cuBLAS GEMMs launched there), ``conv_other`` (cuDNN's
  other kernels there: layout transposes, reductions), ``batchnorm`` (every kernel of ``F.batch_norm`` and of
  the backward nodes its ops made: the f32 chain of casts, means,
  variances and the affine), ``pooling`` (``F.max_pool2d``,
  ``F.adaptive_avg_pool2d`` and their backward nodes). The tool wraps
  those four functionals in ``record_function`` ranges while it runs;
  a backward node belongs to the range its forward op ran in (the
  profiler's ``sequence_nr``);
- ``gemm``: the other matrix-product kernels (cuBLAS: the model's bf16
  linears, forward and backward);
- ``other``: the rest (norms, activations, RoPE, adds, casts, copies,
  reductions, the embedding).

Under recompute the forward's kernels run again in the backward; they
count in their groups like any other launch.

``--graphed`` profiles the replayed step: the bench's default step,
``jit.StaticFunction(train_fn, observe=[model, opt], warmup=False)``
over ``paddle.to_tensor`` ids, warmed by its eager first call and its
capture. A replay's kernels carry no host range, so each is given the
group of the same kernel in one eager call of ``train_fn`` profiled
just before (the two launch sequences aligned by kernel name, in order,
by their longest common subsequence: the eager call's lr fill and the
copies around a replay are launches only one of them makes); kernels
left unaligned are grouped by name.

It also lists the kernels that took the most device time, overall and
in each group.
"""
from __future__ import annotations

import argparse
import difflib
import json
import time
from collections import defaultdict

import numpy as np
import torch

from .. import bench, jit
from . import device_busy

_RANGES = ("fused_linear_cross_entropy", "optimizer.step",
           "mlm_cross_entropy")
# the functionals ResNet's groups come from, wrapped in ranges by name
_VISION = ("conv2d", "batch_norm", "max_pool2d", "adaptive_avg_pool2d")
# names whose ranges the device timeline shows as annotations
_ANNOTATIONS = _RANGES + _VISION
_CONV_MARKS = ("conv", "xmma", "cudnn", "cutlass", "implicit", "fprop",
               "dgrad", "wgrad", "nchw", "nhwc", "sm90", "gemm")
# backward nodes of the MLM cross entropy (BERT runs no other)
_CE_BACKWARD = ("LogSoftmaxBackward0", "GatherBackward0")
_GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas")


def _vision_group(kernel: str, ranges):
    """ResNet's group of a kernel launched in one of the ``_VISION``
    ranges or their backward nodes (``<range>.bwd``), or None."""
    low = kernel.lower()
    if "conv2d" in ranges or "conv2d.bwd" in ranges:
        if "dgrad" in low:
            return "conv_dgrad"
        if "wgrad" in low:
            return "conv_wgrad"
        if "nvjet" in low or "cublas" in low:
            return "conv_gemm"
        if not any(m in low for m in _CONV_MARKS):
            return None  # an amp cast at the conv's input: the rest
        if "conv2d" in ranges and ("fprop" in low or "conv" in low
                                   or "gemm" in low or "xmma" in low):
            return "conv_fwd"
        return "conv_other"
    if "batch_norm" in ranges or "batch_norm.bwd" in ranges:
        return "batchnorm"
    if any(r in ranges for p in ("max_pool2d", "adaptive_avg_pool2d")
           for r in (p, p + ".bwd")):
        return "pooling"
    return None


def _group(kernel: str, ranges) -> str:
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        # the f32 kernel and its bf16 tensor-core form
        if f"{name}_kernel" in kernel or f"{name}_bf16_kernel" in kernel:
            return name
    if "fused_linear_cross_entropy" in ranges:
        return "fused_ce"
    if "mlm_cross_entropy" in ranges:
        return "mlm_ce"
    if "optimizer.step" in ranges:
        return "optimizer"
    vision = _vision_group(kernel, ranges)
    if vision:
        return vision
    low = kernel.lower()
    if any(m in low for m in _GEMM_MARKS):
        return "gemm"
    return "other"


def _eager_sequence(events):
    """``(kernel name, group)`` of an eager step, in launch order (one
    stream: the order in which they ran)."""
    seqs = _forward_ranges(events)
    ops = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.kernels), key=lambda e: e.time_range.start)
    return [(k.name, _group(k.name, _ranges(e, seqs))) for e in ops
            for k in e.kernels]


def _forward_ranges(events):
    """``sequence_nr -> range`` of every forward op run inside one of the
    ``_VISION`` ranges: its backward node's kernels join that range's
    group."""
    out = {}
    for e in events:
        seq = getattr(e, "sequence_nr", -1)
        if (e.device_type != torch.autograd.DeviceType.CPU or seq is None
                or seq < 0 or "evaluate_function" in e.name):
            continue
        p = e.cpu_parent
        while p is not None:
            if p.name in _VISION:
                out[seq] = p.name
                break
            p = p.cpu_parent
    return out


def _device_kernels(events):
    """``(name, ms)`` of every device interval, by start time."""
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for e in sorted(
                (e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.name not in _ANNOTATIONS),
                key=lambda e: e.time_range.start)]


def _align(ref, names):
    """For each of ``names``, the index of the same kernel in ``ref`` or
    None: the matching blocks of the two sequences' longest common
    subsequence (``difflib``, no junk heuristic), so runs present in one
    sequence only are skipped over wherever they fall."""
    out = [None] * len(names)
    sm = difflib.SequenceMatcher(None, ref, names, autojunk=False)
    for a, b, size in sm.get_matching_blocks():
        for k in range(size):
            out[b + k] = a + k
    return out


def _ranges(evt, seqs=None):
    out = set()
    while evt is not None:
        if evt.name in _RANGES or evt.name in _VISION:
            out.add(evt.name)
        elif not seqs and any(b in evt.name for b in _CE_BACKWARD):
            out.add("mlm_cross_entropy")
        elif seqs and "evaluate_function" in evt.name \
                and getattr(evt, "sequence_nr", -1) in seqs:
            out.add(seqs[evt.sequence_nr] + ".bwd")
        evt = evt.cpu_parent
    return out


def _wrap_vision_ranges():
    """Wrap ``nn.functional``'s ``_VISION`` functionals in
    ``record_function`` ranges of their names (the layers look them up
    on the module at each call)."""
    from ..nn import functional as F

    def wrap(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    for name in _VISION:
        setattr(F, name, wrap(name, getattr(F, name)))


def _graphed_groups(prof_events, eager_seq, steps):
    """Device ms and launches per step by group of the replayed steps in
    ``prof_events`` (``steps`` replays), each kernel grouped as its
    aligned eager kernel (module docstring)."""
    kernels = _device_kernels(prof_events)
    per = len(kernels) // steps
    ref = [n for n, _g in eager_seq]
    groups, launches = defaultdict(float), defaultdict(float)
    by_kernel = defaultdict(float)
    unaligned = 0
    for s in range(steps):
        chunk = kernels[s * per:(s + 1) * per]
        for (name, ms), at in zip(chunk, _align(ref, [n for n, _ in chunk])):
            if at is None:
                unaligned += 1
                g = _group(name, set())
            else:
                g = eager_seq[at][1]
            groups[g] += ms / steps
            launches[g] += 1 / steps
            by_kernel[g, name] += ms / steps
    return groups, launches, per, unaligned / steps, by_kernel


def _group_tops(by_kernel, n=3):
    """The ``n`` kernels with the most device ms per step in each
    group."""
    out = defaultdict(list)
    for (g, name), ms in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        if len(out[g]) < n:
            out[g].append({"kernel": name[:90], "ms_per_step": ms})
    return dict(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(bench.SETUPS), default="gpt13")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--graphed", action="store_true",
                    help="profile the StaticFunction step's replays")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg, B, S, _ = bench.SETUPS[args.model](False)
    model, opt = bench.build(cfg, dev, bench.MASTER_WEIGHT[args.model])
    if args.model == "bert":
        train_fn = step = bench.make_bert_train_fn(model, opt)
        inputs = bench.bert_data(cfg, B, S, dev)
    elif args.model == "resnet50":
        _wrap_vision_ranges()
        train_fn = step = bench.make_resnet_train_fn(model, opt)
        inputs = bench.resnet_data(B, S, dev)
    else:
        train_fn = step = bench.make_train_fn(model, opt)
        rng = np.random.default_rng(0)
        ids_np = rng.integers(0, cfg.vocab_size, (B, S))
        inputs = (torch.from_numpy(ids_np).to(dev),
                  torch.from_numpy(np.roll(ids_np, -1, axis=1)).to(dev))
    if args.graphed:
        import paddle_tpu_torch as paddle

        step = jit.StaticFunction(train_fn, observe=[model, opt],
                                  warmup=False)
        if args.model not in ("bert", "resnet50"):
            inputs = tuple(paddle.to_tensor(t.cpu().numpy(), place=dev)
                           for t in inputs)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        step(*inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step(*inputs)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    eager_seq = None
    if args.graphed:
        with torch.profiler.profile(activities=acts) as ref:
            train_fn(*inputs)
            torch.cuda.synchronize()
        eager_seq = _eager_sequence(ref.events())
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(*inputs)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    # the record_function ranges also show on the device timeline (as
    # annotations spanning their kernels): leave them out of the sums
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in _ANNOTATIONS]
    rows = sorted(((e.key, e.device_time_total / 1e3 / args.steps,
                    e.count / args.steps) for e in kernels),
                  key=lambda r: -r[1])
    kernel_ms = sum(ms for _k, ms, _c in rows)
    busy_ms, idle = device_busy(prof.events(), profiled_ms,
                                _ANNOTATIONS)
    groups = defaultdict(float)
    group_launches = defaultdict(float)
    by_kernel = defaultdict(float)
    extra = {}
    if args.graphed:
        groups, group_launches, per, unaligned, by_kernel = _graphed_groups(
            prof.events(), eager_seq, args.steps)
        extra = {"graph_kernels_per_step": per,
                 "eager_kernels_per_step": len(eager_seq),
                 "unaligned_per_step": unaligned,
                 "compile_counts": step.compile_counts(),
                 "capture_s": sum(step.capture_seconds().values())}
    seqs = _forward_ranges(prof.events()) if not args.graphed else {}
    for evt in prof.events() if not args.graphed else ():
        if evt.device_type != torch.autograd.DeviceType.CPU or not evt.kernels:
            continue
        ranges = _ranges(evt, seqs)
        for k in evt.kernels:
            g = _group(k.name, ranges)
            groups[g] += k.duration / 1e3 / args.steps
            group_launches[g] += 1 / args.steps
            by_kernel[g, k.name] += k.duration / 1e3 / args.steps
    print(json.dumps({
        "device": bench.card_label(dev),
        "config": bench.config_name(args.model, cfg, B, S),
        "step": "cuda_graph" if args.graphed else "eager", **extra,
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
        "groups_top_kernels": _group_tops(by_kernel),
        "top": [{"kernel": k[:100], "ms_per_step": ms, "per_step": c,
                 "share_of_kernel_ms": ms / kernel_ms}
                for k, ms, c in rows[:15]],
    }))


if __name__ == "__main__":
    main()
