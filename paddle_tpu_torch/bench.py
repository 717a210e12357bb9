"""Training throughput on the card: GPT-3 1.3B, Llama-0.76B, BERT-base and
ResNet-50.

    python -m paddle_tpu_torch.bench                  # gpt13 on cuda
    python -m paddle_tpu_torch.bench --model llama
    python -m paddle_tpu_torch.bench --model bert
    python -m paddle_tpu_torch.bench --model resnet50
    python -m paddle_tpu_torch.bench --eager          # the eager step
    python -m paddle_tpu_torch.bench --recompute [--recompute-policy dots]
    python -m paddle_tpu_torch.bench --small --device cpu [--model llama]

Counterpart of the root ``bench.py``'s ``bench_gpt13``, ``bench_llama``,
``bench_bert``, ``bench_resnet50`` and ``_time_steps``. By default the
step runs as the root bench runs it (``bench.py:300``, ``:791``):
``jit.StaticFunction(train_fn, observe=[model, opt], warmup=False)``
over ids and labels from
``paddle.to_tensor``, which on the card captures it as one CUDA graph
and replays it (the first call runs eagerly, the second captures; on
the CPU every call runs eagerly). ``--eager`` runs ``train_fn`` itself
on torch tensors, for the A/B. Each model takes its bench's
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
- ``bert``: BERT-base (``bert_base``: vocab 30522, hidden 768, 12 layers,
  12 heads of 64, intermediate 3072, dropout 0.1 on the hidden states
  and the attention probabilities), B 32, S 128, the MLM loss on the 15%
  of positions not labelled -100 plus the NSP loss,
  ``amp.decorate(level="O2", dtype="bfloat16")`` with master weights. A
  Paddle ``Layer`` model (``models/bert.py``) whose step takes facade
  tensors (``--eager`` too). ``--small``: ``bert_tiny``, B 4, S 128, 5
  steps.
- ``resnet50``: ``vision.models.resnet50(num_classes=1000)`` (25.6 M
  parameters), B 64 images of 3 x 224 x 224 and labels in [0, 1000),
  both from numpy seed 0, ``Momentum(learning_rate=0.1, momentum=0.9)``,
  ``amp.decorate(level="O2", dtype="bfloat16")`` with master weights,
  ``F.cross_entropy`` under ``auto_cast`` O2 (``bench.py:496-537``); a
  Paddle ``Layer`` model whose step takes facade tensors. ``--small``:
  ``resnet18``, B 2, 64 x 64, 3 steps.

``--recompute``/``--no-recompute`` and ``--recompute-policy`` (``full``,
``dots``, ``dots_no_batch``, ...; ``distributed/fleet/recompute.py``)
set the GPT's or Llama's ``recompute`` and ``recompute_policy``, as the
root bench's ``BENCH_RECOMPUTE``/``BENCH_RC_POLICY`` do (``bench.py:364-366``).

The language models train with ``AdamW(learning_rate=1e-4)``; all run
the step ``loss.backward(); opt.step(); opt.clear_grad()`` under
``amp.auto_cast(level="O2")``, from ``generator.seed(0)`` and inputs
from numpy seed 0.

Timing as there: one first step (``compile_s``: here the kernels' build
and the libraries' warm-up), two warm steps (the first of them captures
the graph: ``capture_s``), then 3 blocks of 10 steps (3 small), each
block ending in one device synchronisation; the best block sets
``step_ms``. Prints one JSON line: tokens/s (ResNet: images/s), step
ms, achieved TFLOP/s, MFU against the H100's dense bf16 peak of 989
TFLOP/s, the last loss, peak memory, ``graphed``, ``capture_s`` and the
step's ``compile_counts``, and the card's name and power limit. A
language model's FLOPs are 6 x params x tokens; ResNet's are counted by
``torch.utils.flop_counter.FlopCounterMode`` over the first (eager)
step, forward and backward, 2 per multiply-add (``flops_source``; the
root bench takes XLA's ``cost_analysis``, and its fallback of 12.3e9 an
image counts ResNet-50's ~4.1 G multiply-adds a forward as FLOPs, x3).
The counter sees the convolutions and products only, not the
elementwise work. ``cudnn.benchmark`` stays off: the algorithm search
would run inside a capture.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import amp, generator, jit
from .device import default_device, resolve_device
from .device import using_device
from .models import (BertConfig, BertForPretraining, GPTConfig,
                     GPTForCausalLM, LlamaConfig, LlamaForCausalLM,
                     bert_base, bert_tiny, llama_tiny)
from .optimizer import AdamW, Momentum

__all__ = ["gpt13_setup", "llama_setup", "bert_setup", "bert_data",
           "make_bert_train_fn", "SETUPS", "MASTER_WEIGHT", "build",
           "make_train_fn", "time_steps", "config_name", "train_run",
           "bench_model", "bench_gpt13", "bench_llama", "card_label",
           "facade_step", "resnet_setup", "make_resnet_train_fn",
           "resnet_data", "H100_BF16_PEAK_TFLOPS"]

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


def bert_setup(small: bool):
    """``(config, batch, seq, steps)`` of ``bench_bert`` at its
    defaults."""
    S = 128
    if small:
        return bert_tiny(max_position_embeddings=max(S, 128)), 4, S, 5
    return bert_base(max_position_embeddings=max(S, 512)), 32, S, 10


def resnet_setup(small: bool):
    """``(model name, batch, image side, steps)`` of ``bench_resnet50``
    at its defaults."""
    if small:
        return "resnet18", 2, 64, 3
    return "resnet50", 64, 224, 10


SETUPS = {"gpt13": gpt13_setup, "llama": llama_setup, "bert": bert_setup,
          "resnet50": resnet_setup}
# each bench's decorate: gpt13 without master weights, the others with
MASTER_WEIGHT = {"gpt13": False, "llama": None, "bert": None,
                 "resnet50": None}


def build(cfg, device, master_weight: Optional[bool] = False):
    """The bench's model and optimizer, decorated for O2 bf16, from
    ``generator.seed(0)``. ``master_weight=None`` turns master weights on,
    as ``amp.decorate`` does by default."""
    generator.seed(0)
    if isinstance(cfg, str):  # a vision model by name
        from . import vision

        with using_device(device):
            model = getattr(vision.models, cfg)(num_classes=1000)
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters())
        return amp.decorate(model, opt, level="O2", dtype="bfloat16",
                            master_weight=master_weight)
    if isinstance(cfg, BertConfig):
        with using_device(device):
            model = BertForPretraining(cfg)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        return amp.decorate(model, opt, level="O2", dtype="bfloat16",
                            master_weight=master_weight)
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


def make_bert_train_fn(model, opt) -> Callable:
    """``bench_bert``'s ``train_fn`` (``bench.py:450``), with an optional
    ``attention_mask`` ([B, S] of 1/0)."""
    def train_fn(ids, mlm_labels, nsp_labels, attention_mask=None):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            _, loss = model(ids, attention_mask=attention_mask,
                            masked_lm_labels=mlm_labels,
                            next_sentence_labels=nsp_labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return train_fn


def make_resnet_train_fn(model, opt) -> Callable:
    """``bench_resnet50``'s ``train_fn`` (``bench.py:517``)."""
    from .nn import functional as F

    def train_fn(images, labels):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(images)
            loss = F.cross_entropy(logits, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return train_fn


def resnet_data(B: int, H: int, device):
    """``bench_resnet50``'s images and labels from numpy seed 0, as facade
    tensors on ``device``."""
    import paddle_tpu_torch as paddle

    rng = np.random.default_rng(0)
    images = rng.standard_normal((B, 3, H, H)).astype("float32")
    labels = rng.integers(0, 1000, (B,))
    return (paddle.to_tensor(images, place=device),
            paddle.to_tensor(labels, place=device))


def bert_data(cfg, B: int, S: int, device):
    """``bench_bert``'s inputs from numpy seed 0, as facade tensors on
    ``device``: ids, MLM labels (-100 but on the 15% of positions drawn
    masked) and NSP labels."""
    import paddle_tpu_torch as paddle

    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    mlm = ids.copy()
    mlm[rng.random((B, S)) > 0.15] = -100
    nsp = rng.integers(0, 2, (B,))
    return tuple(paddle.to_tensor(a, place=device) for a in (ids, mlm, nsp))


def facade_step(cfg, B: int, S: int):
    """The bench's step as the root ``bench.py`` writes it, against this
    package's Paddle namespace: ``paddle.to_tensor`` ids and labels in, a
    facade loss out, on the default device. Returns ``(train_fn, (ids,
    labels), model, opt)``: :func:`build`'s model and optimizer (gpt13's
    decorate) and :func:`bench_model`'s ids."""
    import paddle_tpu_torch as paddle

    model, opt = build(cfg, default_device(), False)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    args = (paddle.to_tensor(ids), paddle.to_tensor(np.roll(ids, -1, 1)))
    return make_train_fn(model, opt), args, model, opt


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(step: Callable, args, steps: int, reps: int,
               device: torch.device, flops: Optional[dict] = None):
    """``(best seconds per step, first step's seconds, every step's
    loss)``: one first step, two warm steps, ``reps`` blocks of ``steps``
    back-to-back steps with one synchronisation at each block's end.
    Given a ``flops`` dict, the first step runs under ``FlopCounterMode``
    and ``flops["total"]`` is its count."""
    losses: List[torch.Tensor] = []
    t0 = time.perf_counter()
    if flops is None:
        losses.append(step(*args).detach())
    else:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            losses.append(step(*args).detach())
        flops["total"] = counter.get_total_flops()
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
    if model == "resnet50":
        return f"{cfg}-b{B}-{S}x{S}-bf16"
    head = f"-h{cfg.hidden_size}-l{cfg.num_layers}-b{B}-s{S}-bf16"
    if model == "bert":
        return "bert" + head
    rc = ""
    if cfg.recompute:
        rc = "-rc" + (f":{cfg.recompute_policy}" if cfg.recompute_policy
                      else "")
    if model == "gpt13":
        return "gpt13" + head + rc + "-fce-nomaster"
    return "llama" + head + rc + ("-fce" if cfg.fused_loss else "")


def train_run(model: str = "gpt13", small: bool = False, device=None,
              steps: Optional[int] = None, reps: int = 3,
              eager: bool = False, recompute: Optional[bool] = None,
              recompute_policy: Optional[str] = None):
    """Run the bench of ``model`` (``gpt13``, ``llama``, ``bert`` or
    ``resnet50``): ``(record, model, optimizer)``, the record with
    ``losses`` (every step's, in order) and ``steps_run``. ``eager`` runs
    ``train_fn`` itself (on torch tensors; BERT's and ResNet's on facade
    tensors); else the root bench's ``StaticFunction`` step on
    ``paddle.to_tensor`` inputs. ``recompute`` (when not None) and
    ``recompute_policy`` (when given) set the GPT's or Llama's config
    fields of those names."""
    import paddle_tpu_torch as paddle

    device = resolve_device(device)
    cfg, B, S, default_steps = SETUPS[model](small)
    if recompute is not None or recompute_policy is not None:
        if model not in ("gpt13", "llama"):
            raise ValueError(f"--recompute is a GPT or Llama setting, not "
                             f"{model}'s")
        cfg = dataclasses.replace(
            cfg, recompute=cfg.recompute if recompute is None else recompute,
            recompute_policy=recompute_policy or cfg.recompute_policy)
    steps = default_steps if steps is None else int(steps)
    model_, opt = build(cfg, device, MASTER_WEIGHT[model])
    flops = {} if model == "resnet50" else None
    if model in ("bert", "resnet50"):
        if model == "bert":
            train_fn = make_bert_train_fn(model_, opt)
            args = bert_data(cfg, B, S, device)
        else:
            train_fn = make_resnet_train_fn(model_, opt)
            args = resnet_data(B, S, device)
        step = train_fn if eager else jit.StaticFunction(
            train_fn, observe=[model_, opt], warmup=False)
    else:
        rng = np.random.default_rng(0)
        ids_np = rng.integers(0, cfg.vocab_size, (B, S))
        labels_np = np.roll(ids_np, -1, axis=1)
        train_fn = step = make_train_fn(model_, opt)
        if eager:
            args = (torch.from_numpy(ids_np).to(device),
                    torch.from_numpy(labels_np).to(device))
        else:
            step = jit.StaticFunction(train_fn, observe=[model_, opt],
                                      warmup=False)
            args = (paddle.to_tensor(ids_np, place=device),
                    paddle.to_tensor(labels_np, place=device))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dt, first_s, losses = time_steps(step, args, steps, reps, device, flops)
    n_params = sum(p.numel() for p in model_.parameters())
    if flops is None:
        metric, unit, rate = f"{model}_tokens_per_sec_per_chip", "tokens/s", \
            B * S / dt
        achieved = 6 * n_params * rate / 1e12
        extra = {}
    else:
        metric, unit, rate = f"{cfg}_images_per_sec_per_chip", "imgs/s", \
            B / dt
        achieved = flops["total"] / dt / 1e12
        extra = {"flops_per_step": flops["total"],
                 "flops_source": "torch.utils.flop_counter.FlopCounterMode "
                                 "over the first (eager) step, 2 per "
                                 "multiply-add"}
    capture = None if eager else step.capture_seconds()
    record = {
        "metric": metric,
        "value": round(rate, 1),
        "unit": unit,
        "vs_baseline": 1.0,
        "config": config_name(model, cfg, B, S),
        "params_m": round(n_params / 1e6, 1),
        "loss": losses[-1],
        "step_ms": round(1000 * dt, 1),
        "compile_s": round(first_s, 1),
        "achieved_tflops_per_s": round(achieved, 2),
        **extra,
        "mfu": (round(achieved / H100_BF16_PEAK_TFLOPS, 4)
                if device.type == "cuda" else None),
        "peak_memory_gib": (round(torch.cuda.max_memory_allocated(device)
                                  / 2**30, 2)
                            if device.type == "cuda" else None),
        "graphed": not eager and device.type == "cuda",
        "capture_s": (round(sum(capture.values()), 3) if capture
                      else None),
        "compile_counts": None if eager else step.compile_counts(),
        "device": card_label(device),
    }
    return dict(record, losses=losses, steps_run=len(losses)), model_, opt


def bench_model(model: str = "gpt13", small: bool = False, device=None,
                steps: Optional[int] = None, reps: int = 3,
                eager: bool = False, recompute: Optional[bool] = None,
                recompute_policy: Optional[str] = None) -> dict:
    """:func:`train_run`'s record."""
    return train_run(model, small, device, steps, reps, eager, recompute,
                     recompute_policy)[0]


def bench_gpt13(small: bool = False, device=None,
                steps: Optional[int] = None, reps: int = 3,
                eager: bool = False) -> dict:
    return bench_model("gpt13", small, device, steps, reps, eager)


def bench_llama(small: bool = False, device=None,
                steps: Optional[int] = None, reps: int = 3,
                eager: bool = False) -> dict:
    return bench_model("llama", small, device, steps, reps, eager)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(SETUPS), default="gpt13")
    ap.add_argument("--small", action="store_true",
                    help="the bench's small configuration")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--eager", action="store_true",
                    help="run train_fn eagerly, not through StaticFunction")
    ap.add_argument("--recompute", dest="recompute", action="store_const",
                    const=True, default=None,
                    help="recompute every block (gpt13, llama)")
    ap.add_argument("--no-recompute", dest="recompute",
                    action="store_const", const=False,
                    help="recompute no block (gpt13, llama)")
    ap.add_argument("--recompute-policy", default=None,
                    help="full, dots, dots_no_batch, ... (with recompute)")
    args = ap.parse_args(argv)
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
    rec = bench_model(args.model, args.small, args.device, eager=args.eager,
                      recompute=args.recompute,
                      recompute_policy=args.recompute_policy)
    rec.pop("losses")
    rec.pop("steps_run")
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
