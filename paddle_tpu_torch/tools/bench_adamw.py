"""A/B of the fused AdamW kernel (K5) against PyTorch's fused AdamW, on
the card.

    python -m paddle_tpu_torch.tools.bench_adamw

Counterpart of the root ``tools/bench_adamw.py``, with PyTorch's
``torch.optim.AdamW(fused=True)`` in the place of the XLA form. It runs
on the card only (it raises without one) and writes no file.

1. Check, at 2,000,000 elements from ``numpy.random.default_rng(0)`` (w
   standard normal, m = v = 0, g = 1e-3 x normal, lr 1e-4, step 10):
   ``ops.fused_adamw.fused_adamw_flat`` against the library call on the
   same inputs, one flat parameter whose state makes this its step 10.
   The library rounds otherwise (it decays w before the Adam term and
   divides sqrt(v) by sqrt(bc2)), so w', m' and v' are held elementwise
   at rtol 1e-6, atol 1e-7 (the JAX tool's tolerance between its kernel
   and its XLA form), and the update w - w' by its norm within
   ``UPDATE_REL_TOL``: one f32 ulp of w' is ~0.2% of a 1e-4 update, and
   the two round w' apart in some elements.
2. Time, at N = 354,942,976 (355 M aligned down to 256 x 1024, the
   JAX tool's ``n_params``): K5 chained 20 times (each call's w', m', v'
   the next call's w, m, v), 3 repetitions, with CUDA events; then the
   library call 20 x 3 on the same buffers. The best repetition's mean
   sets each time.
3. Print one JSON line, ``metric`` ``fused_adamw_ab``: ``n_params``,
   ``kernel_ms``, ``kernel_gbps``, ``library_ms``, ``library_gbps``
   (28 N bytes moved: w, m, v, g read, w, m, v written), ``bound_ms``
   (those bytes over 3.35 TB/s), ``kernel_wins_library``, the check's
   errors and ``device`` (the card's name and power limit).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Tuple

import numpy as np
import torch

from .. import bench
from ..device import resolve_device
from ..ops import fused_adamw as k5

__all__ = ["library_adamw", "check", "time_ab", "bench_adamw", "N_TIMED",
           "UPDATE_REL_TOL"]

# 355 M aligned down to 256 x 1024, as the JAX tool aligns its n_params
N_TIMED = 355_000_000 - 355_000_000 % (256 * 1024)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BYTES_PER_ELEMENT = 28     # 4 f32 reads + 3 f32 writes
UPDATE_REL_TOL = 5e-3
LR, STEP = 1e-4, 10


def library_adamw(w, m, v, g, lr: float,
                  step: int) -> Tuple[torch.optim.Optimizer, torch.Tensor]:
    """PyTorch's fused AdamW (K5's defaults: betas 0.9, 0.999, eps 1e-8,
    weight decay 0.01) over one flat parameter that aliases ``w``, its
    moments ``m`` and ``v`` (updated in place by ``opt.step()``) and its
    step count set so that the next ``step()`` is step ``step``. Returns
    ``(optimizer, parameter)``."""
    p = torch.nn.Parameter(w)
    p.grad = g
    opt = torch.optim.AdamW([p], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01, fused=True)
    opt.state[p] = {"step": torch.tensor(float(step - 1), device=w.device),
                    "exp_avg": m, "exp_avg_sq": v}
    return opt, p


def _inputs(n: int, device):
    """The JAX tool's check inputs (``tools/bench_adamw.py:69-78``): w
    standard normal, m = v = 0, g = 1e-3 x standard normal, drawn in f64
    from ``numpy.random.default_rng(0)`` and rounded to f32."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32) * np.float32(1e-3)
    w, g = (torch.from_numpy(a).to(device) for a in (w, g))
    return w, torch.zeros_like(w), torch.zeros_like(w), g


def _device_inputs(n: int, device):
    """The same distributions at the timed size, drawn on the card from
    a seeded generator (a host draw of 355 M normals would take longer
    than the timing)."""
    gen = torch.Generator(device=device).manual_seed(0)
    w = torch.randn(n, generator=gen, device=device)
    g = torch.randn(n, generator=gen, device=device) * 1e-3
    return w, torch.zeros_like(w), torch.zeros_like(w), g


def check(device, n: int = 2_000_000) -> Dict[str, float]:
    """K5 against the library call (module docstring, 1); raises on a
    disagreement. Returns the max abs errors of w', m', v' and the
    norm-relative error of the update."""
    w, m, v, g = _inputs(n, device)
    got = k5.fused_adamw_flat(w, m, v, g, LR, STEP)
    opt, p = library_adamw(w.clone(), m.clone(), v.clone(), g, LR, STEP)
    opt.step()
    want = (p.detach(), opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])
    out = {}
    for name, a, b in zip(("w", "m", "v"), got, want):
        err = (a - b).abs()
        out[f"{name}_max_abs_err"] = float(err.max())
        if not bool((err <= 1e-7 + 1e-6 * b.abs()).all()):
            raise AssertionError(f"K5 {name}' disagrees with the library "
                                 f"(max abs err {float(err.max()):.3e})")
    du_k, du_l = w - got[0], w - want[0]
    rel = float(torch.linalg.vector_norm(du_k - du_l)
                / torch.linalg.vector_norm(du_l))
    out["update_rel_err"] = rel
    if rel > UPDATE_REL_TOL:
        raise AssertionError(f"K5's update is {rel:.3e} of its norm from "
                             f"the library's (tolerance {UPDATE_REL_TOL})")
    return out


def _best_ms(fn, iters: int, reps: int) -> float:
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def time_ab(device, n: int, iters: int = 20, reps: int = 3
            ) -> Dict[str, float]:
    """``{"kernel_ms", "library_ms"}`` at ``n`` elements (module
    docstring, 2)."""
    w, m, v, g = _device_inputs(n, device)
    state = [w, m, v]

    def kernel():
        state[:] = k5.fused_adamw_flat(*state, g, LR, STEP)

    kernel()  # warm: the build and the first launch
    kernel_ms = _best_ms(kernel, iters, reps)
    opt, _p = library_adamw(*state, g, LR, STEP)
    del state[:], w, m, v
    opt.step()
    library_ms = _best_ms(opt.step, iters, reps)
    return {"kernel_ms": kernel_ms, "library_ms": library_ms}


def bench_adamw(device=None) -> dict:
    """Check, time and return the record (module docstring)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_adamw times the card: it needs a CUDA "
                           f"device, got {device}")
    n = N_TIMED
    errs = check(device)
    t = time_ab(device, n)
    nbytes = BYTES_PER_ELEMENT * n
    return {
        "metric": "fused_adamw_ab", "n_params": n,
        "kernel_ms": t["kernel_ms"],
        "kernel_gbps": nbytes / t["kernel_ms"] / 1e6,
        "library_ms": t["library_ms"],
        "library_gbps": nbytes / t["library_ms"] / 1e6,
        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
        "kernel_wins_library": t["kernel_ms"] < t["library_ms"],
        "check": errs,
        "device": bench.card_label(device),
    }


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    print(json.dumps(bench_adamw()), flush=True)


if __name__ == "__main__":
    main()
