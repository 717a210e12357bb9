"""One AdamW step over flat f32 vectors (K5): the CUDA kernel's wrapper and
its plain version.

Counterpart of ``paddle_tpu/ops/pallas/fused_adamw.py``:
:func:`fused_adamw_flat` launches ``csrc/fused_adamw.cu`` (the Pallas
``_adamw_kernel``) and :func:`ref_adamw_flat` is the plain version, the
counterpart of ``xla_adamw_flat``. Both compute, elementwise over ``w``,
``m``, ``v``, ``g`` of any length ``N``::

    m' = b1 m + (1 - b1) g;   v' = b2 v + (1 - b2) g g
    w' = w - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd w)

with ``bc1 = 1 - b1^t``, ``bc2 = 1 - b2^t`` computed in f32 on the
tensors' device (:func:`bias_corrections`), and every constant, ``1 - b``
included, an f32 value as the JAX package's ``jnp.float32`` constants
are. This is K5's own formula; the port's ``optimizer.AdamW`` runs
Paddle's (``lr sqrt(bc2) / bc1 m / (sqrt(v) + eps)``, decay applied
first), and neither the JAX package's optimizers nor the port's route
through K5: its path is the A/B tool ``tools/bench_adamw.py``.

The TPU kernel's ``block_rows`` knob and its pad to a multiple of 8 x
1024 elements are not carried over: the kernel takes any ``N``, its tail
included. ``lr``, ``bc1`` and ``bc2`` reach the kernel as 0-dim f32 device
tensors read through pointers (a Python number becomes one by a fill
kernel), so a step never synchronises with the host.

Dispatch is on the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. ``kernel_launches`` and
``plain_calls`` count the two paths.
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import numpy as np
import torch

from . import _build

__all__ = ["fused_adamw_flat", "ref_adamw_flat", "bias_corrections",
           "reset_counters"]

# plain-integer counts of the two paths (read and zeroed by chip_smoke.py)
kernel_launches = 0
plain_calls = 0

Scalar = Union[float, int, torch.Tensor]


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


def _f32(x: float) -> float:
    """``x`` rounded to f32 (held exactly in a Python float)."""
    return float(np.float32(x))


def _scalar(x: Scalar, device: torch.device) -> torch.Tensor:
    """``x`` as a 0-dim f32 tensor on ``device``: a fill kernel for a
    Python number (no host synchronisation)."""
    if isinstance(x, torch.Tensor):
        if x.numel() != 1:
            raise ValueError(f"expected a scalar, got shape {tuple(x.shape)}")
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def bias_corrections(step: Scalar, beta1: float, beta2: float,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(1 - b1^t, 1 - b2^t)`` as 0-dim f32 tensors on ``device``, the
    power taken in f32 (the JAX package's ``fused_adamw.py:107-109``)."""
    t = _scalar(step, device)
    one = torch.ones((), dtype=torch.float32, device=device)
    return (one - torch.pow(_scalar(beta1, device), t),
            one - torch.pow(_scalar(beta2, device), t))


def ref_adamw_flat(w, m, v, g, lr: Scalar, step: Scalar, *,
                   beta1: float = 0.9, beta2: float = 0.999,
                   eps: float = 1e-8, weight_decay: float = 0.01):
    """Plain version of K5 (``xla_adamw_flat``): ``(w', m', v')``, one
    torch operation per operation of the kernel, in its order, so that on
    the card the two agree bit for bit."""
    b1, b2 = _f32(beta1), _f32(beta2)
    one_m_b1 = _f32(np.float32(1.0) - np.float32(beta1))
    one_m_b2 = _f32(np.float32(1.0) - np.float32(beta2))
    lr_t = _scalar(lr, w.device)
    bc1, bc2 = bias_corrections(step, beta1, beta2, w.device)
    m_new = b1 * m + one_m_b1 * g
    v_new = b2 * v + one_m_b2 * g * g
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + _f32(eps))
    w_new = w - lr_t * (update + _f32(weight_decay) * w)
    return w_new, m_new, v_new


# ───────────────────────── CUDA kernel ─────────────────────────


def _lib():
    fn = _build.load("fused_adamw").fused_adamw_launch
    if fn.argtypes is None:
        p, f = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [p] * 10 + [ctypes.c_longlong, f, f, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_adamw kernel: {msg}")


def _fused_adamw_cuda(w, m, v, g, lr, step, beta1, beta2, eps, weight_decay):
    global kernel_launches
    tensors = (w, m, v, g)
    _check(all(t.device == w.device for t in tensors),
           "w, m, v and g must be on one device")
    _check(all(t.dtype == torch.float32 for t in tensors),
           f"dtypes {[t.dtype for t in tensors]} (f32 only)")
    _check(all(t.dim() == 1 and t.is_contiguous() for t in tensors),
           "w, m, v and g must be 1-D contiguous")
    _check(all(t.numel() == w.numel() for t in tensors),
           f"lengths {[t.numel() for t in tensors]} differ")
    outs = tuple(torch.empty_like(w) for _ in range(3))
    if w.numel() == 0:
        return outs
    lr_t = _scalar(lr, w.device)
    bc1, bc2 = bias_corrections(step, beta1, beta2, w.device)
    fn = _lib()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(w.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                lr_t.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
                w.numel(), beta1, beta2, eps, weight_decay, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_adamw kernel launch failed: cudaError_t {rc}")
    kernel_launches += 1
    return outs


# ───────────────────────── public op ─────────────────────────


def fused_adamw_flat(w, m, v, g, lr: Scalar, step: Scalar, *,
                     beta1: float = 0.9, beta2: float = 0.999,
                     eps: float = 1e-8, weight_decay: float = 0.01):
    """One AdamW step over flat f32 vectors ``w, m, v, g`` ``[N]``
    (module docstring); ``lr`` and ``step`` (1-based) are numbers or
    one-element tensors. Returns new ``(w', m', v')``. CPU tensors take
    :func:`ref_adamw_flat`; CUDA tensors launch the kernel, raising on a
    dtype, layout or launch it does not take."""
    global plain_calls
    if w.device.type == "cpu":
        plain_calls += 1
        return ref_adamw_flat(w, m, v, g, lr, step, beta1=beta1, beta2=beta2,
                              eps=eps, weight_decay=weight_decay)
    if w.device.type != "cuda":
        raise RuntimeError(f"fused_adamw_flat: no path for device {w.device}")
    return _fused_adamw_cuda(w, m, v, g, lr, step, beta1, beta2, eps,
                             weight_decay)
