"""The deterministic embedding backward: the CUDA kernel's wrapper and
its plain version.

``nn.functional.embedding`` takes its weight's gradient from here while
``FLAGS_cudnn_deterministic`` is True (the default): the ids are sorted
stably and ``csrc/embedding_grad.cu`` sums each distinct row's output
gradients in the ids' order, one block a row, in f32, rounded once to
the gradient's dtype; rows no id names are zero. PyTorch's own backward
accumulates with atomics on the card, so two backwards of one state
could differ in their last bits; this one gives the same bits every
time. It replaces no Pallas kernel (the JAX package's gradient is XLA's
scatter-add).

Dispatch is on the tensors' device: CPU tensors take the plain version
(:func:`ref_embedding_grad`, an in-order ``index_add_`` into f32, the
same sum in the same order), CUDA tensors launch the kernel or raise.
``kernel_launches`` and ``plain_calls`` count the two paths; a call
recorded into a CUDA graph counts in ``captured_launches`` instead, and
the graph's replays in ``replayed_launches`` (:func:`count_replays`, as
for K1-K4).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["embedding_grad", "ref_embedding_grad", "reset_counters",
           "count_replays", "launches"]

# eager launches, calls recorded into a CUDA graph, launches made by
# replaying such graphs, and plain-version calls
kernel_launches = 0
captured_launches = 0
replayed_launches = 0
plain_calls = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_counters() -> None:
    global kernel_launches, captured_launches, replayed_launches, plain_calls
    kernel_launches = captured_launches = replayed_launches = 0
    plain_calls = 0


def count_replays(n: int) -> None:
    """Record the launches one CUDA-graph replay makes: the ``n`` calls
    its capture recorded."""
    global replayed_launches
    replayed_launches += int(n)


def launches() -> int:
    """The kernel's launches on the card so far: eager and replayed."""
    return kernel_launches + replayed_launches


def ref_embedding_grad(ids: torch.Tensor, grad: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Plain version: ``[num_rows, H]`` in ``grad``'s dtype, each row the
    f32 sum, in the ids' order, of the rows of ``grad`` ``[N, H]`` whose
    id ``ids`` ``[N]`` names it."""
    out = torch.zeros(num_rows, grad.shape[-1], dtype=torch.float32,
                      device=grad.device)
    out.index_add_(0, ids.reshape(-1).to(torch.int64), grad.float())
    return out.to(grad.dtype)


def _lib():
    fn = _build.load("embedding_grad").embedding_grad_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _embedding_grad_cuda(ids, grad, num_rows):
    global kernel_launches, captured_launches
    if grad.dtype not in _DTYPES:
        raise ValueError(f"embedding_grad kernel: dtype {grad.dtype} "
                         "(f32, bf16 or f16)")
    if grad.dim() != 2 or ids.numel() != grad.shape[0]:
        raise ValueError(f"embedding_grad kernel: ids {tuple(ids.shape)} "
                         f"and grad {tuple(grad.shape)} do not pair")
    g = grad.contiguous()
    sorted_ids, order = torch.sort(ids.reshape(-1).to(torch.int64),
                                   stable=True)
    out = torch.zeros(num_rows, g.shape[1], dtype=g.dtype, device=g.device)
    fn = _lib()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(sorted_ids.data_ptr(), order.data_ptr(), g.data_ptr(),
                out.data_ptr(), sorted_ids.numel(), g.shape[1],
                _DTYPES[g.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"embedding_grad kernel launch failed: cudaError_t {rc}")
    if torch.cuda.is_current_stream_capturing():
        captured_launches += 1
    else:
        kernel_launches += 1
    return out


def embedding_grad(ids: torch.Tensor, grad: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """The weight gradient ``[num_rows, H]`` of an embedding lookup of
    ``ids`` ``[N]`` whose output gradient is ``grad`` ``[N, H]`` (module
    docstring)."""
    global plain_calls
    if grad.device.type == "cpu":
        plain_calls += 1
        return ref_embedding_grad(ids, grad, num_rows)
    if grad.device.type != "cuda":
        raise RuntimeError(f"embedding_grad: no path for device {grad.device}")
    return _embedding_grad_cuda(ids, grad, num_rows)


class DeterministicEmbedding(torch.autograd.Function):
    """``weight[ids]`` whose weight gradient is :func:`embedding_grad`."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.num_rows = weight.shape[0]
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return None, embedding_grad(ids, g.reshape(-1, g.shape[-1]),
                                    ctx.num_rows)
