"""Fused linear + softmax cross entropy over vocab chunks.

Counterpart of ``paddle_tpu/ops/fused_loss.py``: the mean cross entropy
of ``softmax(hidden @ weight.T)`` against ``labels`` without ever holding
the ``[N, V]`` logits. The vocab is walked in chunks of ``chunk`` rows of
``weight`` with an online logsumexp (running max m, running sum l, the
label's logit); the backward walks the chunks again, rebuilding each
chunk's logits, and accumulates ``dh += (p - onehot) @ W_c`` while
emitting ``dW_c = (p - onehot)^T @ h``. All math is f32 whatever the
inputs' dtype; dh and dW come back in hidden's and weight's dtypes.

The JAX package zero-pads the last chunk to ``chunk`` rows and masks the
padded columns out; here the last chunk is the remainder itself, which
gives the same sums without the padded copy of ``weight``. The chunk
products are plain ``torch.matmul`` (no TPU kernel was behind them).
"""
from __future__ import annotations

import torch

__all__ = ["fused_linear_cross_entropy", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 8192


def _chunks(v: int, chunk: int):
    return [(base, min(base + chunk, v)) for base in range(0, v, chunk)]


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, chunk, ignore_index):
        with torch.profiler.record_function("fused_linear_cross_entropy"):
            n = hidden.shape[0]
            hid32 = hidden.float()
            valid = labels != ignore_index
            lab = torch.where(valid, labels, 0).to(torch.int64)
            m = torch.full((n,), float("-inf"), device=hidden.device)
            l = torch.zeros((n,), device=hidden.device)
            lab_logit = torch.zeros((n,), device=hidden.device)
            for base, end in _chunks(weight.shape[0], chunk):
                logits = hid32 @ weight[base:end].float().T  # [N, C]
                m_new = torch.maximum(m, logits.amax(dim=1))
                l = l * torch.exp(m - m_new) + torch.exp(
                    logits - m_new[:, None]).sum(dim=1)
                m = m_new
                idx = lab - base
                in_chunk = (idx >= 0) & (idx < end - base)
                picked = logits.gather(
                    1, idx.clamp(0, end - base - 1)[:, None])[:, 0]
                lab_logit = torch.where(in_chunk, picked, lab_logit)
            lse = m + torch.log(l)
            per_tok = torch.where(valid, lse - lab_logit, 0.0)
            denom = valid.float().sum().clamp_min(1.0)
            loss = per_tok.sum() / denom
        ctx.save_for_backward(hidden, weight, lab, valid, lse, denom)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, weight, lab, valid, lse, denom = ctx.saved_tensors
        with torch.profiler.record_function("fused_linear_cross_entropy"):
            hid32 = hidden.float()
            scale = (g / denom) * valid.float()  # [N]
            dh = torch.zeros_like(hid32)
            dw = torch.empty_like(weight)
            for base, end in _chunks(weight.shape[0], ctx.chunk):
                w32 = weight[base:end].float()
                d = torch.exp(hid32 @ w32.T - lse[:, None])  # softmax chunk
                idx = lab - base
                hit = (idx >= 0) & (idx < end - base)
                d.scatter_add_(1, idx.clamp(0, end - base - 1)[:, None],
                               -hit.float()[:, None])  # p - onehot
                d *= scale[:, None]
                dh += d @ w32
                dw[base:end] = (d.T @ hid32).to(weight.dtype)
        return dh.to(hidden.dtype), dw, None, None, None


def fused_linear_cross_entropy(hidden, weight, labels,
                               chunk: int = DEFAULT_CHUNK,
                               ignore_index: int = -100):
    """Mean CE of ``softmax(hidden @ weight.T)`` vs ``labels`` over the
    labels that are not ``ignore_index`` (count at least 1). ``hidden``
    ``[N, H]``, ``weight`` ``[V, H]`` (any float dtypes), ``labels``
    ``[N]`` int. Differentiable in hidden and weight."""
    return _FusedLinearCE.apply(hidden, weight, labels, int(chunk),
                                int(ignore_index))
