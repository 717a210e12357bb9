"""Attention functionals (``paddle_tpu/nn/functional/attention.py``).

Inputs ``[batch, seq, heads, head_dim]``. With no mask, or a mask of the
key-padding form (bool ``[B, 1, 1, Sk]``, True = attend), attention runs
through flash attention (``ops/flash_attention.py``): its CUDA kernels
for CUDA tensors, at every length, and its plain version for CPU
tensors. The JAX package sends only TPU arrays at ``S >= 512`` to its
Pallas kernel; the length at which the H100 should switch is for a later
measurement to set. Any other mask takes :func:`_sdpa_ref`, the dense
version, as in the JAX package. ``FLAGS_use_pallas_flash_attention``
set False (``framework/flags.py``) sends every call to :func:`_sdpa_ref`
on every device, a switch the user sets; left True (the default), a CUDA
tensor's call launches the kernels or raises.

``flash_attn_unpadded`` is dense attention over packed sequences, each
token attending only within its own sequence, as the JAX package
computes it: no varlen kernel on either side.

The functionals take facade tensors (``paddle.Tensor``) as well as
torch tensors, and return what they were given (``tensor.facade_io``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...amp import cast_inputs
from ...generator import next_seed
from ...ops.flash_attention import NEG_INF, flash_attention_bshd, keep_mask
from ...tensor import facade_io

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded"]

# FLAGS_use_pallas_flash_attention (framework/flags.py)
pallas_flash_enabled = True


def _sdpa_ref(q, k, v, mask, dropout_p: float, causal: bool,
              scale: Optional[float], seed=None):
    """Dense attention in q's dtype, softmax in f32 (the JAX package's
    ``_sdpa_ref``). ``mask``: bool (True = attend) or additive, broadcast
    to ``[B, H, Sq, Sk]``. Dropout needs ``seed`` (a 0-d int32 tensor):
    its keep bits are the flash kernels' hash, so it drops what flash
    attention would drop with that seed."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * s
    # a fill, not a host copy: the function runs inside captured steps
    neg = torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device)
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((qlen, klen), dtype=torch.bool,
                        device=q.device).tril(klen - qlen)
        logits = torch.where(cm, logits, neg)
    if mask is not None:
        logits = (torch.where(mask, logits, neg) if mask.dtype == torch.bool
                  else logits + mask)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and seed is not None:
        B, H, sq, sk = probs.shape
        dev = probs.device
        keep = keep_mask(
            seed, torch.arange(B * H, dtype=torch.int32, device=dev).view(
                B, H, 1, 1),
            torch.arange(sq, dtype=torch.int32, device=dev).view(sq, 1),
            torch.arange(sk, dtype=torch.int32, device=dev), dropout_p)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            0.0).to(probs.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vh).transpose(1, 2)


def _as_key_padding(mask, batch: int, klen: int):
    """The bool ``[B, 1, 1, Sk]`` form as a ``[B, Sk]`` keep mask; any
    other mask gives None (a per-query or per-head mask is not key
    padding)."""
    if mask is None or mask.dtype != torch.bool:
        return None
    if tuple(mask.shape) == (batch, 1, 1, klen):
        return mask.reshape(batch, klen)
    return None


@facade_io
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None):
    """Attention over ``[B, S, H, D]`` inputs (module docstring).
    Dropout's seed is drawn from the global generator as a 0-d int32
    tensor on q's device (``generator.next_seed``): data that the kernels
    read, and that a captured step carries in its seed buffer."""
    drop = dropout_p if training else 0.0
    kpad = _as_key_padding(attn_mask, query.shape[0], key.shape[1])
    if pallas_flash_enabled and (attn_mask is None or kpad is not None):
        q, k, v = cast_inputs("flash_attention", query, key, value)
        return flash_attention_bshd(
            q, k, v, causal=is_causal, dropout_p=drop,
            dropout_seed=next_seed(q.device) if drop > 0.0 else 0,
            key_padding_mask=kpad)
    q, k, v, m = cast_inputs("scaled_dot_product_attention", query, key,
                             value, attn_mask)
    seed = next_seed(q.device) if drop > 0.0 else None
    return _sdpa_ref(q, k, v, m, drop, is_causal, None, seed)


@facade_io
def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    fixed_seed_offset=None, rng_name: str = "",
                    training: bool = True, name=None):
    """``paddle.nn.functional.flash_attention``: ``(out, None)``, as the
    JAX package returns it (no softmax is returned; ``fixed_seed_offset``
    and ``rng_name`` are taken and ignored: seeds come from the global
    generator)."""
    return scaled_dot_product_attention(query, key, value, None, dropout,
                                        causal, training), None


@facade_io
def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale: float = None,
                        dropout: float = 0.0, causal: bool = False,
                        return_softmax: bool = False, training: bool = True,
                        name=None):
    """Attention over packed ``[total, H, D]`` tokens, sequence ``i``
    spanning ``cu_seqlens_q[i]:cu_seqlens_q[i + 1]`` (the JAX package's
    segment-masked dense attention, ``attention.py:174``): scores
    outside a token's sequence, and with ``causal`` above the diagonal,
    are -1e30; softmax in f32. As there, ``cu_seqlens_k``, the maximum
    lengths and ``dropout`` are taken and ignored. Returns ``(out,
    None)``."""
    q, k, v = cast_inputs("flash_attn_unpadded", query, key, value)
    total, _, d = q.shape
    cu = torch.as_tensor(getattr(cu_seqlens_q, "_value", cu_seqlens_q),
                         device=q.device).to(torch.int64)
    starts = cu[1:-1]
    starts = starts[starts < total]
    seg = torch.zeros(total, dtype=torch.int32, device=q.device).index_add(
        0, starts, torch.ones_like(starts, dtype=torch.int32)).cumsum(0)
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("qhd,khd->hqk", q, k) * s
    same = seg[:, None] == seg[None, :]
    if causal:
        pos = torch.arange(total, device=q.device)
        same = same & (pos[:, None] >= pos[None, :])
    logits = torch.where(same[None], logits, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", probs, v), None
