"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions and the ``torch.autograd.Function`` that ties them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``. Layout at the
public functions, as there: ``[batch, seq, heads, head_dim]``. The three
kernels of ``csrc/flash_attention.cu``:

- ``flash_fwd``  (K1, ``_attn_kernel``): O and the logsumexp LSE;
- ``flash_dq``   (K2, ``_dq_kernel``):   dQ;
- ``flash_dkv``  (K3, ``_dkv_kernel``):  dK and dV;

with Delta = rowsum(dO * O) computed in torch between the forward and the
two backward kernels, as the JAX package computes it in XLA.

Masks: keys past the sequence, an optional key-padding keep mask ``[B,
Sk]`` (row ``b`` for every head of batch ``b``), causal aligned to the
bottom right (query ``i`` sees key ``j`` iff ``i + Sk - Sq >= j``). A row
with no key gives 0 and LSE about -1e30. After-softmax dropout draws its
keep bits from :func:`keep_mask`, a hash of the global ``(seed, b*H + h,
row, col)``, so the forward and both backward kernels (and the plain
versions) drop the same elements whatever their tiling; the softmax
denominator uses the undropped p.

bf16 rounding, as the Pallas kernels: scores and every sum are f32; the
forward rounds p (dropped and rescaled) to v's dtype before P.V, the
backward rounds dS to k's dtype and p to dO's dtype before the products
they feed. In f32 the roundings are identities.

Dispatch is on the tensors' device, never on what is installed: CPU
tensors take the plain versions (``ref_flash_fwd``, ``ref_flash_dq``,
``ref_flash_dkv``); CUDA tensors launch the kernels or raise. The
counters ``kernel_launches`` and ``plain_calls`` (by kernel name) count
the two paths.

The kernels read q/k/v/dO through their strides (the last dimension
must be contiguous), so GPT's q/k/v -- ``[B, S, H, D]`` views of one
``[B, S, 3H]`` projection -- go in without a copy. The bf16 kernels
(tensor cores, 16-byte asynchronous copies) also need each
bf16 input's data pointer and batch, sequence and head strides on 16-byte
boundaries; the wrapper refuses others with ``ValueError`` before any
launch. O, dQ, dK, dV are new contiguous ``[B, S, H, D]`` tensors, LSE and
Delta contiguous ``[B*H, Sq]`` f32.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention_bshd", "flash_fwd", "flash_dq", "flash_dkv",
           "flash_delta", "flash_bwd", "keep_mask",
           "ref_flash_fwd", "ref_flash_dq", "ref_flash_dkv",
           "FlashAttentionFunction", "reset_counters", "KERNELS", "NEG_INF"]

NEG_INF = -1e30
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
HEAD_DIMS = (32, 64, 128)

# plain-integer counts of the two paths, by kernel (read and zeroed by
# chip_smoke.py)
kernel_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
plain_calls: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_counters() -> None:
    for name in KERNELS:
        kernel_launches[name] = 0
        plain_calls[name] = 0


# ───────────────────────── dropout keep mask ─────────────────────────


def _i32(c: int) -> int:
    """``c`` as a signed 32-bit value (the hash constants are u32)."""
    return c - (1 << 32) if c >= 1 << 31 else c


def keep_mask(seed: int, bh, rows, cols, drop_p: float) -> torch.Tensor:
    """Dropout keep bits (True = keep) at global ``(bh, rows, cols)``:
    the JAX package's ``_keep_mask``, xorshift-multiply rounds in int32
    with wrap-around multiplies and arithmetic right shifts (torch's
    ``>>`` on int32 is arithmetic). ``bh``, ``rows`` and ``cols`` are
    int32 tensors that broadcast together; ``seed`` an int < 2^24."""
    x = ((rows * _i32(0x9E3779B9)) ^ (cols * _i32(0x85EBCA6B))
         ^ (bh * _i32(0x27D4EB2F) + int(seed)))
    x = x ^ (x >> 15)
    x = x * _i32(0x86143593)
    x = x ^ (x >> 13)
    x = x * _i32(0xC2B2AE35)
    x = x ^ (x >> 16)
    u = (x & 0xFFFFFF).to(torch.float32) / 16777216.0
    return u >= torch.tensor(drop_p, dtype=torch.float32)


# ───────────────────────── plain PyTorch versions ─────────────────────────


def _bh(x: torch.Tensor) -> torch.Tensor:
    """``[B, S, H, D]`` -> ``[B, H, S, D]`` f32."""
    return x.permute(0, 2, 1, 3).float()


def _mask(B, H, sq, sk, causal, kpad, device):
    """Valid-key mask broadcastable to ``[B, H, Sq, Sk]``."""
    ok = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=device)
    if causal:
        q_pos = torch.arange(sq, device=device)[:, None]
        k_pos = torch.arange(sk, device=device)[None, :]
        ok = ok & (q_pos + (sk - sq) >= k_pos)
    if kpad is not None:
        ok = ok & (kpad.float() > 0.5)[:, None, None, :]
    return ok


def _keep(B, H, sq, sk, seed, drop_p, device):
    bh = torch.arange(B * H, dtype=torch.int32, device=device).view(
        B, H, 1, 1)
    rows = torch.arange(sq, dtype=torch.int32, device=device).view(
        1, 1, sq, 1)
    cols = torch.arange(sk, dtype=torch.int32, device=device).view(
        1, 1, 1, sk)
    return keep_mask(seed, bh, rows, cols, drop_p)


def _inv_keep(drop_p: float) -> torch.Tensor:
    # 1 - p in double, then f32: jnp.float32(1.0 - drop_p)
    return torch.tensor(1.0 - drop_p, dtype=torch.float32)


def ref_flash_fwd(q, k, v, causal: bool, scale: float, dropout_p: float = 0.0,
                  dropout_seed: int = 0, key_padding_mask=None):
    """Plain version of K1: ``(O [B, Sq, H, D] in q's dtype, LSE [B*H, Sq]
    f32)``. Materialises the ``[B, H, Sq, Sk]`` scores in f32."""
    B, sq, H, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", _bh(q), _bh(k)) * scale
    ok = _mask(B, H, sq, sk, causal, key_padding_mask, q.device)
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout_p > 0.0:
        keep = _keep(B, H, sq, sk, dropout_seed, dropout_p, q.device)
        p = torch.where(keep, p, 0.0) / _inv_keep(dropout_p).to(q.device)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), _bh(v))
    o = (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m + torch.log(l)).reshape(B * H, sq)
    return o, lse


def _bwd_probs(q, k, v, do, lse, delta, causal, scale, dropout_p,
               dropout_seed, key_padding_mask):
    """p (undropped), p_eff (dropped, rescaled) and dS, ``[B, H, Sq, Sk]``
    f32, recomputed from (q, k, LSE) as both backward kernels do."""
    B, sq, H, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", _bh(q), _bh(k)) * scale
    ok = _mask(B, H, sq, sk, causal, key_padding_mask, q.device)
    p = torch.where(ok, torch.exp(s - lse.view(B, H, sq, 1)), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", _bh(do), _bh(v))
    p_eff = p
    if dropout_p > 0.0:
        keep = _keep(B, H, sq, sk, dropout_seed, dropout_p, q.device)
        inv = _inv_keep(dropout_p).to(q.device)
        dp = torch.where(keep, dp, 0.0) / inv
        p_eff = torch.where(keep, p, 0.0) / inv
    ds = p * (dp - delta.view(B, H, sq, 1))
    return p_eff, ds


def ref_flash_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 dropout_p: float = 0.0, dropout_seed: int = 0,
                 key_padding_mask=None):
    """Plain version of K2: dQ ``[B, Sq, H, D]`` in q's dtype."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale, dropout_p,
                       dropout_seed, key_padding_mask)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), _bh(k))
    return (dq * scale).to(q.dtype).permute(0, 2, 1, 3).contiguous()


def ref_flash_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  dropout_p: float = 0.0, dropout_seed: int = 0,
                  key_padding_mask=None):
    """Plain version of K3: ``(dK, dV)``, each ``[B, Sk, H, D]`` in k's
    and v's dtype."""
    p_eff, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale,
                           dropout_p, dropout_seed, key_padding_mask)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_eff.to(do.dtype).float(), _bh(do))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), _bh(q))
    return ((dk * scale).to(k.dtype).permute(0, 2, 1, 3).contiguous(),
            dv.to(v.dtype).permute(0, 2, 1, 3).contiguous())


# ───────────────────────── CUDA kernels ─────────────────────────


def _fn(name: str, n_ptrs: int):
    fn = getattr(_build.load("flash_attention"), f"{name}_launch")
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # pointers, strides (int64[12]), B, H, Sq, Sk, D, scale, causal,
        # drop_p, inv_keep, seed, dtype, stream
        fn.argtypes = ([p] * n_ptrs + [p] + [i] * 5 + [f, i, f, f, i, i]
                       + [p])
        fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check_inputs(q, k, v, kpad, extra=()):
    B, sq, H, D = q.shape
    sk = k.shape[1]
    tensors = [q, k, v, *extra] + ([kpad] if kpad is not None else [])
    _check(all(t.device == q.device for t in tensors),
           "every tensor must be on q's device")
    _check(q.dtype in _DTYPE_CODES, f"dtype {q.dtype} (f32 or bf16)")
    _check(all(t.dtype == q.dtype for t in (k, v, *extra)),
           "q, k, v (and dO) must share one dtype")
    _check(D in HEAD_DIMS, f"head_dim {D} (one of {HEAD_DIMS})")
    _check(q.dim() == 4 and tuple(k.shape) == (B, sk, H, D)
           and tuple(v.shape) == (B, sk, H, D),
           "q [B, Sq, H, D], k and v [B, Sk, H, D]")
    _check(sq >= 1 and sk >= 1, "empty sequence")
    _check(all(t.stride(-1) == 1 for t in (q, k, v, *extra)),
           "the head dimension must be contiguous (stride 1)")
    if q.dtype == torch.bfloat16:
        _check(all(_aligned16(t) for t in (q, k, v, *extra)),
               "bf16 q, k, v (and dO) need a 16-byte aligned data pointer "
               "and batch, sequence and head strides on 16-byte boundaries")
    if kpad is not None:
        _check(kpad.dtype == torch.float32 and tuple(kpad.shape) == (B, sk)
               and kpad.is_contiguous(), "key padding mask f32 [B, Sk]")


def _aligned16(t: torch.Tensor) -> bool:
    """The bf16 kernels' cp.async copies move 16 bytes: ``t``'s data
    pointer and its batch, sequence and head strides must be multiples of
    16 bytes."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:3]))


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(name, fn, ptrs, strides, q, sk, causal, scale, dropout_p, seed):
    B, sq, H, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, ctypes.cast(strides, ctypes.c_void_p), B, H, sq, sk,
                D, float(scale), int(causal), float(dropout_p),
                float(_inv_keep(dropout_p)), int(seed),
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    kernel_launches[name] += 1


def _fwd_cuda(q, k, v, causal, scale, dropout_p, seed, kpad):
    _check_inputs(q, k, v, kpad)
    B, sq, H, D = q.shape
    o = torch.empty((B, sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", _fn("flash_fwd", 6),
            [q.data_ptr(), k.data_ptr(), v.data_ptr(),
             kpad.data_ptr() if kpad is not None else None,
             o.data_ptr(), lse.data_ptr()],
            _strides(q, k, v, o), q, k.shape[1], causal, scale, dropout_p,
            seed)
    return o, lse


def _bwd_check(q, k, v, do, lse, delta, kpad):
    _check_inputs(q, k, v, kpad, extra=(do,))
    B, sq, H, _ = q.shape
    _check(tuple(do.shape) == tuple(q.shape), "dO has q's shape")
    for t in (lse, delta):
        _check(t.dtype == torch.float32 and tuple(t.shape) == (B * H, sq)
               and t.is_contiguous(), "LSE and Delta f32 [B*H, Sq]")
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            kpad.data_ptr() if kpad is not None else None]


def _dq_cuda(q, k, v, do, lse, delta, causal, scale, dropout_p, seed, kpad):
    ptrs = _bwd_check(q, k, v, do, lse, delta, kpad)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_dq", _fn("flash_dq", 8), ptrs + [dq.data_ptr()],
            _strides(q, k, v, do), q, k.shape[1], causal, scale, dropout_p,
            seed)
    return dq


def _dkv_cuda(q, k, v, do, lse, delta, causal, scale, dropout_p, seed,
              kpad):
    ptrs = _bwd_check(q, k, v, do, lse, delta, kpad)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("flash_dkv", _fn("flash_dkv", 9),
            ptrs + [dk.data_ptr(), dv.data_ptr()], _strides(q, k, v, do), q,
            k.shape[1], causal, scale, dropout_p, seed)
    return dk, dv


# ───────────────────────── dispatch ─────────────────────────


def _on(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no path for device {t.device}")
    return t.device.type


def flash_fwd(q, k, v, causal: bool = False, scale: Optional[float] = None,
              dropout_p: float = 0.0, dropout_seed: int = 0,
              key_padding_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, LSE)`` of attention over ``[B, S, H, D]`` inputs (module
    docstring). CPU tensors take the plain version, CUDA tensors K1."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    kpad = _kpad(key_padding_mask)
    if _on(q, "flash_fwd") == "cpu":
        plain_calls["flash_fwd"] += 1
        return ref_flash_fwd(q, k, v, causal, scale, dropout_p, dropout_seed,
                             kpad)
    return _fwd_cuda(q, k, v, causal, scale, dropout_p, dropout_seed, kpad)


def flash_dq(q, k, v, do, lse, delta, causal: bool = False,
             scale: Optional[float] = None, dropout_p: float = 0.0,
             dropout_seed: int = 0, key_padding_mask=None) -> torch.Tensor:
    """dQ from the forward's inputs, its LSE, dO and Delta = rowsum(dO *
    O) (f32 ``[B*H, Sq]``). CPU tensors take the plain version, CUDA
    tensors K2."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    args = (q, k, v, do, lse, delta, causal, scale, dropout_p, dropout_seed,
            _kpad(key_padding_mask))
    if _on(q, "flash_dq") == "cpu":
        plain_calls["flash_dq"] += 1
        return ref_flash_dq(*args)
    return _dq_cuda(*args)


def flash_dkv(q, k, v, do, lse, delta, causal: bool = False,
              scale: Optional[float] = None, dropout_p: float = 0.0,
              dropout_seed: int = 0, key_padding_mask=None):
    """``(dK, dV)``, as :func:`flash_dq`; CUDA tensors launch K3."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    args = (q, k, v, do, lse, delta, causal, scale, dropout_p, dropout_seed,
            _kpad(key_padding_mask))
    if _on(q, "flash_dkv") == "cpu":
        plain_calls["flash_dkv"] += 1
        return ref_flash_dkv(*args)
    return _dkv_cuda(*args)


def flash_delta(o, do) -> torch.Tensor:
    """Delta = rowsum(dO * O) in f32, ``[B*H, Sq]`` contiguous."""
    B, sq, H, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        B * H, sq).contiguous()


def flash_bwd(q, k, v, o, lse, do, causal: bool = False,
              scale: Optional[float] = None, dropout_p: float = 0.0,
              dropout_seed: int = 0, key_padding_mask=None):
    """``(dQ, dK, dV)`` from the forward's inputs, O, LSE and dO: Delta
    in torch, then K2 and K3 (their plain versions for CPU tensors)."""
    delta = flash_delta(o, do)
    kw = dict(causal=causal, scale=scale, dropout_p=dropout_p,
              dropout_seed=dropout_seed, key_padding_mask=key_padding_mask)
    dq = flash_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_dkv(q, k, v, do, lse, delta, **kw))


def _kpad(mask):
    """Key-padding keep mask as f32 0/1 ``[B, Sk]`` (bool or 0/1 in)."""
    if mask is None:
        return None
    return mask.to(torch.float32).contiguous()


class FlashAttentionFunction(torch.autograd.Function):
    """O = flash attention of (q, k, v); the backward runs K2 and K3 from
    the saved (q, k, v, O, LSE). Replaces the JAX package's two
    ``custom_vjp``s (with and without key padding): the seed and the mask
    get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, dropout_seed,
                key_padding_mask):
        o, lse = flash_fwd(q, k, v, causal, scale, dropout_p, dropout_seed,
                           key_padding_mask)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kpad = key_padding_mask
        ctx.args = (causal, scale, dropout_p, dropout_seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, dropout_p, seed = ctx.args
        if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                                  and not _aligned16(do)):
            do = do.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal, scale, dropout_p,
                               seed, ctx.kpad)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bshd(q, k, v, causal: bool = False,
                         scale: Optional[float] = None,
                         dropout_p: float = 0.0, dropout_seed: int = 0,
                         key_padding_mask=None) -> torch.Tensor:
    """Flash attention, layout ``[B, S, H, D]``, differentiable in q, k,
    v. ``dropout_p``: after-softmax dropout inside the kernels, its keep
    bits a hash of ``(dropout_seed, b*H + h, row, col)`` (an int <
    2^24). ``key_padding_mask``: ``[B, Sk]`` bool or 0/1, True = attend.
    For O and LSE without autograd, :func:`flash_fwd`."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return FlashAttentionFunction.apply(q, k, v, bool(causal), scale,
                                        float(dropout_p), int(dropout_seed),
                                        key_padding_mask)
