"""Per-request sampling keys: threefry2x32 and the Gumbel-max draw in torch.

The serving determinism contract (``serving/engine.py`` of the JAX
package, ``_sample_key``): the token following position ``p`` of a
request is drawn with the key ``fold_in(PRNGKey(seed), p)`` by
``jax.random.categorical``. A stream is then a pure function of
(prompt, seed, temperature), independent of batch composition, chunk
boundaries and engine history. This module reproduces those keys bit
for bit and the same Gumbel-max draw, so a port stream equals the
reference stream at ``temperature > 0`` too.

What is reproduced (``jax_default_prng_impl=threefry2x32``,
``jax_threefry_partitionable=True``):

- ``PRNGKey(seed)`` of an int32 seed is the word pair ``(0, seed mod
  2**32)``: the high word is the int32 shifted right by 32, which XLA
  defines as 0.
- ``fold_in(key, data)`` hashes the counter pair ``(0, data)`` under
  ``key``; the two output words are the new key.
- ``random_bits(key, 32, (n,))`` hashes the counter pairs ``(0, i)`` for
  ``i < n`` and xors the two output words.
- ``uniform`` keeps the top 23 bits as the mantissa of a float in
  [1, 2), subtracts 1, and clamps below at ``minval``; ``gumbel`` (the
  default "low" mode) is ``-log(-log(uniform(tiny, 1)))``.

Words are held in int64 tensors masked to 32 bits: torch has no uint32
arithmetic on every device, and int64 holds every intermediate sum.
"""
from __future__ import annotations

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits",
           "gumbel", "categorical", "sample"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds), elementwise over broadcast
    int64 tensors holding uint32 words. Returns the two output words."""
    k0 = k0 & _MASK
    k1 = k1 & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of int32 seeds: ``[..., 2]`` int64 words."""
    seed = torch.as_tensor(seed).to(torch.int64)
    return torch.stack([torch.zeros_like(seed), seed & _MASK], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: ``key`` ``[..., 2]``, ``data`` ``[...]``
    (taken modulo 2**32, as JAX casts it to uint32)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per entry, ``[..., n]`` int64, for keys ``[..., 2]``
    (the partitionable ``threefry_random_bits``)."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(count), count)
    return y0 ^ y1


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` for keys ``[..., 2]``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(floats + _F32_TINY, _F32_TINY)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of Gumbel noise plus f32 logits (first index on ties, as in
    ``jnp.argmax``)."""
    noise = gumbel(key, logits.shape[-1])
    return torch.argmax(noise + logits.to(torch.float32), dim=-1)


def sample(logits: torch.Tensor, temps, seeds, positions) -> torch.Tensor:
    """The engine's per-row draw, at a fixed shape: greedy ``argmax``
    where the temperature is 0, else ``categorical(fold_in(PRNGKey(seed),
    position), logits / max(t, 1e-6))``. ``logits`` ``[R, V]`` f32;
    ``temps``, ``seeds`` and ``positions`` are ``[R]`` tensors on the
    logits' device (or anything ``torch.as_tensor`` takes). Every row's
    noise is drawn and ``where(t > 0, sampled, greedy)`` selects, as the
    JAX engine's traced step does, so the draw reads nothing on the host
    and can be captured in a CUDA graph. Returns ``[R]`` int64."""
    dev = logits.device
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    keys = fold_in(prng_key(torch.as_tensor(seeds, device=dev)),
                   torch.as_tensor(positions, device=dev))
    t = torch.clamp_min(temps, 1e-6)
    sampled = categorical(keys, logits / t[:, None])
    return torch.where(temps > 0, sampled, torch.argmax(logits, dim=-1))
