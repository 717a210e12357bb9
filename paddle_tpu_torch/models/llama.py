"""Llama for serving: RoPE, RMSNorm, SwiGLU and grouped-query attention.

Counterpart of ``paddle_tpu/models/llama.py``, serving half: the paged
forward (``forward_paged``) that the serving engine's ragged step runs.
Module and parameter names match the JAX package, so its ``state_dict``
loads here key for key (``models/convert.py``).

Differences from the JAX package, by design of the port:

- Linear weights are ``[out, in]`` (``torch.nn.Linear``); the JAX package
  stores ``[in, out]``.
- The KV pools are updated in place by ``forward_paged``; the JAX version
  returns new pools.
- Parameters are drawn from an explicit ``torch.Generator`` on the target
  device (Normal(0, 0.02); output projections std 0.02 / sqrt(2 * layers);
  norms 1), never from the global RNG.

The dense ``forward`` (training, and the flash-attention kernel behind
it) belongs to a later slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.paged_attention import ragged_paged_attention

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 22
    num_heads: int = 16
    num_key_value_heads: Optional[int] = None  # None: MHA; < heads: GQA
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.intermediate_size is None:
            # llama convention: 8/3 * h rounded up to a multiple of 256
            self.intermediate_size = ((int(8 * self.hidden_size / 3) + 255)
                                      // 256) * 256
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_heads
        if self.hidden_size % self.num_heads:
            raise ValueError("num_heads must divide hidden_size")
        if self.num_heads % self.num_key_value_heads:
            raise ValueError("num_key_value_heads must divide num_heads")


def llama_tiny(**kw) -> LlamaConfig:
    cfg = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               num_key_value_heads=2, max_position_embeddings=128)
    cfg.update(kw)
    return LlamaConfig(**cfg)


# ------------------------------------------------------------------ RoPE


def _rope_rows(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin ``[T, 1, dim/2]`` f32 at each row's position: the rows of
    the JAX package's ``_rope_tables`` (the same f32 products), computed
    for the step's positions only."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=positions.device) / dim))
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    return torch.cos(freqs)[:, None, :], torch.sin(freqs)[:, None, :]


def _apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate the (even, odd) pairs of ``t`` ``[T, heads, dim]``; the
    result is f32, as the f32 tables promote it."""
    t1, t2 = t[..., 0::2], t[..., 1::2]
    return torch.stack([t1 * cos - t2 * sin, t1 * sin + t2 * cos],
                       dim=-1).reshape(t.shape)


# ------------------------------------------------------------- layers


class RMSNorm(nn.Module):
    """``a * (1 / sqrt(mean(a.f32 ** 2) + eps)).to(a.dtype) * w``, the JAX
    package's formula (``nn/layer/norm.py`` RMSNorm)."""

    def __init__(self, hidden_size: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.eps = eps

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        var = a.to(torch.float32).pow(2).mean(dim=-1, keepdim=True)
        return a * (1.0 / torch.sqrt(var + self.eps)).to(a.dtype) * self.weight


def _linear(n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.cfg = config
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // config.num_heads
        self.q_proj = _linear(h, self.num_heads * self.head_dim)
        self.k_proj = _linear(h, self.num_kv_heads * self.head_dim)
        self.v_proj = _linear(h, self.num_kv_heads * self.head_dim)
        self.o_proj = _linear(self.num_heads * self.head_dim, h)

    def forward_paged(self, x, positions, block_tables, k_pool, v_pool,
                      rope, attention=ragged_paged_attention):
        """Paged-KV ragged step: one query token per row of ``x`` ``[T, H]``
        at ``positions`` ``[T]`` (int32), each with its owner's block table
        ``[T, pages]`` (int32). Writes every row's rope'd k/v into its page
        slot (in place), then runs ``attention`` for each row over its
        pages masked at its own position, which makes a chunk's rows
        causal over their freshly written chunk-mates. Padding rows carry
        the null table and position 0, so their writes land on page 0.
        ``rope`` is ``(cos, sin)`` from ``_rope_rows``. Returns
        ``[T, H]``."""
        T = x.shape[0]
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        cos, sin = rope
        q = _apply_rope(self.q_proj(x).view(T, nh, hd), cos, sin)
        k = _apply_rope(self.k_proj(x).view(T, nkv, hd), cos, sin)
        v = self.v_proj(x).view(T, nkv, hd)
        page_size = k_pool.shape[1]
        pos = positions.to(torch.int64)
        rows = torch.arange(T, device=x.device)
        page_ids = block_tables[rows, pos // page_size].to(torch.int64)
        offs = pos % page_size
        k_pool[page_ids, offs] = k.to(k_pool.dtype)
        v_pool[page_ids, offs] = v.to(v_pool.dtype)
        ctx = attention(q.to(x.dtype).contiguous(), k_pool, v_pool,
                        block_tables, positions + 1,
                        scale=1.0 / math.sqrt(hd))
        return self.o_proj(ctx.reshape(T, nh * hd).to(x.dtype))


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, ff = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, ff)
        self.up_proj = _linear(h, ff)
        self.down_proj = _linear(ff, h)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.self_attn = LlamaAttention(config)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps)
        self.mlp = LlamaMLP(config)

    def forward_paged(self, x, positions, block_tables, k_pool, v_pool, rope,
                      attention=ragged_paged_attention):
        x = x + self.self_attn.forward_paged(
            self.input_layernorm(x), positions, block_tables, k_pool, v_pool,
            rope, attention=attention)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config)
                                     for _ in range(config.num_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def forward_paged(self, input_ids, positions, block_tables,
                      caches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      attention=ragged_paged_attention):
        """Paged trunk of the serving step: ``input_ids`` ``[T]``,
        ``positions`` ``[T]`` int32, ``block_tables`` ``[T, pages]`` int32,
        ``caches`` a per-layer list of ``(k_pool, v_pool)``, written in
        place. Returns the final-norm hidden states ``[T, H]``."""
        cfg = self.config
        rope = _rope_rows(positions, cfg.hidden_size // cfg.num_heads,
                          cfg.rope_theta)
        x = self.embed_tokens(input_ids.to(torch.int64))
        for layer, (kp, vp) in zip(self.layers, caches):
            x = layer.forward_paged(x, positions, block_tables, kp, vp, rope,
                                    attention=attention)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama with its vocab head. Built on ``device`` (default ``cuda``;
    ``RuntimeError`` without a card unless ``device="cpu"``) in ``dtype``,
    parameters drawn in f32 from ``torch.Generator(device).manual_seed(
    seed)`` and then cast."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.llama = LlamaModel(config)
            self.lm_head = (None if config.tie_word_embeddings
                            else _linear(config.hidden_size,
                                         config.vocab_size))
        self.to_empty(device=device)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))
        self.to(dtype)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        cfg = self.config
        std = cfg.initializer_range
        proj_std = std / math.sqrt(2 * cfg.num_layers)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(("o_proj.weight", "down_proj.weight")):
                p.normal_(0.0, proj_std, generator=gen)
            else:
                p.normal_(0.0, std, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    def logits(self, hidden):
        if self.lm_head is not None:
            return self.lm_head(hidden)
        return hidden @ self.llama.embed_tokens.weight.T

    def _decode_trunk(self):
        return self.llama

    def _cache_spec(self):
        cfg = self.config
        # pre-repeat kv heads: GQA's memory saving applies to the cache too
        return (cfg.num_layers, cfg.num_key_value_heads,
                cfg.hidden_size // cfg.num_heads)
