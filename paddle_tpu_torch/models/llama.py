"""Llama: RoPE, RMSNorm, SwiGLU and grouped-query attention.

Counterpart of ``paddle_tpu/models/llama.py``: the dense forward with its
loss (``LlamaForCausalLM.forward(input_ids, labels=...)``), each layer
optionally under ``recompute``, with flash attention (``nn.functional.
flash_attention``, the CUDA kernels K1-K3) and the fused chunked cross
entropy; and the paged forward (``forward_paged``) that the serving
engine's ragged step runs, with the paged-attention kernel K4. Module
and parameter names match the JAX package, so its ``state_dict`` loads
here key for key (``models/convert.py``).

Every op goes through the port's layers and functionals, and so through
the amp cast rule under the JAX package's op names (``amp.py``):
``rms_norm`` (black list), ``linear``, ``llama_rope_gqa``,
``flash_attention``, ``merge_heads``, ``silu``, ``multiply``, ``add``,
``fused_linear_cross_entropy``, ``tied_lm_head``, ``recompute``. The
dtypes follow the JAX package's:

- dense forward under O2: RMSNorm computes in f32 (on its f32 weight)
  and gives f32; RoPE's f32 tables are cast to the activations' dtype,
  so RoPE runs in bf16; everything else not on the black list runs in
  bf16;
- paged step (no ``auto_cast``): a bf16 input over an f32 norm weight
  gives f32, a linear with an f32 input over bf16 weights computes in f32
  (``nn.functional.linear``), RoPE's f32 tables keep q and k f32, k and v
  are rounded to the page dtype as they are written, and K4 takes the f32
  q over the pages and gives f32. So from the first layer on a bf16
  model's residual stream is f32, as in the JAX package;
- a model built with ``dtype=torch.bfloat16`` keeps its norm weights in
  f32, as ``amp.decorate(level="O2")`` does.

Differences from the JAX package, by design of the port:

- Linear weights are ``[out, in]`` (``torch.nn.Linear``); the JAX package
  stores ``[in, out]``. So ``lm_head.weight`` is already the ``[V, H]``
  the fused cross entropy takes, where the JAX package transposes.
- The KV pools (and an int8 pool's scales) are updated in place by
  ``forward_paged``; the JAX version returns new pools.
- Parameters are drawn from an explicit ``torch.Generator`` on the target
  device (Normal(0, 0.02); output projections std 0.02 / sqrt(2 * layers);
  norms 1), never from the global RNG.

The paged forward takes ``adapters=`` (``serving/adapters.py``
``AdapterRows``): every projection site of every layer adds its LoRA
delta (q/k/v before RoPE, o on the merged attention output, gate/up/down
in the MLP), which is exactly zero on the rows of slot 0.

Not ported yet: the KV-cache forward (``cache=``, behind ``generate()``),
sequence parallelism (``sequence_parallel=True`` raises) and tensor
parallelism.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .. import amp
from ..device import resolve_device
from ..distributed.fleet.recompute import recompute
from ..nn import Embedding, Linear, RMSNorm
from ..nn import functional as F
from ..ops.fused_loss import fused_linear_cross_entropy
from ..ops.paged_attention import ragged_paged_attention
from ..quantization.observers import quantize_kv

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
    # kept for the JAX config's sake: both of its routes are one path here
    # (nn.functional.scaled_dot_product_attention sends an unmasked call to
    # flash attention)
    use_flash_attention: bool = True
    sequence_parallel: bool = False
    tie_word_embeddings: bool = False
    recompute: bool = False
    # recompute policy: None/'full' recompute everything; the JAX
    # package's named policies raise (distributed/fleet/recompute.py)
    recompute_policy: Optional[str] = None
    # fused chunked linear + CE (ops/fused_loss.py): forward(labels=...)
    # then returns (None, loss), never forming the [B*S, V] logits
    fused_loss: bool = False

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
        if self.sequence_parallel:
            raise NotImplementedError(
                "sequence_parallel (ring attention over a 'sep' mesh axis) "
                "is not ported yet")


def llama_tiny(**kw) -> LlamaConfig:
    cfg = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               num_key_value_heads=2, max_position_embeddings=128)
    cfg.update(kw)
    return LlamaConfig(**cfg)


# ------------------------------------------------------------------ RoPE


def _rope_rows(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin ``[T, 1, dim/2]`` f32 at each row's position: the rows of
    the JAX package's ``_rope_tables`` (the same f32 products), computed
    for the given positions only."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=positions.device) / dim))
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    return torch.cos(freqs)[:, None, :], torch.sin(freqs)[:, None, :]


def _apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate the (even, odd) pairs of ``t`` (last dim) by tables that
    broadcast against its pairs; the result takes the promoted dtype."""
    t1, t2 = t[..., 0::2], t[..., 1::2]
    return torch.stack([t1 * cos - t2 * sin, t1 * sin + t2 * cos],
                       dim=-1).reshape(t.shape)


def _add(a, b):
    a, b = amp.cast_inputs("add", a, b)
    return a + b


def _mul(a, b):
    a, b = amp.cast_inputs("multiply", a, b)
    return a * b


# ------------------------------------------------------------- layers


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.cfg = config
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // config.num_heads
        self.q_proj = Linear(h, self.num_heads * self.head_dim, bias=False)
        self.k_proj = Linear(h, self.num_kv_heads * self.head_dim, bias=False)
        self.v_proj = Linear(h, self.num_kv_heads * self.head_dim, bias=False)
        self.o_proj = Linear(self.num_heads * self.head_dim, h, bias=False)

    def forward(self, x):
        """Causal self-attention over ``x`` ``[B, S, H]``: q/k/v shaped to
        ``[B, S, heads, D]``, RoPE at positions 0..S-1 with the f32 tables
        cast to the activations' dtype (``llama_rope_gqa``), kv heads
        repeated per query group, then flash attention."""
        B, S, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q, k, v = amp.cast_inputs("llama_rope_gqa", self.q_proj(x),
                                  self.k_proj(x), self.v_proj(x))
        cos, sin = _rope_rows(torch.arange(S, device=x.device), hd,
                              self.cfg.rope_theta)
        cos, sin = cos[None].to(q.dtype), sin[None].to(q.dtype)
        q = _apply_rope(q.view(B, S, nh, hd), cos, sin)
        k = _apply_rope(k.view(B, S, nkv, hd), cos, sin)
        v = v.view(B, S, nkv, hd)
        if nh != nkv:  # GQA: repeat kv heads per query group
            k = k.repeat_interleave(nh // nkv, dim=2)
            v = v.repeat_interleave(nh // nkv, dim=2)
        ctx, _ = F.flash_attention(q, k, v, causal=True)
        (ctx,) = amp.cast_inputs("merge_heads", ctx)
        return self.o_proj(ctx.reshape(B, S, nh * hd))

    def forward_paged(self, x, positions, block_tables, k_pool, v_pool,
                      rope, attention=ragged_paged_attention, k_scale=None,
                      v_scale=None, adapters=None, layer_idx=0):
        """Paged-KV ragged step: one query token per row of ``x`` ``[T, H]``
        at ``positions`` ``[T]`` (int32), each with its owner's block table
        ``[T, pages]`` (int32). Writes every row's rope'd k/v into its page
        slot (in place, rounded to the page dtype), then runs
        ``attention`` for each row over its pages masked at its own
        position, which makes a chunk's rows causal over their freshly
        written chunk-mates (and a draft row over its burst-mates).
        Padding rows carry the null table and position 0, so their writes
        land on page 0. ``rope`` is ``(cos, sin)`` from ``_rope_rows``:
        f32, so q and k are f32 from here on, and so is the attention
        output. With ``k_scale``/``v_scale`` (int8 pages, both or neither)
        each row's k and v are quantized per slot (``quantize_kv``) and
        the codes and scales written; attention dequantizes in the
        kernel. Every write is an ``index_put_`` at int64 indices, so the
        step can be captured in a CUDA graph. ``adapters`` (an
        ``AdapterRows``) adds the q/k/v deltas of layer ``layer_idx``
        before RoPE and the o delta on the merged attention output.
        Returns ``[T, H]``."""
        T = x.shape[0]
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        cos, sin = rope
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if adapters is not None:
            q, k, v = adapters.apply_group(("q_proj", "k_proj", "v_proj"),
                                           layer_idx, x, (q, k, v))
        q = _apply_rope(q.view(T, nh, hd), cos, sin)
        k = _apply_rope(k.view(T, nkv, hd), cos, sin)
        v = v.view(T, nkv, hd)
        page_size = k_pool.shape[1]
        pos = positions.to(torch.int64)
        rows = torch.arange(T, device=x.device)
        page_ids = block_tables[rows, pos // page_size].to(torch.int64)
        offs = pos % page_size
        if k_scale is not None:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            k_scale[page_ids, offs] = ks
            v_scale[page_ids, offs] = vs
        k_pool[page_ids, offs] = k.to(k_pool.dtype)
        v_pool[page_ids, offs] = v.to(v_pool.dtype)
        ctx = attention(q.contiguous(), k_pool, v_pool, block_tables,
                        positions + 1, scale=1.0 / math.sqrt(hd),
                        k_scale=k_scale, v_scale=v_scale)
        merged = ctx.reshape(T, nh * hd)
        out = self.o_proj(merged)
        if adapters is not None:
            out = adapters.apply("o_proj", layer_idx, merged, out)
        return out


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, ff = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, ff, bias=False)
        self.up_proj = Linear(h, ff, bias=False)
        self.down_proj = Linear(ff, h, bias=False)

    def forward(self, x, adapters=None, layer_idx=0):
        """``adapters`` (an ``AdapterRows``, paged step only) adds the
        gate/up/down deltas of layer ``layer_idx``."""
        if adapters is None:
            return self.down_proj(_mul(F.silu(self.gate_proj(x)),
                                       self.up_proj(x)))
        g, u = adapters.apply_group(("gate_proj", "up_proj"), layer_idx, x,
                                    (self.gate_proj(x), self.up_proj(x)))
        a = _mul(F.silu(g), u)
        return adapters.apply("down_proj", layer_idx, a, self.down_proj(a))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, epsilon=eps)
        self.self_attn = LlamaAttention(config)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                epsilon=eps)
        self.mlp = LlamaMLP(config)

    def forward(self, x):
        x = _add(x, self.self_attn(self.input_layernorm(x)))
        return _add(x, self.mlp(self.post_attention_layernorm(x)))

    def forward_paged(self, x, positions, block_tables, k_pool, v_pool, rope,
                      attention=ragged_paged_attention, k_scale=None,
                      v_scale=None, adapters=None, layer_idx=0):
        x = _add(x, self.self_attn.forward_paged(
            self.input_layernorm(x), positions, block_tables, k_pool, v_pool,
            rope, attention=attention, k_scale=k_scale, v_scale=v_scale,
            adapters=adapters, layer_idx=layer_idx))
        return _add(x, self.mlp(self.post_attention_layernorm(x),
                                adapters=adapters, layer_idx=layer_idx))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config)
                                     for _ in range(config.num_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps)

    def forward(self, input_ids):
        """Dense trunk: ``input_ids`` ``[B, S]`` -> the final-norm hidden
        states ``[B, S, H]``; each layer under ``recompute`` when
        ``config.recompute``."""
        cfg = self.config
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = (recompute(layer, x, policy=cfg.recompute_policy)
                 if cfg.recompute else layer(x))
        return self.norm(x)

    def forward_paged(self, input_ids, positions, block_tables,
                      caches: Sequence[Tuple[torch.Tensor, ...]],
                      attention=ragged_paged_attention, adapters=None):
        """Paged trunk of the serving step: ``input_ids`` ``[T]``,
        ``positions`` ``[T]`` int32, ``block_tables`` ``[T, pages]`` int32,
        ``caches`` a per-layer list of ``(k_pool, v_pool)``, or ``(k_pool,
        v_pool, k_scale, v_scale)`` for int8 pages, written in place;
        ``adapters`` an ``AdapterRows`` (each row's LoRA slot) or None.
        Returns the final-norm hidden states ``[T, H]``."""
        cfg = self.config
        rope = _rope_rows(positions, cfg.hidden_size // cfg.num_heads,
                          cfg.rope_theta)
        x = self.embed_tokens(input_ids.to(torch.int64))
        for li, (layer, (kp, vp, *scales)) in enumerate(
                zip(self.layers, caches)):
            ks, vs = scales or (None, None)
            x = layer.forward_paged(x, positions, block_tables, kp, vp, rope,
                                    attention=attention, k_scale=ks,
                                    v_scale=vs, adapters=adapters,
                                    layer_idx=li)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama with its vocab head. Built on ``device`` (default ``cuda``;
    ``RuntimeError`` without a card unless ``device="cpu"``), parameters
    drawn in f32 from ``torch.Generator(device).manual_seed(seed)``. With
    ``dtype`` bf16 or fp16 they are then cast by ``amp.decorate(level=
    "O2")``'s rule: every parameter but the norms' (which stay f32)."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.llama = LlamaModel(config)
            self.lm_head = (None if config.tie_word_embeddings
                            else Linear(config.hidden_size, config.vocab_size,
                                        bias=False))
        self.to_empty(device=device)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))
        if dtype in (torch.bfloat16, torch.float16):
            amp.decorate(self, level="O2", dtype=dtype)
        elif dtype != torch.float32:
            raise ValueError(f"dtype {dtype}: float32, bfloat16 or float16")

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
        h, w = amp.cast_inputs("tied_lm_head", hidden,
                               self.llama.embed_tokens.weight)
        dt = torch.promote_types(h.dtype, w.dtype)
        return h.to(dt) @ w.to(dt).T

    def forward(self, input_ids, labels=None):
        """Logits ``[B, S, V]`` without ``labels``; with them ``(logits,
        mean loss)``, or ``(None, loss)`` when ``config.fused_loss``."""
        hidden = self.llama(input_ids)
        if labels is not None and self.config.fused_loss:
            w = (self.lm_head.weight if self.lm_head is not None
                 else self.llama.embed_tokens.weight)
            h, w = amp.cast_inputs("fused_linear_cross_entropy", hidden, w)
            return None, fused_linear_cross_entropy(
                h.reshape(-1, self.config.hidden_size), w, labels.reshape(-1))
        logits = self.logits(hidden)
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1))
        return logits, loss

    def _decode_trunk(self):
        return self.llama

    def _cache_spec(self):
        cfg = self.config
        # pre-repeat kv heads: GQA's memory saving applies to the cache too
        return (cfg.num_layers, cfg.num_key_value_heads,
                cfg.hidden_size // cfg.num_heads)

    def lora_sites(self):
        """The ``AdapterStore`` contract: ordered ``(site, in_dim,
        out_dim)`` triples for every projection the paged trunk offers a
        LoRA delta at, and the layer count."""
        cfg = self.config
        hd = cfg.hidden_size // cfg.num_heads
        h = cfg.hidden_size
        q_out = cfg.num_heads * hd
        kv_out = cfg.num_key_value_heads * hd
        ff = cfg.intermediate_size
        sites = [("q_proj", h, q_out), ("k_proj", h, kv_out),
                 ("v_proj", h, kv_out), ("o_proj", q_out, h),
                 ("gate_proj", h, ff), ("up_proj", h, ff),
                 ("down_proj", ff, h)]
        return sites, cfg.num_layers

    def lora_site_groups(self):
        """The sites of :meth:`lora_sites` that read one input: the
        attention's q, k and v, and the MLP's gate and up."""
        return (("q_proj", "k_proj", "v_proj"), ("gate_proj", "up_proj"))
