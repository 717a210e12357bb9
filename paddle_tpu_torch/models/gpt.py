"""GPT for training: pre-LN decoder blocks, flash attention, tied head.

Counterpart of ``paddle_tpu/models/gpt.py``, training half: the dense
forward with its loss (``GPTForCausalLM.forward(input_ids, labels=...)``),
the unfused cross entropy and the fused chunked linear-cross-entropy
branch. Module and parameter names match the JAX package
(``gpt.layers.0.attn.qkv_proj.weight``, ...), so its ``state_dict`` loads
here key for key (``models/convert.py``).

Every op goes through the port's layers and functionals, and so through
the amp cast rule under the JAX package's op names (``amp.py``); the
residual and embedding adds cast as its ``add``. Attention is
``nn.functional.flash_attention`` on q/k/v that are ``[B, S, H, D]``
strided views of the fused QKV projection (no copy).

Differences from the JAX package, by design of the port: Linear weights
are ``[out, in]``; parameters are drawn from an explicit
``torch.Generator`` on the target device (Normal(0, 0.02) for
projections and embeddings, ``0.02 / sqrt(2 * layers)`` for ``out_proj``
and ``fc2``, zero biases, unit norms). Tensor/pipeline/sequence
parallelism, recompute, the KV-cache and paged paths and ``generate()``
belong to later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from .. import amp
from ..device import resolve_device
from ..generator import next_seed
from ..nn import Embedding, LayerNorm, Linear
from ..nn import functional as F
from ..ops.fused_loss import fused_linear_cross_entropy

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt3_1_3b"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    gelu_approximate: bool = False
    # fused chunked linear + CE (ops/fused_loss.py): forward(labels=...)
    # then returns (None, loss), never forming the [B*S, V] logits
    fused_loss: bool = False

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads:
            raise ValueError("num_heads must divide hidden_size")


def gpt_tiny(**kw) -> GPTConfig:
    cfg = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               max_position_embeddings=128, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0)
    cfg.update(kw)
    return GPTConfig(**cfg)


def gpt3_1_3b(**kw) -> GPTConfig:
    """GPT-3 XL 1.3B: vocab 50304, hidden 2048, 24 layers, 16 heads."""
    cfg = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
               num_heads=16, max_position_embeddings=2048)
    cfg.update(kw)
    return GPTConfig(**cfg)


def _add(a, b):
    a, b = amp.cast_inputs("add", a, b)
    return a + b


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.cfg = config
        h = config.hidden_size
        self.head_dim = h // config.num_heads
        self.qkv_proj = Linear(h, 3 * h)
        self.out_proj = Linear(h, h)
        self.attn_drop_p = config.attention_dropout_prob

    def forward(self, x):
        B, S, H = x.shape
        nh, hd = self.cfg.num_heads, self.head_dim
        qkv = self.qkv_proj(x)  # [B, S, 3H]
        q, k, v = (t.view(B, S, nh, hd) for t in qkv.split(H, dim=-1))
        ctx, _ = F.flash_attention(
            q, k, v, causal=True,
            dropout=self.attn_drop_p if self.training else 0.0)
        return self.out_proj(ctx.reshape(B, S, H))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        h, ff = config.hidden_size, config.intermediate_size
        self.fc1 = Linear(h, ff)
        self.fc2 = Linear(ff, h)
        self._gelu_approx = config.gelu_approximate

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self._gelu_approx))


class GPTDecoderLayer(nn.Module):
    """Pre-LN block: x + attn(ln1(x)); x + mlp(ln2(x))."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln1 = LayerNorm(config.hidden_size, eps=eps)
        self.attn = GPTAttention(config)
        self.ln2 = LayerNorm(config.hidden_size, eps=eps)
        self.mlp = GPTMLP(config)
        self.drop_p = config.hidden_dropout_prob

    def forward(self, x):
        h = F.dropout(self.attn(self.ln1(x)), self.drop_p, self.training)
        x = _add(x, h)
        h = F.dropout(self.mlp(self.ln2(x)), self.drop_p, self.training)
        return _add(x, h)


class GPTModel(nn.Module):
    """Embeddings -> decoder blocks -> final LayerNorm."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.embeddings = Embedding(config.vocab_size, config.hidden_size)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size)
        self.layers = nn.ModuleList([GPTDecoderLayer(config)
                                     for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              eps=config.layer_norm_epsilon)
        self.drop_p = config.hidden_dropout_prob

    def forward(self, input_ids, position_ids=None):
        B, S = input_ids.shape
        if S > self.config.max_position_embeddings:
            raise ValueError(f"sequence of {S} tokens past the "
                             f"{self.config.max_position_embeddings} "
                             "position embeddings")
        if position_ids is None:
            position_ids = torch.arange(
                S, device=input_ids.device).expand(B, S)
        x = _add(self.embeddings(input_ids),
                 self.position_embeddings(position_ids))
        x = F.dropout(x, self.drop_p, self.training)
        for layer in self.layers:
            x = layer(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """The LM head, tied to the input embedding. Built on ``device``
    (default ``cuda``; ``RuntimeError`` without a card unless
    ``device="cpu"``) in f32, its parameters drawn from
    ``torch.Generator(device).manual_seed(seed)``; ``seed`` defaults to
    the next seed of the global generator (``generator.seed``)."""

    def __init__(self, config: GPTConfig, *, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.gpt = GPTModel(config)
        self.to_empty(device=device)
        seed = next_seed() if seed is None else int(seed)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        cfg = self.config
        std = cfg.initializer_range
        proj_std = std / math.sqrt(2 * cfg.num_layers)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln" in name:
                p.fill_(1.0)
            elif name.endswith(("out_proj.weight", "fc2.weight")):
                p.normal_(0.0, proj_std, generator=gen)
            else:
                p.normal_(0.0, std, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.gpt.embeddings.weight.device

    def logits(self, hidden):
        h, w = amp.cast_inputs("matmul", hidden, self.gpt.embeddings.weight)
        return h @ w.T

    def forward(self, input_ids, position_ids=None, labels=None):
        """Logits ``[B, S, V]`` without ``labels``; with them ``(logits,
        mean loss)``, or ``(None, loss)`` when ``config.fused_loss``."""
        hidden = self.gpt(input_ids, position_ids)
        if labels is not None and self.config.fused_loss:
            H = self.config.hidden_size
            h, w = amp.cast_inputs("fused_linear_cross_entropy", hidden,
                                   self.gpt.embeddings.weight)
            return None, fused_linear_cross_entropy(
                h.reshape(-1, H), w, labels.reshape(-1))
        logits = self.logits(hidden)
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1))
        return logits, loss
