"""GPT: pre-LN decoder blocks, flash attention, tied head.

Counterpart of ``paddle_tpu/models/gpt.py``: the dense forward with its
loss (``GPTForCausalLM.forward(input_ids, labels=...)``), the unfused
cross entropy and the fused chunked linear-cross-entropy branch; and the
paged forward (``forward_paged``) that the serving engine's ragged step
runs, with the paged-attention kernel K4. Module and parameter names
match the JAX package (``gpt.layers.0.attn.qkv_proj.weight``, ...), so
its ``state_dict`` loads here key for key (``models/convert.py``).

Every op goes through the torch-layout layers and helpers of
``models/_modules.py`` and the port's functionals, and so through the
amp cast rule under the JAX package's op names (``amp.py``); the
residual and embedding adds cast as its ``add``. Attention is
``nn.functional.flash_attention`` on q/k/v that are ``[B, S, H, D]``
strided views of the fused QKV projection (no copy).

The paged step (``forward_paged``, no ``auto_cast``) keeps the JAX
package's dtypes. Under ``amp.decorate(level="O2")`` every parameter but
the LayerNorms' is bf16, biases included, so the embeddings give bf16, a
LayerNorm over bf16 gives bf16 (on its f32 weight), the fused QKV and
its bias give a bf16 q, k and v, K4 takes the bf16 q over the pages and
gives bf16, and the residual stream stays bf16 to the final LayerNorm;
the tied head's logits are bf16 (the engine widens them to f32 for the
sampler). Unlike Llama's paged step, nothing widens to f32 on the way.

The paged forward takes ``adapters=`` (``serving/adapters.py``
``AdapterRows``) at GPT's four sites, each reading its own input: one
delta on the fused ``[T, 3H]`` QKV output, which splits with it, one on
``out_proj`` over the merged attention output, and one each on ``fc1``
and ``fc2``. Every delta is exactly zero on the rows of slot 0.

Differences from the JAX package, by design of the port: Linear weights
are ``[out, in]``; parameters are drawn from an explicit
``torch.Generator`` on the target device (Normal(0, 0.02) for
projections and embeddings, ``0.02 / sqrt(2 * layers)`` for ``out_proj``
and ``fc2``, zero biases, unit norms); the paged step's grid is
flattened to ``[T, H]`` (the JAX step's ``[B, 1, H]``) and the KV pools
are written in place. The head is always tied (``tie_word_embeddings``
is the JAX default).

Sequence parallelism (``paddle_tpu/models/gpt.py:192-200``, ``:411``):
with ``config.sequence_parallel`` under a mesh whose ``sep`` degree is
above 1, every rank takes the whole ``input_ids`` (and ``position_ids``
and ``labels``), runs its chunk of the sequence (``ValueError`` when
``sep`` does not divide ``S``) through the whole model at its global
positions, and the attention is ring attention over the ``sep`` group;
the loss is the global mean and the logits are gathered, as Llama's
(``models/llama.py``). With attention dropout in training the JAX
package leaves the ring and runs flash attention over the whole
sequence; here each rank gathers k and v over ``sep`` and runs K1-K3 on
its queries against keys ``[0, (r+1) C)``, the queries placed at their
global rows behind ``r C`` zero rows, so the kernels' causal mask and
dropout hash see the rows that one device would (the zero rows' dO is
zero, so they add nothing to dK or dV). ``sep`` beside ``mp``, ``pp`` or
``sharding`` above 1 is not ported and raises.

Pipeline parallelism (``paddle_tpu/models/gpt.py:388-405``, ``:423-461``):
when the current mesh's ``pp`` degree is above 1 at construction, the
blocks are a :class:`GPTStackedBlocks` trunk, this stage's rows of each
stacked ``[L, ...]`` parameter (``gpt.layers.s_attn__qkv_proj__weight``,
the JAX package's names; a Linear's rows ``[out, in]``), run through
``fleet/pipeline_schedule.py``'s GPipe over ``pp_num_microbatches``
(default the ``pp`` degree): every stage runs the embeddings, the final
LayerNorm and the tied head on the whole batch, so every stage returns
the same logits and loss, and the blocks' K1-K3 run inside each stage.
Dropout must be 0 there, as in the JAX package; ``pp`` with ``mp`` above
1, the KV-cache and the paged forward are refused. ``models/convert.py``
carries the JAX package's stacked parameters (and ``stack_reference``
a dense model's) to the stages.

Tensor parallelism (``paddle_tpu/models/gpt.py:121-135``, ``:297-310``,
``:374-380``, ``:529``, ``:548``): when the current mesh's ``mp`` degree
is above 1 at construction, the QKV projection and ``fc1`` are
column-parallel, ``out_proj`` and ``fc2`` row-parallel, the word
embedding vocab-parallel (``models/_modules.py``, Megatron-style shards
over the ``mp`` group), so attention runs on ``num_heads / mp`` heads a
rank; the logits are this rank's vocabulary block ``[B, S, V/mp]`` and
the loss is ``ParallelCrossEntropy``'s mean (``fused_loss`` is for
``mp`` 1, as in the JAX package). ``models/convert.py`` carries a whole
JAX weight into this rank's shard and gathers it back.

``config.recompute`` runs each block under ``recompute`` with
``config.recompute_policy`` (``distributed/fleet/recompute.py``), as the
JAX package's GPT does at pp = 1. The KV-cache forward
(``GPTModel.forward(ids, caches=, cur_len=)``, behind ``generate()``,
``models/generation.py``) gathers the learned positions at ``cur_len +
arange(S)`` (``cur_len`` a 0-d device tensor), writes every head's k and
v into the caches in place and attends over the whole buffer with the
JAX package's plain masked softmax; no dropout runs on it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from .. import amp
from ..device import resolve_device
from ..distributed.fleet.recompute import recompute
from ..generator import next_seed
from ..nn import functional as F
from ..ops.fused_loss import fused_linear_cross_entropy
from ..ops.paged_attention import ragged_paged_attention
from ..quantization.observers import quantize_kv
from ..tensor import facade_io
from ..distributed import topology
from ..distributed.fleet.mp_layers import (c_identity,
                                             parallel_cross_entropy)
from ..distributed.fleet.pipeline_schedule import _StackRuntime
from ..distributed.ring_attention import (all_gather_sequence,
                                          ring_attention_local)
from ._modules import (ColumnParallelLinear, Embedding, LayerNorm, Linear,
                       RowParallelLinear, VocabParallelEmbedding,
                       cached_attention, mp_size, sep_chunk, sep_group,
                       sep_logits, sep_mean_loss)
from .generation import GenerationMixin

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
    # each block under recompute (distributed/fleet/recompute.py) with the
    # policy: None/'full' recompute everything, 'dots' saves the matmul
    # outputs, 'dots_no_batch' those without batch dims
    recompute: bool = False
    recompute_policy: Optional[str] = None
    # fused chunked linear + CE (ops/fused_loss.py): forward(labels=...)
    # then returns (None, loss), never forming the [B*S, V] logits
    fused_loss: bool = False
    # pp > 1: microbatches of the pipelined trunk (default: the pp degree)
    pp_num_microbatches: Optional[int] = None
    # ring attention over the mesh's 'sep' axis when its degree is above 1
    sequence_parallel: bool = False

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
        h, nh = config.hidden_size, config.num_heads
        self.head_dim = h // nh
        mp = mp_size()
        if nh % mp:
            raise ValueError(f"num_heads {nh} not divisible by mp {mp}")
        if mp > 1:
            self.qkv_proj = ColumnParallelLinear(h, 3 * h, pieces=3)
            self.out_proj = RowParallelLinear(h, h)
        else:
            self.qkv_proj = Linear(h, 3 * h)
            self.out_proj = Linear(h, h)
        self.attn_drop_p = config.attention_dropout_prob

    def forward(self, x):
        """Causal attention over ``x`` ``[B, S, H]``; under tensor
        parallelism over this rank's ``num_heads / mp`` heads; under
        sequence parallelism ``x`` is this rank's chunk (module
        docstring)."""
        B, S, _ = x.shape
        hd = self.head_dim
        qkv = self.qkv_proj(x)  # [B, S, 3H/mp]
        hl = qkv.shape[-1] // 3
        q, k, v = (t.view(B, S, hl // hd, hd) for t in qkv.split(hl, dim=-1))
        drop = self.attn_drop_p if self.training else 0.0
        sep = sep_group(self.cfg)
        if sep is None:
            ctx, _ = F.flash_attention(q, k, v, causal=True, dropout=drop)
        elif drop:
            ctx = self._gathered_attention(q, k, v, drop, sep)
        else:
            ctx = ring_attention_local(
                *amp.cast_inputs("ring_attention", q, k, v), causal=True,
                group=sep)
        return self.out_proj(ctx.reshape(B, S, hl))

    @staticmethod
    def _gathered_attention(q, k, v, drop, sep):
        """Attention with dropout of this rank's queries over k and v
        gathered over ``sep``, the queries at their global rows (module
        docstring)."""
        B, C, H, D = q.shape
        first = sep.rank * C
        k, v = (all_gather_sequence(t, sep)[:, :first + C] for t in (k, v))
        q = torch.cat([q.new_zeros(B, first, H, D), q], dim=1)
        ctx, _ = F.flash_attention(q, k, v, causal=True, dropout=drop)
        return ctx[:, first:]

    def forward_cached(self, x, cache, cur_len):
        """KV-cache step over ``x`` ``[B, S, H]`` at positions ``cur_len +
        arange(S)`` (``cur_len`` a 0-d int64 device tensor): every head's k
        and v written into the caches ``(k_buf, v_buf)`` ``[B, L, heads,
        D]`` in place (in their dtype), then q over the whole buffer, each
        query masked at its own position (``cached_attention``; the JAX
        package's ``cached_attention`` op, ``models/gpt.py:142-189``)."""
        B, S, H = x.shape
        nh, hd = self.cfg.num_heads, self.head_dim
        k_buf, v_buf = cache
        qkv = self.qkv_proj(x)
        q, k, v = (t.reshape(B, S, nh, hd) for t in qkv.split(H, dim=-1))
        q, k, v = amp.cast_inputs("cached_attention", q, k, v)
        pos = cur_len + torch.arange(S, device=x.device)
        k_buf.index_copy_(1, pos, k.to(k_buf.dtype))
        v_buf.index_copy_(1, pos, v.to(v_buf.dtype))
        ctx = cached_attention(q, k_buf, v_buf, pos, k_buf.shape[1],
                               1.0 / math.sqrt(hd))
        (ctx,) = amp.cast_inputs("merge_heads", ctx)
        return self.out_proj(ctx.reshape(B, S, H))

    def forward_paged(self, x, positions, block_tables, k_pool, v_pool,
                      attention=ragged_paged_attention, k_scale=None,
                      v_scale=None, adapters=None, layer_idx=0):
        """Paged-KV ragged step: one query token per row of ``x`` ``[T, H]``
        at ``positions`` ``[T]`` (int32), each with its owner's block table
        ``[T, pages]`` (int32). The fused QKV (plus its one LoRA delta,
        which splits with it) gives q, k and v; every row's k/v is written
        into its page slot (in place, rounded to the page dtype; int8
        pages quantized per slot with their scales, both or neither),
        then ``attention`` runs each row over its pages masked at its own
        position, which makes a chunk's rows causal over their freshly
        written chunk-mates. Padding rows carry the null table and
        position 0, so their writes land on page 0. Every write is an
        ``index_put_`` at int64 indices, so the step can be captured in a
        CUDA graph. Position embeddings were added by the trunk. Returns
        ``[T, H]`` in q's dtype."""
        T, H = x.shape
        nh, hd = self.cfg.num_heads, self.head_dim
        qkv = self.qkv_proj(x)
        if adapters is not None:
            qkv = adapters.apply("qkv_proj", layer_idx, x, qkv)
        q, k, v = (t.reshape(T, nh, hd) for t in qkv.split(H, dim=-1))
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
        merged = ctx.reshape(T, H)
        out = self.out_proj(merged)
        if adapters is not None:
            out = adapters.apply("out_proj", layer_idx, merged, out)
        return out


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        h, ff = config.hidden_size, config.intermediate_size
        if mp_size() > 1:
            self.fc1 = ColumnParallelLinear(h, ff)
            self.fc2 = RowParallelLinear(ff, h)
        else:
            self.fc1 = Linear(h, ff)
            self.fc2 = Linear(ff, h)
        self._gelu_approx = config.gelu_approximate

    def forward(self, x, adapters=None, layer_idx=0):
        """``adapters`` (an ``AdapterRows``, paged step only) adds the
        fc1 and fc2 deltas of layer ``layer_idx``."""
        if adapters is None:
            return self.fc2(F.gelu(self.fc1(x),
                                   approximate=self._gelu_approx))
        h = adapters.apply("fc1", layer_idx, x, self.fc1(x))
        a = F.gelu(h, approximate=self._gelu_approx)
        return adapters.apply("fc2", layer_idx, a, self.fc2(a))


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

    def forward(self, x, cache=None, cur_len=None):
        """The block; with ``cache`` the KV-cache step (no dropout), which
        writes the layer's ``(k_buf, v_buf)`` in place at ``cur_len``."""
        if cache is not None:
            x = _add(x, self.attn.forward_cached(self.ln1(x), cache,
                                                 cur_len))
            return _add(x, self.mlp(self.ln2(x)))
        h = F.dropout(self.attn(self.ln1(x)), self.drop_p,
                      training=self.training)
        x = _add(x, h)
        h = F.dropout(self.mlp(self.ln2(x)), self.drop_p,
                      training=self.training)
        return _add(x, h)

    def forward_paged(self, x, positions, block_tables, k_pool, v_pool,
                      attention=ragged_paged_attention, k_scale=None,
                      v_scale=None, adapters=None, layer_idx=0):
        x = _add(x, self.attn.forward_paged(
            self.ln1(x), positions, block_tables, k_pool, v_pool,
            attention=attention, k_scale=k_scale, v_scale=v_scale,
            adapters=adapters, layer_idx=layer_idx))
        return _add(x, self.mlp(self.ln2(x), adapters=adapters,
                                layer_idx=layer_idx))


class GPTStackedBlocks(_StackRuntime, nn.Module):
    """The decoder blocks under ``pp`` above 1: this stage's rows of each
    stacked parameter, ``s_<name with . as __>`` (module docstring); a
    block runs as a template ``GPTDecoderLayer`` (on the meta device)
    with a row's values. ``vpp`` above 1 (a trunk built on its own; the
    model's is 1, as in the JAX package) runs the interleaved schedule."""

    def __init__(self, config: GPTConfig, vpp: int = 1):
        nn.Module.__init__(self)
        self._init_stack(config.num_layers, vpp)
        with torch.device("meta"):
            template = GPTDecoderLayer(config)
        object.__setattr__(self, "template", template)
        self._names = [n for n, _ in template.named_parameters()]
        for n, p in template.named_parameters():
            self.register_parameter(
                "s_" + n.replace(".", "__"),
                nn.Parameter(torch.empty((self.local_layers,) + p.shape,
                                         dtype=p.dtype)))

    @property
    def stacked(self):
        return [getattr(self, "s_" + n.replace(".", "__"))
                for n in self._names]

    def _run_block(self, vals, x):
        return torch.func.functional_call(
            self.template, dict(zip(self._names, vals)), (x,))


class GPTModel(nn.Module):
    """Embeddings -> decoder blocks -> final LayerNorm."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.embeddings = (
            VocabParallelEmbedding(config.vocab_size, config.hidden_size)
            if mp_size() > 1 else
            Embedding(config.vocab_size, config.hidden_size))
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size)
        self._pp = topology.axis_size("pp")
        if self._pp > 1:
            if config.hidden_dropout_prob or config.attention_dropout_prob:
                raise ValueError(
                    "pp>1 runs the stacked blocks through the pipeline "
                    "schedule, whose dropout is not ported; set dropout "
                    "probs to 0")
            if mp_size() > 1:
                raise NotImplementedError("GPT with both pp and mp above 1")
            self.layers = GPTStackedBlocks(config)
        else:
            self.layers = nn.ModuleList([GPTDecoderLayer(config)
                                         for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              eps=config.layer_norm_epsilon)
        self.drop_p = config.hidden_dropout_prob

    def forward(self, input_ids, position_ids=None, caches=None,
                cur_len=None):
        """Dense trunk: the final LayerNorm's hidden states ``[B, S, H]``;
        each block under ``recompute`` when ``config.recompute``. With
        ``caches`` (a per-layer list of ``(k_buf, v_buf)``) the KV-cache
        trunk at ``cur_len`` (a 0-d int64 device tensor): returns
        ``(hidden, caches)``, the caches written in place."""
        B, S = input_ids.shape
        cfg = self.config
        if caches is not None and self._pp > 1:
            raise NotImplementedError(
                "KV-cache decode requires pp=1 (generation is a "
                "single-program path; pipeline decode is out of scope)")
        if caches is not None:
            pos = (cur_len + torch.arange(S, device=input_ids.device)
                   ).expand(B, S)
            x = _add(self.embeddings(input_ids),
                     self.position_embeddings(pos))
            for layer, cache in zip(self.layers, caches):
                x = layer(x, cache=cache, cur_len=cur_len)
            return self.ln_f(x), caches
        if S > self.config.max_position_embeddings:
            raise ValueError(f"sequence of {S} tokens past the "
                             f"{self.config.max_position_embeddings} "
                             "position embeddings")
        if position_ids is None:
            position_ids = torch.arange(
                S, device=input_ids.device).expand(B, S)
        sep = sep_group(cfg)
        input_ids, position_ids = (sep_chunk(t, sep)
                                   for t in (input_ids, position_ids))
        x = _add(self.embeddings(input_ids),
                 self.position_embeddings(position_ids))
        x = F.dropout(x, self.drop_p, training=self.training)
        if self._pp > 1:
            if cfg.recompute:
                import warnings

                warnings.warn(
                    "GPTConfig.recompute is subsumed under pp>1: the "
                    "pipeline schedule already recomputes each stage's "
                    "blocks in its backward; the flag adds nothing",
                    stacklevel=2)
            return self.ln_f(self.layers(
                x, num_microbatches=cfg.pp_num_microbatches or self._pp))
        for layer in self.layers:
            x = (recompute(layer, x, policy=cfg.recompute_policy)
                 if cfg.recompute else layer(x))
        return self.ln_f(x)

    def forward_paged(self, input_ids, positions, block_tables, caches,
                      attention=ragged_paged_attention, adapters=None):
        """Paged trunk of the serving step: ``input_ids`` ``[T]``,
        ``positions`` ``[T]`` int32 (the learned position embedding is
        gathered per row at its position), ``block_tables`` ``[T, pages]``
        int32, ``caches`` a per-layer list of ``(k_pool, v_pool)``, or
        ``(k_pool, v_pool, k_scale, v_scale)`` for int8 pages, written in
        place; ``adapters`` an ``AdapterRows`` or None. Returns the final
        LayerNorm's hidden states ``[T, H]``."""
        if self._pp > 1:
            raise NotImplementedError(
                "paged decode requires pp=1 (same single-program scope as "
                "KV-cache decode)")
        x = _add(self.embeddings(input_ids.to(torch.int64)),
                 self.position_embeddings(positions.to(torch.int64)))
        for li, (layer, (kp, vp, *scales)) in enumerate(
                zip(self.layers, caches)):
            ks, vs = scales or (None, None)
            x = layer.forward_paged(x, positions, block_tables, kp, vp,
                                    attention=attention, k_scale=ks,
                                    v_scale=vs, adapters=adapters,
                                    layer_idx=li)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module, GenerationMixin):
    """The LM head, tied to the input embedding. Built on ``device``
    (default ``cuda``; ``RuntimeError`` without a card unless
    ``device="cpu"``) in f32, its parameters drawn from
    ``torch.Generator(device).manual_seed(seed)``; ``seed`` defaults to
    the next seed of the global generator (``generator.seed``). With
    ``dtype`` bf16 or fp16 they are then cast by ``amp.decorate(level=
    "O2")``'s rule: every parameter but the LayerNorms' (which stay
    f32)."""

    def __init__(self, config: GPTConfig, *, device=None,
                 seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.gpt = GPTModel(config)
        self.to_empty(device=device)
        seed = next_seed() if seed is None else int(seed)
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
            # a stacked block parameter by its block's name
            name = name.replace(".s_", ".").replace("__", ".")
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

    @facade_io
    def forward(self, input_ids, position_ids=None, labels=None):
        """Logits ``[B, S, V]`` without ``labels``; with them ``(logits,
        mean loss)``, or ``(None, loss)`` when ``config.fused_loss``. Given
        facade Tensors, it returns facade Tensors (``tensor.facade_io``).
        Under tensor parallelism the logits are this rank's vocabulary
        block and the loss ``ParallelCrossEntropy``'s mean."""
        hidden = self.gpt(input_ids, position_ids)
        sep = sep_group(self.config)
        if sep is not None:
            return self._forward_sep(hidden, labels, sep)
        emb = self.gpt.embeddings
        if isinstance(emb, VocabParallelEmbedding):
            # the head reads the whole hidden state on every rank: its
            # gradient sums over the vocabulary blocks (c_identity)
            logits = self.logits(c_identity(hidden, emb.group))
            if labels is None:
                return logits
            loss = parallel_cross_entropy(
                logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                emb.group)
            return logits, loss.mean()
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

    def _forward_sep(self, hidden, labels, sep):
        """The head over this rank's chunk under sequence parallelism
        (module docstring)."""
        if labels is None:
            return sep_logits(self.logits(hidden), sep)
        labels = sep_chunk(labels, sep).reshape(-1)
        if self.config.fused_loss:
            h, w = amp.cast_inputs("fused_linear_cross_entropy", hidden,
                                   self.gpt.embeddings.weight)
            mean = fused_linear_cross_entropy(
                h.reshape(-1, self.config.hidden_size), w, labels)
            return None, sep_mean_loss(mean, labels, sep)
        logits = self.logits(hidden)
        mean = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels)
        return sep_logits(logits, sep), sep_mean_loss(mean, labels, sep)

    # ---------------------------------------------------- serving hooks
    def _decode_trunk(self):
        if isinstance(self.gpt.embeddings, VocabParallelEmbedding):
            raise NotImplementedError(
                "generate and serving run the mp = 1 model")
        return self.gpt

    def _cache_spec(self):
        cfg = self.config
        return (cfg.num_layers, cfg.num_heads,
                cfg.hidden_size // cfg.num_heads)

    def lora_sites(self):
        """The ``AdapterStore`` contract: ordered ``(site, in_dim,
        out_dim)`` triples and the layer count. GPT's QKV is fused, so one
        ``qkv_proj`` site covers q, k and v with a ``[H -> 3H]`` delta."""
        cfg = self.config
        h, ff = cfg.hidden_size, cfg.intermediate_size
        sites = [("qkv_proj", h, 3 * h), ("out_proj", h, h),
                 ("fc1", h, ff), ("fc2", ff, h)]
        return sites, cfg.num_layers

    def lora_site_groups(self):
        """No two of GPT's sites read one input (the LayerNorm's output,
        the merged attention, the LayerNorm's output after the residual,
        the GELU), so each is a group of its own."""
        return ()
