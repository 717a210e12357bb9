"""Transformer layers (``paddle_tpu/nn/layer/transformer.py``):
MultiHeadAttention (with ``gen_cache``), TransformerEncoderLayer/Encoder,
TransformerDecoderLayer/Decoder and Transformer.

Attention runs through ``functional.scaled_dot_product_attention`` on
``[B, S, H, D]`` q/k/v (the projections' outputs reshaped, no
transpose): no mask, or a bool ``[B, 1, 1, Sk]`` key-padding mask, goes
to flash attention (the CUDA kernels K1-K3 for CUDA tensors, their plain
version on the CPU); any other mask takes the dense ``_sdpa_ref``, as in
the JAX package. The projections are separate Linears, as there.
"""
from __future__ import annotations

import collections
import copy

import torch

from ... import dtypes
from ...ops import concat, reshape, unsqueeze
from ...ops._apply import ensure_tensor
from ...tensor import Tensor
from .. import functional as F
from ..layer_base import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = [
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
]


def _convert_attention_mask(attn_mask, dtype):
    """reference: nn/layer/transformer.py _convert_attention_mask — bool
    masks become ADDITIVE bias in ``dtype`` (-1e9 where masked, 0 where
    kept) so user code following the reference pattern of adding the
    result to attention scores keeps exact semantics. Internal layers use
    :func:`_normalize_attention_mask` instead, which passes bool through
    (our sdpa consumes bool natively, and a bool [B, 1, 1, Sk]
    key-padding mask is what routes onto the Pallas flash kernel)."""
    if attn_mask is None:
        return None
    attn_mask = ensure_tensor(attn_mask)
    if attn_mask._value.dtype == torch.bool:
        dt = dtypes.convert_dtype(dtype) or torch.float32
        m = attn_mask._value
        return Tensor(torch.where(m, torch.zeros((), dtype=dt, device=m.device),
                                  torch.full((), -1e9, dtype=dt, device=m.device)),
                      stop_gradient=True)
    return attn_mask


def _normalize_attention_mask(attn_mask):
    """Internal mask path: bool AND additive masks pass through unchanged
    — sdpa takes bool natively (where(mask, logits, -inf)), which is both
    cheaper than materializing a -1e9 bias and the form the flash-kernel
    key-padding route (attention.py _as_key_padding) requires."""
    if attn_mask is None:
        return None
    return ensure_tensor(attn_mask)


_Cache = collections.namedtuple("Cache", ["k", "v"])
_StaticCache = collections.namedtuple("StaticCache", ["k", "v"])


class MultiHeadAttention(Layer):
    """reference: nn/layer/transformer.py MultiHeadAttention.

    Examples:
        >>> mha = paddle.nn.MultiHeadAttention(embed_dim=16, num_heads=4)
        >>> x = paddle.to_tensor(np.ones((2, 6, 16), "float32"))
        >>> mha(x, x, x).shape
        [2, 6, 16]
    """

    Cache = _Cache  # incremental decode kv cache
    StaticCache = _StaticCache  # precomputed encoder kv

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        b, s = x.shape[0], x.shape[1]
        return reshape(x, [b, s, self.num_heads, self.head_dim])

    def gen_cache(self, key, value=None, type=None):
        if type is _StaticCache or (value is not None and type is None):
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None else key))
            return _StaticCache(k, v)
        # incremental cache seeded empty
        key = ensure_tensor(key)
        b = key.shape[0]
        empty = torch.zeros((b, 0, self.num_heads, self.head_dim),
                            dtype=torch.float32, device=key._value.device)
        return _Cache(Tensor(empty), Tensor(empty))

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        new_cache = None
        if isinstance(cache, _StaticCache):
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if cache is not None:
                ck, cv = cache
                if ck.shape[1] > 0:
                    k = concat([ck, k], axis=1)
                    v = concat([cv, v], axis=1)
                new_cache = _Cache(k, v)
        mask = _normalize_attention_mask(attn_mask)
        if mask is not None:
            # broadcast to [B, H, Sq, Sk]
            m = mask
            while m.ndim < 4:
                m = unsqueeze(m, axis=0)
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, dropout_p=self.dropout, training=self.training)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, dropout_p=self.dropout, training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = reshape(out, [b, s, self.embed_dim])
        out = self.out_proj(out)
        if cache is not None:
            return out, new_cache
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, new_cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, new_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)
        ])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, nc = layer(output, src_mask, cache[i])
                new_caches.append(nc)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incr_cache = None
        else:
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = None
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache, static_cache))

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory, type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(memory, memory,
                                           type=MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)
        ])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, nc = layer(output, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(nc)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip: bool = False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr, bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers, enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr, bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers, dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        from ...device import default_device

        keep = torch.ones((length, length), dtype=torch.bool,
                          device=default_device()).tril()
        return Tensor(torch.where(keep, 0.0, float("-inf")).float())
