"""The fused layers of the port (``paddle_tpu/incubate/nn/layer.py``).

The JAX package's parameter names, shapes and ``state_dict`` keys; the
attention core is ``nn.functional.scaled_dot_product_attention`` on
``[B, S, H, D]`` views of one packed QKV product: the flash kernels K1-K3
on CUDA tensors with no mask or a bool ``[B, 1, 1, Sk]`` key-padding
mask, the dense version for any other mask. An incremental cache is a
``(k, v)`` pair laid out ``[B, S_past, H, D]``, extended along axis 1, as
the JAX code concatenates it (its docstring's ``[B, H, S, D]`` is not
what it does). ``FusedMultiTransformer``'s blocks are the sublayers
``"0"``, ``"1"``, ... (each ``fused_attn.*`` and ``ffn.*``).
"""
from __future__ import annotations

import math

from ... import ops
from ...autograd.engine import apply_op
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer_base import Layer
from ...ops._apply import ensure_tensor

__all__ = [
    "FusedLinear", "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
    "FusedMultiHeadAttention", "FusedFeedForward",
    "FusedTransformerEncoderLayer", "FusedMultiTransformer", "FusedEcMoe",
]


def _uniform(layer, shape, fan_in):
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    return layer.create_parameter(
        list(shape), default_initializer=I.Uniform(-bound, bound))


def _const(layer, shape, value):
    return layer.create_parameter(list(shape),
                                  default_initializer=I.Constant(value))


def _heads(qkv, i):
    """``qkv[:, :, i]``, a ``[B, S, H, D]`` view; copied when its offset
    ``H * D`` elements is not a multiple of 16 bytes, which the bf16
    flash kernels need of each input (``ops/flash_attention.py``
    ``_aligned16``)."""
    t = qkv[:, :, i]
    if t.shape[2] * t.shape[3] * t._value.element_size() % 16:
        t = apply_op(lambda a: a.contiguous(), [t], name="contiguous")
    return t


class FusedLinear(Layer):
    """reference: incubate/nn/layer/fused_linear.py:19 -- a GEMM with its
    bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self.transpose_weight = transpose_weight
        shape = ([out_features, in_features] if transpose_weight
                 else [in_features, out_features])
        self.weight = _uniform(self, shape, in_features)
        self.bias = (None if bias_attr is False
                     else _const(self, [out_features], 0.0))

    def forward(self, x):
        w = self.weight
        if self.transpose_weight:
            w = ops.t(w)
        return F.linear(x, w, self.bias)


class FusedDropoutAdd(Layer):
    """reference: fused_dropout_add.py:19 -- dropout(x) + y."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return F.dropout(x, p=self.p, training=self.training,
                         mode=self.mode) + ensure_tensor(y)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class FusedBiasDropoutResidualLayerNorm(Layer):
    """reference: fused_transformer.py:82 -- ln(residual + dropout(x +
    bias))."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.linear_bias = _const(self, [embed_dim], 0.0)
        self.ln_scale = _const(self, [embed_dim], 1.0)
        self.ln_bias = _const(self, [embed_dim], 0.0)

    def forward(self, x, residual):
        h = ensure_tensor(x) + self.linear_bias
        h = F.dropout(h, p=self.dropout_rate, training=self.training)
        h = ensure_tensor(residual) + h
        return F.layer_norm(h, [self.embed_dim], weight=self.ln_scale,
                            bias=self.ln_bias, epsilon=self._epsilon)


class FusedMultiHeadAttention(Layer):
    """reference: fused_transformer.py:192 -- the packed-QKV attention
    block with pre or post LayerNorm, residual and dropout epilogues.
    ``qkv_weight`` is ``[3, H, D, E]`` (``[E, 3E]`` with
    ``transpose_qkv_wb``)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, transpose_qkv_wb=False, name=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self.need_weights = need_weights
        self._epsilon = epsilon
        self.transpose_qkv_wb = transpose_qkv_wb
        H, D = num_heads, self.head_dim
        if transpose_qkv_wb:
            qkv_w_shape, qkv_b_shape = [embed_dim, 3 * embed_dim], \
                [3 * embed_dim]
        else:
            qkv_w_shape, qkv_b_shape = [3, H, D, embed_dim], [3, H, D]
        self.qkv_weight = _uniform(self, qkv_w_shape, embed_dim)
        self.qkv_bias = _const(self, qkv_b_shape, 0.0)
        self.linear_weight = _uniform(self, [embed_dim, embed_dim],
                                      embed_dim)
        self.linear_bias = _const(self, [embed_dim], 0.0)
        self.pre_ln_scale = _const(self, [embed_dim], 1.0)
        self.pre_ln_bias = _const(self, [embed_dim], 0.0)
        self.ln_scale = _const(self, [embed_dim], 1.0)
        self.ln_bias = _const(self, [embed_dim], 0.0)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        x = ensure_tensor(query)
        residual = x
        if self.normalize_before:
            x = F.layer_norm(x, [self.embed_dim], weight=self.pre_ln_scale,
                             bias=self.pre_ln_bias, epsilon=self._epsilon)
        B, S = x.shape[0], x.shape[1]
        H, D = self.num_heads, self.head_dim
        if self.transpose_qkv_wb:
            qkv = ops.matmul(x, self.qkv_weight) + self.qkv_bias
            qkv = ops.reshape(qkv, [B, S, 3, H, D])
        else:
            # x [B, S, E] @ w [3, H, D, E] -> [B, S, 3, H, D]
            w = ops.reshape(self.qkv_weight, [3 * H * D, self.embed_dim])
            qkv = ops.matmul(x, ops.t(w))
            qkv = ops.reshape(qkv, [B, S, 3, H, D]) \
                + ops.reshape(self.qkv_bias, [1, 1, 3, H, D])
        q, k, v = (_heads(qkv, i) for i in range(3))
        new_cache = None
        if cache is not None:
            k_past, v_past = cache
            if k_past is not None and k_past.shape[1] > 0:
                k = ops.concat([ensure_tensor(k_past), k], axis=1)
                v = ops.concat([ensure_tensor(v_past), v], axis=1)
            new_cache = (k, v)
        ctx = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate if self.training else 0.0)
        ctx = ops.reshape(ctx, [B, S, self.embed_dim])
        out = ops.matmul(ctx, self.linear_weight) + self.linear_bias
        out = F.dropout(out, p=self.dropout_rate, training=self.training)
        out = residual + out
        if not self.normalize_before:
            out = F.layer_norm(out, [self.embed_dim], weight=self.ln_scale,
                               bias=self.ln_bias, epsilon=self._epsilon)
        if cache is not None:
            return out, new_cache
        return out

    def extra_repr(self):
        return (f"embed_dim={self.embed_dim}, num_heads={self.num_heads}, "
                f"dropout_rate={self.dropout_rate}, "
                f"normalize_before={self.normalize_before}")


class FusedFeedForward(Layer):
    """reference: fused_transformer.py:497 -- LayerNorm, linear,
    activation, dropout, linear, dropout and the residual."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self._d_model = d_model
        self._dim_feedforward = dim_feedforward
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                  else act_dropout_rate)
        self._act_method = activation
        self._normalize_before = normalize_before
        self._epsilon = epsilon
        self.linear1_weight = _uniform(self, [d_model, dim_feedforward],
                                       d_model)
        self.linear1_bias = _const(self, [dim_feedforward], 0.0)
        self.linear2_weight = _uniform(self, [dim_feedforward, d_model],
                                       dim_feedforward)
        self.linear2_bias = _const(self, [d_model], 0.0)
        self.ln1_scale = _const(self, [d_model], 1.0)
        self.ln1_bias = _const(self, [d_model], 0.0)
        self.ln2_scale = _const(self, [d_model], 1.0)
        self.ln2_bias = _const(self, [d_model], 0.0)

    def forward(self, src, cache=None):
        x = ensure_tensor(src)
        residual = x
        if self._normalize_before:
            x = F.layer_norm(x, [self._d_model], weight=self.ln1_scale,
                             bias=self.ln1_bias, epsilon=self._epsilon)
        h = F.linear(x, self.linear1_weight, self.linear1_bias)
        h = getattr(F, self._act_method)(h)
        h = F.dropout(h, p=self._act_dropout_rate, training=self.training)
        h = F.linear(h, self.linear2_weight, self.linear2_bias)
        h = F.dropout(h, p=self._dropout_rate, training=self.training)
        out = residual + h
        if not self._normalize_before:
            out = F.layer_norm(out, [self._d_model], weight=self.ln2_scale,
                               bias=self.ln2_bias, epsilon=self._epsilon)
        return out


class FusedTransformerEncoderLayer(Layer):
    """reference: fused_transformer.py:725 -- ``FusedMultiHeadAttention``
    then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        act_dropout_rate = (dropout_rate if act_dropout_rate is None
                            else act_dropout_rate)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            attn_out, new_cache = self.fused_attn(src, attn_mask=src_mask,
                                                  cache=cache)
            return self.ffn(attn_out), new_cache
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(Layer):
    """reference: fused_transformer.py:1021 -- N pre-LN decoder blocks,
    the inference fast path; ``caches`` carry one ``(k, v)`` pair a
    layer, ``[B, S_past, H, D]`` each (module docstring)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None, num_layers=-1,
                 nranks=1, trans_qkvw=True, ring_id=-1, name=None, **kwargs):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError(
                "FusedMultiTransformer only supports normalize_before=True "
                "(reference contract)")
        if num_layers < 0:
            num_layers = 1
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.blocks = [FusedTransformerEncoderLayer(
            embed_dim, num_heads, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, normalize_before=True)
            for _ in range(num_layers)]
        for i, b in enumerate(self.blocks):
            self.add_sublayer(str(i), b)

    def forward(self, src, attn_mask=None, caches=None, **kwargs):
        x = ensure_tensor(src)
        if caches is None:
            for b in self.blocks:
                x = b(x, src_mask=attn_mask)
            return x
        if len(caches) != len(self.blocks):
            raise ValueError(
                f"caches must have one (k, v) pair per layer: got "
                f"{len(caches)} for {len(self.blocks)} layers")
        new_caches = []
        for b, c in zip(self.blocks, caches):
            x, nc = b(x, src_mask=attn_mask, cache=c)
            new_caches.append(nc)
        return x, new_caches


class FusedEcMoe(Layer):
    """reference: incubate/nn/layer/fused_ec_moe.py -- the expert FFNs'
    weights; ``forward(x, gate)`` takes the gate logits ``[B, S, E]``
    from the caller's gate network."""

    def __init__(self, hidden_size, inter_size, num_experts,
                 act_type="gelu", weight_attr=None, bias_attr=None):
        super().__init__()
        self.act_type = act_type
        self.bmm_weight0 = _uniform(
            self, [num_experts, hidden_size, inter_size], hidden_size)
        self.bmm_bias0 = _const(self, [num_experts, inter_size], 0.0)
        self.bmm_weight1 = _uniform(
            self, [num_experts, inter_size, hidden_size], inter_size)
        self.bmm_bias1 = _const(self, [num_experts, hidden_size], 0.0)

    def forward(self, x, gate):
        from .functional import fused_ec_moe

        return fused_ec_moe(x, gate, self.bmm_weight0, self.bmm_bias0,
                            self.bmm_weight1, self.bmm_bias1,
                            act_type=self.act_type)
