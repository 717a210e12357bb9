"""``paddle.incubate.nn.functional`` of the port
(``paddle_tpu/incubate/nn/functional.py``): the functional spellings of
the fused layers.

The same composite math as the JAX package: the products are cuBLAS
(``torch.matmul``/``einsum``, as the JAX side's are XLA dots), and the
attention of ``fused_multi_head_attention`` and
``fused_multi_transformer`` is ``nn.functional.scaled_dot_product_attention``,
which takes the flash kernels K1-K3 on CUDA tensors when the mask is
None or a bool ``[B, 1, 1, Sk]`` key-padding mask, and the dense
version for any other mask. ``qkv_weight`` is ``[3, H, D, E]``; a
``cache_kv`` is ``[2, B, S_past, H, D]``, extended along its sequence
axis, and the call then returns ``(out, cache_out)``.
"""
from __future__ import annotations

import torch

from ...autograd.engine import apply_op
from ...nn import functional as F
from ...ops._apply import ensure_tensor

__all__ = [
    "fused_multi_head_attention", "fused_feedforward",
    "fused_multi_transformer", "fused_matmul_bias", "fused_linear",
    "fused_bias_dropout_residual_layer_norm", "fused_ec_moe",
    "fused_dropout_add",
]


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """``x @ y + bias`` (the reference's cuBLASLt epilogue)."""
    ins = [ensure_tensor(x), ensure_tensor(y)]
    if bias is not None:
        ins.append(ensure_tensor(bias))

    def fn(a, b, *rest):
        if transpose_x:
            a = a.transpose(-1, -2)
        if transpose_y:
            b = b.transpose(-1, -2)
        out = a @ b
        return out + rest[0] if rest else out

    return apply_op(fn, ins, name="fused_matmul_bias")


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return fused_matmul_bias(x, weight, bias,
                             transpose_y=transpose_weight, name=name)


def fused_dropout_add(x, y, p=0.5, training=True,
                      mode="upscale_in_train", name=None):
    """dropout(x) + y."""
    return F.dropout(x, p=p, training=training, mode=mode) + ensure_tensor(y)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True, name=None):
    """ln(residual + dropout(x + bias))."""
    h = ensure_tensor(x)
    if bias is not None:
        h = h + ensure_tensor(bias)
    h = F.dropout(h, p=dropout_rate, training=training)
    h = ensure_tensor(residual) + h
    return F.layer_norm(h, [int(h.shape[-1])], weight=ln_scale, bias=ln_bias,
                        epsilon=ln_epsilon)


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False,
        pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None,
        pre_ln_epsilon=1e-5, qkv_bias=None, linear_bias=None, cache_kv=None,
        attn_mask=None, dropout_rate=0.5, attn_dropout_rate=0.5,
        ln_epsilon=1e-5, training=True, mode="upscale_in_train",
        ring_id=-1, add_residual=True, num_heads=None, name=None):
    """The packed-QKV attention block with its LayerNorm, dropout and
    residual epilogues (module docstring)."""
    xt = ensure_tensor(x)
    residual = xt
    if pre_layer_norm:
        xt = F.layer_norm(xt, [int(xt.shape[-1])], weight=pre_ln_scale,
                          bias=pre_ln_bias, epsilon=pre_ln_epsilon)
    ins = [xt, ensure_tensor(qkv_weight)]
    if qkv_bias is not None:
        ins.append(ensure_tensor(qkv_bias))

    def qkv_fn(v, w, *rest):
        # v [B, S, E] . w [3, H, D, E] -> [3, B, S, H, D]
        out = torch.einsum("bse,thde->tbshd", v, w)
        if rest:
            out = out + rest[0][:, None, None]
        return out[0], out[1], out[2]

    q, k, v = apply_op(qkv_fn, ins, name="fused_qkv")
    cache_out = None
    if cache_kv is not None:
        k, v = apply_op(
            lambda kk, vv, c: (torch.cat([c[0], kk], dim=1),
                               torch.cat([c[1], vv], dim=1)),
            [k, v, ensure_tensor(cache_kv)], name="extend_cache")
        cache_out = apply_op(lambda kk, vv: torch.stack([kk, vv]), [k, v],
                             name="stack_cache")
    ctx = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0)
    merged = apply_op(lambda t: t.reshape(t.shape[0], t.shape[1], -1),
                      [ctx], name="merge_heads")
    out = fused_matmul_bias(merged, linear_weight, linear_bias)
    out = F.dropout(out, p=dropout_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, [int(out.shape[-1])], weight=ln_scale,
                           bias=ln_bias, epsilon=ln_epsilon)
    if cache_out is not None:
        return out, cache_out
    return out


def fused_feedforward(
        x, linear1_weight, linear2_weight, linear1_bias=None,
        linear2_bias=None, ln1_scale=None, ln1_bias=None, ln2_scale=None,
        ln2_bias=None, dropout1_rate=0.5, dropout2_rate=0.5,
        activation="relu", ln1_epsilon=1e-5, ln2_epsilon=1e-5,
        pre_layer_norm=False, training=True, ring_id=-1, name=None):
    """The FFN block with its LayerNorm, dropout and residual epilogues."""
    xt = ensure_tensor(x)
    residual = xt
    if pre_layer_norm:
        xt = F.layer_norm(xt, [int(xt.shape[-1])], weight=ln1_scale,
                          bias=ln1_bias, epsilon=ln1_epsilon)
    h = fused_matmul_bias(xt, linear1_weight, linear1_bias)
    h = getattr(F, activation)(h)
    h = F.dropout(h, p=dropout1_rate, training=training)
    h = fused_matmul_bias(h, linear2_weight, linear2_bias)
    h = F.dropout(h, p=dropout2_rate, training=training)
    out = residual + h
    if not pre_layer_norm:
        out = F.layer_norm(out, [int(out.shape[-1])], weight=ln2_scale,
                           bias=ln2_bias, epsilon=ln2_epsilon)
    return out


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, pre_layer_norm=True,
                            epsilon=1e-5, cache_kvs=None, attn_mask=None,
                            dropout_rate=0.0, activation="gelu",
                            training=False, mode="upscale_in_train",
                            ring_id=-1, name=None):
    """Stacked decoder blocks over per-layer weight lists; with
    ``cache_kvs`` returns ``(out, new caches)``."""
    out = ensure_tensor(x)
    new_caches = [] if cache_kvs is not None else None
    for i in range(len(qkv_weights)):
        res = fused_multi_head_attention(
            out, qkv_weights[i], linear_weights[i],
            pre_layer_norm=pre_layer_norm, pre_ln_scale=ln_scales[i],
            pre_ln_bias=ln_biases[i], qkv_bias=qkv_biases[i],
            linear_bias=linear_biases[i], attn_mask=attn_mask,
            cache_kv=None if cache_kvs is None else cache_kvs[i],
            dropout_rate=dropout_rate, attn_dropout_rate=dropout_rate,
            training=training, mode=mode)
        if cache_kvs is not None:
            out, cache = res
            new_caches.append(cache)
        else:
            out = res
        out = fused_feedforward(
            out, ffn1_weights[i], ffn2_weights[i], linear1_bias=ffn1_biases[i],
            linear2_bias=ffn2_biases[i], ln1_scale=ffn_ln_scales[i],
            ln1_bias=ffn_ln_biases[i], dropout1_rate=dropout_rate,
            dropout2_rate=dropout_rate, activation=activation,
            pre_layer_norm=pre_layer_norm, training=training)
    if new_caches is not None:
        return out, new_caches
    return out


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu", name=None):
    """The expert-choice MoE block (reference:
    incubate/nn/functional/fused_ec_moe.py:18): ``gate`` is the gate
    logits ``[B, S, E]``, softmaxed over the experts; every expert's FFN
    applied to every token and weighted by its gate."""
    if act_type not in ("gelu", "relu"):
        raise ValueError("act_type must be 'gelu' or 'relu'")

    def fn(xv, gv, w1, b1, w2, b2):
        gates = torch.softmax(gv, dim=-1)                        # [B,S,E]
        h = torch.einsum("bsd,edf->bsef", xv, w1) + b1[None, None]
        # jax.nn.gelu's default, the tanh form
        h = (torch.nn.functional.gelu(h, approximate="tanh")
             if act_type == "gelu" else torch.relu(h))
        o = torch.einsum("bsef,efd->bsed", h, w2) + b2[None, None]
        return torch.einsum("bsed,bse->bsd", o, gates)

    return apply_op(fn, [ensure_tensor(t) for t in
                         (x, gate, bmm0_weight, bmm0_bias, bmm1_weight,
                          bmm1_bias)], name="fused_ec_moe")
