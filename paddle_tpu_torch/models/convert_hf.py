"""HuggingFace checkpoint -> port model weights (``paddle_tpu/models/
convert_hf.py``).

Each ``load_hf_*`` takes an in-memory HF-named ``state_dict`` (numpy
arrays or torch tensors; nothing is downloaded) and copies it in place
into the port's model, in the model's dtype and on its device. It checks
every shape (``ValueError`` naming the tensor), refuses a checkpoint with
a head of its own for a model whose head is tied, raises ``KeyError``
for a missing key and ``ValueError`` for keys left unused, and returns
the sorted keys it used, as the JAX package does.

Layouts, against the JAX package's rules:

- The port's Llama and GPT are ``torch.nn`` models whose ``Linear``
  weights are ``[out, in]``, HF's ``nn.Linear`` layout: Llama's
  projections and head copy as they are. GPT-2's ``Conv1D`` stores
  ``[in, out]``, which the JAX package takes untransposed; here it is
  transposed to ``[out, in]``. The fused ``c_attn`` maps onto the fused
  ``qkv_proj`` (q, k, v blocks in that order) in both.
- HF Llama's q and k rows are permuted for the rotate-half RoPE; both
  packages rotate interleaved pairs, so the rows are put back (the
  inverse of transformers' conversion permute), per head.
- The port's BERT is a Paddle ``Layer`` model with ``[in, out]``
  weights, as the JAX package's: its linears are transposed, and every
  LayerNorm takes the checkpoint's epsilon.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..tensor import Tensor

__all__ = ["load_hf_llama", "load_hf_gpt2", "load_hf_bert"]


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):  # bf16 too: numpy has no bf16
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


@torch.no_grad()
def _set(param, value: np.ndarray, name: str) -> None:
    dst = param._value if isinstance(param, Tensor) else param
    if tuple(dst.shape) != tuple(value.shape):
        raise ValueError(f"{name}: checkpoint shape {value.shape} != "
                         f"model shape {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def _assert_tied(head: np.ndarray, emb: np.ndarray) -> None:
    """A tied model can only take a checkpoint whose head is the
    embedding."""
    if head.shape != emb.shape or not np.array_equal(head, emb):
        raise ValueError(
            "checkpoint has an untied lm_head.weight but the target model "
            "ties word embeddings — rebuild with tie_word_embeddings=False")


def _unpermute_rope(w: np.ndarray, n_heads: int) -> np.ndarray:
    """``[out, in]`` HF rotate-half rows -> interleaved rows, per head."""
    out, inn = w.shape
    return (w.reshape(n_heads, 2, out // n_heads // 2, inn)
            .transpose(0, 2, 1, 3).reshape(out, inn))


class _SD:
    """The checkpoint with the keys taken so far: leftovers raise."""

    def __init__(self, state_dict: Dict):
        self.d = dict(state_dict)
        self.used = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self.d:
            raise KeyError(f"checkpoint is missing {key!r} "
                           f"(has {len(self.d)} keys)")
        self.used.add(key)
        return _np(self.d[key])

    def finish(self, ignore_substrings=("rotary_emb.inv_freq",
                                        "masked_bias", ".attn.bias",
                                        "position_ids")) -> List[str]:
        left = [k for k in self.d if k not in self.used
                and not any(s in k for s in ignore_substrings)]
        if left:
            raise ValueError(
                f"{len(left)} checkpoint keys were not consumed (first 8): "
                f"{left[:8]} — architecture/config mismatch?")
        return sorted(self.used)


def load_hf_llama(model, state_dict: Dict) -> List[str]:
    """A HF ``LlamaForCausalLM`` state dict into the port's
    ``LlamaForCausalLM``. Returns the keys used."""
    cfg = model.config
    nh, nkv = cfg.num_heads, cfg.num_key_value_heads
    sd = _SD(state_dict)
    _set(model.llama.embed_tokens.weight, sd.take("model.embed_tokens.weight"),
         "embed_tokens")
    for i, layer in enumerate(model.llama.layers):
        p = f"model.layers.{i}."
        a, mlp = layer.self_attn, layer.mlp
        _set(a.q_proj.weight,
             _unpermute_rope(sd.take(p + "self_attn.q_proj.weight"), nh),
             p + "q_proj")
        _set(a.k_proj.weight,
             _unpermute_rope(sd.take(p + "self_attn.k_proj.weight"), nkv),
             p + "k_proj")
        for dst, src in ((a.v_proj, "self_attn.v_proj"),
                         (a.o_proj, "self_attn.o_proj"),
                         (mlp.gate_proj, "mlp.gate_proj"),
                         (mlp.up_proj, "mlp.up_proj"),
                         (mlp.down_proj, "mlp.down_proj")):
            _set(dst.weight, sd.take(p + src + ".weight"), p + src)
        _set(layer.input_layernorm.weight,
             sd.take(p + "input_layernorm.weight"), p + "input_ln")
        _set(layer.post_attention_layernorm.weight,
             sd.take(p + "post_attention_layernorm.weight"), p + "post_ln")
    _set(model.llama.norm.weight, sd.take("model.norm.weight"), "norm")
    if model.lm_head is not None:
        key = ("lm_head.weight" if "lm_head.weight" in sd.d
               else "model.embed_tokens.weight")
        _set(model.lm_head.weight, sd.take(key), "lm_head")
    elif "lm_head.weight" in sd.d:
        _assert_tied(sd.take("lm_head.weight"),
                     _np(sd.d["model.embed_tokens.weight"]))
    return sd.finish()


def load_hf_gpt2(model, state_dict: Dict,
                 expect_gelu_new: bool = True) -> List[str]:
    """A HF ``GPT2LMHeadModel`` state dict into the port's
    ``GPTForCausalLM`` (head tied). HF GPT-2 uses the tanh-approximate
    gelu, so the model must be built with ``gelu_approximate=True``
    unless ``expect_gelu_new=False`` (a checkpoint whose config says
    ``activation_function="gelu"``)."""
    if expect_gelu_new and not model.config.gelu_approximate:
        raise ValueError(
            "HF gpt2 checkpoints use gelu_new (tanh approximation); build "
            "the model with GPTConfig(gelu_approximate=True), or pass "
            "expect_gelu_new=False if the source config used exact gelu")
    sd = _SD(state_dict)
    gpt = model.gpt
    _set(gpt.embeddings.weight, sd.take("transformer.wte.weight"), "wte")
    _set(gpt.position_embeddings.weight, sd.take("transformer.wpe.weight"),
         "wpe")
    for i, layer in enumerate(gpt.layers):
        p = f"transformer.h.{i}."
        for norm, src in ((layer.ln1, "ln_1"), (layer.ln2, "ln_2")):
            _set(norm.weight, sd.take(p + src + ".weight"), p + src + ".w")
            _set(norm.bias, sd.take(p + src + ".bias"), p + src + ".b")
        for lin, src in ((layer.attn.qkv_proj, "attn.c_attn"),
                         (layer.attn.out_proj, "attn.c_proj"),
                         (layer.mlp.fc1, "mlp.c_fc"),
                         (layer.mlp.fc2, "mlp.c_proj")):
            # Conv1D [in, out] -> torch Linear [out, in]
            _set(lin.weight, sd.take(p + src + ".weight").T, p + src + ".w")
            _set(lin.bias, sd.take(p + src + ".bias"), p + src + ".b")
    _set(gpt.ln_f.weight, sd.take("transformer.ln_f.weight"), "ln_f.w")
    _set(gpt.ln_f.bias, sd.take("transformer.ln_f.bias"), "ln_f.b")
    if "lm_head.weight" in sd.d:
        _assert_tied(sd.take("lm_head.weight"),
                     _np(sd.d["transformer.wte.weight"]))
    return sd.finish()


def load_hf_bert(model, state_dict: Dict,
                 layer_norm_eps: float = 1e-12) -> List[str]:
    """A HF ``BertModel`` state dict (or the ``bert.`` part of a
    ``BertFor*`` dump; head keys are ignored) into the port's
    ``BertModel``. ``layer_norm_eps`` is the HF config's, set on every
    LayerNorm."""
    sd = _SD(state_dict)
    emb = model.embeddings

    def tk(k):
        return sd.take(k if k in sd.d else "bert." + k)

    _set(emb.word_embeddings.weight,
         tk("embeddings.word_embeddings.weight"), "word_emb")
    _set(emb.position_embeddings.weight,
         tk("embeddings.position_embeddings.weight"), "pos_emb")
    _set(emb.token_type_embeddings.weight,
         tk("embeddings.token_type_embeddings.weight"), "type_emb")
    _set(emb.layer_norm.weight, tk("embeddings.LayerNorm.weight"), "emb_ln.w")
    _set(emb.layer_norm.bias, tk("embeddings.LayerNorm.bias"), "emb_ln.b")
    emb.layer_norm._epsilon = layer_norm_eps
    for i, layer in enumerate(model.encoder.layers):
        p = f"encoder.layer.{i}."

        def lin(dst, src, tag):
            _set(dst.weight, tk(p + src + ".weight").T, p + tag + ".w")
            _set(dst.bias, tk(p + src + ".bias"), p + tag + ".b")

        lin(layer.self_attn.q_proj, "attention.self.query", "q")
        lin(layer.self_attn.k_proj, "attention.self.key", "k")
        lin(layer.self_attn.v_proj, "attention.self.value", "v")
        lin(layer.self_attn.out_proj, "attention.output.dense", "attn_out")
        _set(layer.norm1.weight,
             tk(p + "attention.output.LayerNorm.weight"), p + "attn_ln.w")
        _set(layer.norm1.bias,
             tk(p + "attention.output.LayerNorm.bias"), p + "attn_ln.b")
        lin(layer.linear1, "intermediate.dense", "fc1")
        lin(layer.linear2, "output.dense", "fc2")
        _set(layer.norm2.weight, tk(p + "output.LayerNorm.weight"),
             p + "ffn_ln.w")
        _set(layer.norm2.bias, tk(p + "output.LayerNorm.bias"),
             p + "ffn_ln.b")
        layer.norm1._epsilon = layer_norm_eps
        layer.norm2._epsilon = layer_norm_eps
    if getattr(model, "pooler", None) is not None \
            and ("pooler.dense.weight" in sd.d
                 or "bert.pooler.dense.weight" in sd.d):
        _set(model.pooler.weight, tk("pooler.dense.weight").T, "pooler.w")
        _set(model.pooler.bias, tk("pooler.dense.bias"), "pooler.b")
    return sd.finish(ignore_substrings=("position_ids", "cls.",
                                        "classifier."))
