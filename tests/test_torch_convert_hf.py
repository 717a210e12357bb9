"""paddle_tpu_torch.models.convert_hf against the JAX package's
``models/convert_hf.py``.

HF-named state dicts are built here from a numpy seed (nothing is
downloaded): Llama with GQA and an untied head (q and k rows in HF's
rotate-half layout), GPT-2 with ``Conv1D`` ``[in, out]`` weights and a
tied head, and BERT with a pooler and a classifier head to ignore. Each
dict is loaded into both packages' models, which then run on the same
ids: logits (hidden states for BERT) agree at f32 atol = rtol = 1e-5.
The refusals of the JAX package's ``tests/test_hf_convert.py:139-183``
(a shape mismatch, an untied head into a tied model, GPT-2 without
``gelu_approximate``) and leftover keys raise the same errors in both.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import models as JM
from torch_facade_common import on_cpu  # noqa: F401
from paddle_tpu_torch import models as TM
from paddle_tpu_torch.models.convert_hf import (load_hf_bert, load_hf_gpt2,
                                                load_hf_llama)

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _w(rng, *shape, scale=0.05):
    return (rng.standard_normal(shape) * scale).astype("f4")


def llama_dict(V=96, H=64, F=88, L=2, nh=4, nkv=2, seed=0, tied=False):
    rng = np.random.default_rng(seed)
    hd = H // nh
    d = {"model.embed_tokens.weight": _w(rng, V, H),
         "model.norm.weight": 1 + _w(rng, H)}
    for i in range(L):
        p = f"model.layers.{i}."
        d.update({p + "self_attn.q_proj.weight": _w(rng, nh * hd, H),
                  p + "self_attn.k_proj.weight": _w(rng, nkv * hd, H),
                  p + "self_attn.v_proj.weight": _w(rng, nkv * hd, H),
                  p + "self_attn.o_proj.weight": _w(rng, H, nh * hd),
                  p + "mlp.gate_proj.weight": _w(rng, F, H),
                  p + "mlp.up_proj.weight": _w(rng, F, H),
                  p + "mlp.down_proj.weight": _w(rng, H, F),
                  p + "input_layernorm.weight": 1 + _w(rng, H),
                  p + "post_attention_layernorm.weight": 1 + _w(rng, H),
                  p + "self_attn.rotary_emb.inv_freq": _w(rng, hd // 2)})
    d["lm_head.weight"] = (d["model.embed_tokens.weight"].copy() if tied
                           else _w(rng, V, H))
    return d


def gpt2_dict(V=96, H=64, L=2, P=32, seed=0):
    rng = np.random.default_rng(seed)
    d = {"transformer.wte.weight": _w(rng, V, H),
         "transformer.wpe.weight": _w(rng, P, H),
         "transformer.ln_f.weight": 1 + _w(rng, H),
         "transformer.ln_f.bias": _w(rng, H)}
    for i in range(L):
        p = f"transformer.h.{i}."
        d.update({p + "ln_1.weight": 1 + _w(rng, H),
                  p + "ln_1.bias": _w(rng, H),
                  p + "attn.c_attn.weight": _w(rng, H, 3 * H),
                  p + "attn.c_attn.bias": _w(rng, 3 * H),
                  p + "attn.c_proj.weight": _w(rng, H, H),
                  p + "attn.c_proj.bias": _w(rng, H),
                  p + "ln_2.weight": 1 + _w(rng, H),
                  p + "ln_2.bias": _w(rng, H),
                  p + "mlp.c_fc.weight": _w(rng, H, 4 * H),
                  p + "mlp.c_fc.bias": _w(rng, 4 * H),
                  p + "mlp.c_proj.weight": _w(rng, 4 * H, H),
                  p + "mlp.c_proj.bias": _w(rng, H),
                  p + "attn.bias": np.ones((1, 1, P, P), "f4")})
    d["lm_head.weight"] = d["transformer.wte.weight"].copy()
    return d


def bert_dict(V=120, H=32, F=64, L=2, P=32, seed=0, prefix="bert."):
    rng = np.random.default_rng(seed)
    d = {"embeddings.word_embeddings.weight": _w(rng, V, H),
         "embeddings.position_embeddings.weight": _w(rng, P, H),
         "embeddings.token_type_embeddings.weight": _w(rng, 2, H),
         "embeddings.LayerNorm.weight": 1 + _w(rng, H),
         "embeddings.LayerNorm.bias": _w(rng, H),
         "pooler.dense.weight": _w(rng, H, H),
         "pooler.dense.bias": _w(rng, H)}
    for i in range(L):
        p = f"encoder.layer.{i}."
        for name, o, n in (("attention.self.query", H, H),
                           ("attention.self.key", H, H),
                           ("attention.self.value", H, H),
                           ("attention.output.dense", H, H),
                           ("intermediate.dense", F, H),
                           ("output.dense", H, F)):
            d[p + name + ".weight"] = _w(rng, o, n)
            d[p + name + ".bias"] = _w(rng, o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            d[p + name + ".weight"] = 1 + _w(rng, H)
            d[p + name + ".bias"] = _w(rng, H)
    d = {prefix + k: v for k, v in d.items()}
    d.update({"classifier.weight": _w(rng, 2, H),
              "classifier.bias": _w(rng, 2)})
    return d


LLAMA = dict(vocab_size=96, hidden_size=64, intermediate_size=88,
             num_layers=2, num_heads=4, num_key_value_heads=2,
             max_position_embeddings=32, rms_norm_eps=1e-6,
             tie_word_embeddings=False)
GPT2 = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, layer_norm_epsilon=1e-5,
            gelu_approximate=True)
BERT = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=32,
            type_vocab_size=2, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0)


def _ids(hi, shape, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape)


def test_llama_logits_equal_the_jax_package():
    sd = llama_dict()
    jm = JM.LlamaForCausalLM(JM.LlamaConfig(**LLAMA))
    tm = TM.LlamaForCausalLM(TM.LlamaConfig(**LLAMA), device="cpu")
    used_j = JM.load_hf_llama(jm, sd)
    used_t = load_hf_llama(tm, {k: torch.from_numpy(v) for k, v in sd.items()})
    assert used_t == used_j and len(used_t) == 3 + 9 * 2
    ids = _ids(96, (2, 12))
    jm.eval()
    want = np.asarray(jm(pt.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the q rows were un-permuted: head 0's first pair is HF's rows 0, 8
    q = sd["model.layers.0.self_attn.q_proj.weight"]
    got_q = tm.llama.layers[0].self_attn.q_proj.weight.detach().numpy()
    np.testing.assert_array_equal(got_q[:2], q[[0, 8]])


def test_llama_generate_after_conversion_equals_the_jax_package():
    cfg = dict(LLAMA, num_key_value_heads=4)
    sd = llama_dict(nkv=4, seed=1)
    jm = JM.LlamaForCausalLM(JM.LlamaConfig(**cfg))
    tm = TM.LlamaForCausalLM(TM.LlamaConfig(**cfg), device="cpu")
    JM.load_hf_llama(jm, sd)
    load_hf_llama(tm, sd)
    ids = np.array([[5, 11, 42]])
    want = np.asarray(jm.generate(pt.to_tensor(ids), max_new_tokens=8,
                                  temperature=0.0).numpy())
    got = tm.generate(ids, max_new_tokens=8, temperature=0.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_gpt2_logits_equal_the_jax_package():
    sd = gpt2_dict()
    jm = JM.GPTForCausalLM(JM.GPTConfig(**GPT2, tie_word_embeddings=True))
    tm = TM.GPTForCausalLM(TM.GPTConfig(**GPT2), device="cpu")
    assert JM.load_hf_gpt2(jm, sd) == load_hf_gpt2(tm, sd)
    ids = _ids(96, (2, 10))
    jm.eval()
    want = np.asarray(jm(pt.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # Conv1D [in, out] arrives as the torch Linear's [out, in]
    np.testing.assert_array_equal(
        tm.gpt.layers[1].mlp.fc1.weight.detach().numpy(),
        sd["transformer.h.1.mlp.c_fc.weight"].T)


@pytest.mark.parametrize("prefix", ["", "bert."], ids=["bare", "head_dump"])
def test_bert_hidden_states_equal_the_jax_package(prefix):
    sd = bert_dict(prefix=prefix)
    if not prefix:
        sd.pop("classifier.weight"), sd.pop("classifier.bias")
    pt.seed(0)
    jm = JM.BertModel(JM.BertConfig(**BERT))
    tm = TM.BertModel(TM.BertConfig(**BERT))
    assert JM.load_hf_bert(jm, sd) == load_hf_bert(tm, sd)
    ids = _ids(120, (2, 9))
    jm.eval()
    tm.eval()
    js, jp = jm(pt.to_tensor(ids))
    ts, tp = tm(paddle.to_tensor(ids))
    for a, b in ((js, ts), (jp, tp)):
        np.testing.assert_allclose(np.asarray(b.numpy()),
                                   np.asarray(a.numpy()), rtol=TOL, atol=TOL)
    assert tm.encoder.layers[1].norm2._epsilon == 1e-12


def _both(fn):
    """``fn(models, loader)`` raises the same error type and message in
    both packages."""
    errs = []
    for mods, loaders in ((JM, JM), (TM, TM.convert_hf)):
        with pytest.raises((ValueError, KeyError)) as e:
            fn(mods, loaders)
        errs.append(e)
    assert errs[0].type is errs[1].type
    assert str(errs[0].value) == str(errs[1].value)
    return str(errs[1].value)


def _llama(mods, **kw):
    cfg = mods.LlamaConfig(**dict(LLAMA, **kw))
    return (mods.LlamaForCausalLM(cfg) if mods is JM
            else mods.LlamaForCausalLM(cfg, device="cpu"))


def test_shape_mismatch_raises_in_both():
    msg = _both(lambda m, ld: ld.load_hf_llama(_llama(m, hidden_size=32),
                                               llama_dict()))
    assert "embed_tokens: checkpoint shape (96, 64)" in msg


def test_untied_head_into_tied_model_raises_in_both():
    msg = _both(lambda m, ld: ld.load_hf_llama(
        _llama(m, tie_word_embeddings=True), llama_dict()))
    assert "untied" in msg
    # a head equal to the embedding loads
    load_hf_llama(_llama(TM, tie_word_embeddings=True), llama_dict(tied=True))


def test_gpt2_needs_gelu_new_in_both():
    def load(m, ld):
        cfg = m.GPTConfig(**dict(GPT2, gelu_approximate=False))
        model = (m.GPTForCausalLM(cfg) if m is JM
                 else m.GPTForCausalLM(cfg, device="cpu"))
        return ld.load_hf_gpt2(model, gpt2_dict())
    assert "gelu_new" in _both(load)


def test_leftover_and_missing_keys_raise_in_both():
    extra = dict(llama_dict(), **{"model.layers.9.mlp.up_proj.weight":
                                  np.zeros((2, 2), "f4")})
    assert "not consumed" in _both(
        lambda m, ld: ld.load_hf_llama(_llama(m), extra))
    short = llama_dict()
    del short["model.norm.weight"]
    assert "model.norm.weight" in _both(
        lambda m, ld: ld.load_hf_llama(_llama(m), short))
