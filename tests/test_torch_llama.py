"""paddle_tpu_torch.models.llama against the JAX package's Llama.

The JAX ``llama_tiny`` (GQA: 4 query heads over 2 kv heads) is built
from its own seed; its ``state_dict`` is carried across with
``load_reference_state_dict``, and one mixed paged step (decode rows and
a prompt chunk, as the serving engine's unified step lays them out) runs
through both packages' ``forward_paged`` on the same numpy pools.

Tolerance: atol = rtol = 1e-5 in f32. Both packages run the same f32
math (RoPE from the same f32 tables, RMSNorm's formula, SwiGLU, masked
f32 softmax); the differences are summation orders of XLA's CPU matmuls
against torch's over two layers, a few ulps of O(1) activations.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)

ATOL = RTOL = 1e-5
WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    ref = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(tm, ref)
    return jm, tm, ref


def test_state_dict_round_trip(models):
    """Every key is carried; Linear weights arrive transposed, the rest
    as they are."""
    _jm, tm, ref = models
    params = dict(tm.named_parameters())
    assert set(params) == set(ref)
    for key, p in params.items():
        src = ref[key]
        want = src.T if key.endswith("proj.weight") or key == "lm_head.weight" \
            else src
        np.testing.assert_array_equal(p.detach().numpy(), want)
    # k_proj is [in, out] = [64, 32] in the JAX package, [32, 64] here
    assert ref["llama.layers.0.self_attn.k_proj.weight"].shape == (64, 32)
    assert params["llama.layers.0.self_attn.k_proj.weight"].shape == (32, 64)


def test_state_dict_load_is_strict(models):
    _jm, _tm, ref = models
    fresh = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    missing = {k: v for k, v in ref.items() if k != "llama.norm.weight"}
    with pytest.raises(KeyError):
        load_reference_state_dict(fresh, missing)
    extra = dict(ref, **{"llama.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        load_reference_state_dict(fresh, extra)
    bad = dict(ref)
    bad["llama.layers.1.mlp.up_proj.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        load_reference_state_dict(fresh, bad)


def test_init_is_seeded_and_scaled():
    """Parameters come from the explicit generator: the same seed gives
    the same weights, norms start at 1, output projections are narrower."""
    a = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu", seed=3)
    b = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu", seed=3)
    for (ka, pa), (_kb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), ka
    layer = a.llama.layers[0]
    assert torch.equal(layer.input_layernorm.weight, torch.ones(64))
    assert layer.self_attn.q_proj.weight.std() > 1.5 * \
        layer.self_attn.o_proj.weight.std()


def _mixed_step():
    """Rows of one unified step: slot A decodes at position 12, slot B
    feeds a 5-token chunk at positions 7..11, slot C decodes at 0. Each
    slot owns distinct pages; positions before each row are pre-filled
    KV history."""
    rng = np.random.default_rng(11)
    page, pages, width, nkv, hd = 4, 16, 4, 2, 16
    slot_bt = np.array([[1, 2, 3, 4], [5, 6, 7, 0], [8, 0, 0, 0]], np.int32)
    q_lens, starts = [1, 5, 1], [12, 7, 0]
    bt = np.concatenate([np.repeat(slot_bt[i:i + 1], n, axis=0)
                         for i, n in enumerate(q_lens)])
    pos = np.concatenate([np.arange(s, s + n)
                          for s, n in zip(starts, q_lens)]).astype(np.int32)
    ids = rng.integers(0, 128, pos.size).astype(np.int32)
    pools = [(rng.standard_normal((pages, page, nkv, hd)).astype(np.float32),
              rng.standard_normal((pages, page, nkv, hd)).astype(np.float32))
             for _ in range(2)]
    return ids, pos, bt, pools


def test_forward_paged_mixed_rows_match_jax(models):
    jm, tm, _ref = models
    ids, pos, bt, pools = _mixed_step()
    jh, jcaches = jm.llama.forward_paged(
        paddle.to_tensor(ids[:, None]), paddle.to_tensor(pos),
        paddle.to_tensor(bt),
        [(paddle.to_tensor(k), paddle.to_tensor(v)) for k, v in pools])
    jh = np.asarray(jh.numpy()).reshape(ids.size, -1)
    jlogits = np.asarray(jm.logits(paddle.to_tensor(jh)).numpy())

    tcaches = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
               for k, v in pools]
    with torch.no_grad():
        th = tm.llama.forward_paged(torch.from_numpy(ids),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(bt), tcaches)
        tlogits = tm.logits(th)
    np.testing.assert_allclose(th.numpy(), jh, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, atol=ATOL,
                               rtol=RTOL)
    # the pools this step wrote (page 0 is nobody's: skip it)
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jk.numpy())[1:],
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tv.numpy()[1:], np.asarray(jv.numpy())[1:],
                                   atol=ATOL, rtol=RTOL)
    # and they did write: slot B's chunk landed in its pages
    assert not np.allclose(tcaches[0][0].numpy()[6], pools[0][0][6])


def test_bf16_paged_step_follows_jax_dtypes():
    """The O2-decorated bf16 model, one mixed paged step over bf16 pools.
    In the JAX package RMSNorm's f32 weight makes the normed input f32,
    the f32 RoPE tables keep q and k f32, the paged kernel returns q's
    dtype and a linear promotes an f32 input over bf16 weights: the
    hidden state is f32, and so must it be here. Only the KV written to
    the pages rounds to bf16, in both alike. Tolerance atol = rtol = 1e-5,
    as in f32 (measured: 6e-7)."""
    import ml_dtypes

    from paddle_tpu import amp as jamp
    from paddle_tpu_torch.models.convert import _to_torch

    paddle.seed(0)
    jm = jamp.decorate(JaxLlama(jax_llama_tiny(**WIDTHS)), level="O2",
                       dtype="bfloat16")
    ref = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu",
                          dtype=torch.bfloat16)
    load_reference_state_dict(tm, ref)
    for n, p in tm.named_parameters():  # decorate's rule: norms stay f32
        assert p.dtype == (torch.float32 if "norm" in n else torch.bfloat16)
        assert ref[n].dtype == (np.float32 if "norm" in n
                                else ml_dtypes.bfloat16)
    ids, pos, bt, pools = _mixed_step()
    pools = [(k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16))
             for k, v in pools]
    jh, jcaches = jm.llama.forward_paged(
        paddle.to_tensor(ids[:, None]), paddle.to_tensor(pos),
        paddle.to_tensor(bt),
        [(paddle.to_tensor(k), paddle.to_tensor(v)) for k, v in pools])
    tcaches = [(_to_torch(k), _to_torch(v)) for k, v in pools]
    with torch.no_grad():
        th = tm.llama.forward_paged(torch.from_numpy(ids),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(bt), tcaches)
    assert str(jh.dtype) == "float32" and th.dtype == torch.float32
    jh = np.asarray(jh.numpy()).reshape(ids.size, -1)
    np.testing.assert_allclose(th.numpy(), jh, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tm.logits(th).detach().numpy(),
        np.asarray(jm.logits(paddle.to_tensor(jh)).numpy()),
        atol=ATOL, rtol=RTOL)
    # the written pages: the same bf16 values, but for a k or v whose f32
    # value lies within an ulp or two of a bf16 rounding midpoint, which
    # may round either way (one bf16 ulp, rtol 2^-7)
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        assert tk.dtype == tv.dtype == torch.bfloat16
        for t, j in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(
                t.float().numpy()[1:],
                np.asarray(j.numpy())[1:].astype(np.float32),
                rtol=2.0 ** -7, atol=0)
