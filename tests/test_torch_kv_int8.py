"""The port's int8 KV pages against the JAX package's.

``quantize_kv``/``dequantize_kv`` must equal the JAX helpers bit for bit
(f32 division and clamp in both, round half to even in both). The paged
forward's quantizing write must store the same codes and scales as the
JAX model's. The int8-page engine's streams must be token-identical to
the JAX int8 engine's, prefix cache and drafts included; a copy-on-write
copies the scale rows with the codes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.quantization import observers as jobs
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import page_bytes as jax_page_bytes
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.quantization import (dequantize_kv, kv_absmax_scales,
                                           quantize_kv)
from paddle_tpu_torch.serving import (PagedKVCachePool, ServingEngine,
                                      normalize_kv_dtype, page_bytes)

WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)


def _slabs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 4, 32)) * 3).astype(np.float32)
    x[0] = 0.0                                    # the scale floor
    x[1] = 1e-12                                  # under the floor
    x[2, :, :] = np.arange(32, dtype=np.float32) - 15.5  # .5 ties
    x[3, :, 0] = 127.0                            # exact grid points
    x[4] *= 1e6
    return x


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_quantize_kv_bit_identical(dtype):
    x = _slabs()
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    q, s = quantize_kv(tx)
    jq, js = jobs.quantize_kv(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(kv_absmax_scales(tx).numpy(),
                                  np.asarray(jobs.kv_absmax_scales(jx)))
    np.testing.assert_array_equal(dequantize_kv(q, s).numpy(),
                                  np.asarray(jobs.dequantize_kv(jq, js)))
    assert int(q.abs().max()) <= 127


def test_int8_page_sizing_matches_jax():
    assert normalize_kv_dtype("int8") == torch.int8
    for kv in ("int8", "bf16", "f32"):
        assert page_bytes(16, 2, 64, 3, kv_dtype=kv) == \
            jax_page_bytes(16, 2, 64, 3, kv_dtype=kv)
    # Llama-0.76B: 12 layers, 16 kv heads of 128, pages of 16
    assert page_bytes(16, 16, 128, 12, kv_dtype="int8") == \
        2 * 12 * 16 * 16 * (128 + 4)
    pool = PagedKVCachePool(2, 5, 4, 2, 8, dtype="int8", device="cpu")
    caches = pool.layer_caches()
    assert len(caches) == 2 and len(caches[0]) == 4
    assert caches[0][2].shape == (5, 4, 2) and caches[0][2].dtype == \
        torch.float32
    assert pool.device_bytes() == 5 * page_bytes(4, 2, 8, 2, "int8")


def test_cow_copies_scale_rows():
    pool = PagedKVCachePool(2, 6, 4, 2, 8, dtype="int8", device="cpu")
    pool.allocate("a", 6)
    page = pool.block_table("a")[1]
    gen = torch.Generator().manual_seed(1)
    for t in pool.k_pools + pool.v_pools:
        t[page] = torch.randint(-127, 128, (4, 2, 8), generator=gen,
                                dtype=torch.int8)
    for t in pool.k_scales + pool.v_scales:
        t[page] = torch.rand((4, 2), generator=gen) + 0.01
    every = pool.k_pools + pool.v_pools + pool.k_scales + pool.v_scales
    before = [t[page].clone() for t in every]
    pool.fork("a", "b")
    pool.extend("b", 7)  # slot 6 lies in the shared page: copied first
    fresh = pool.block_table("b")[1]
    assert fresh != page
    for t, b in zip(every, before):
        assert torch.equal(t[fresh], b) and torch.equal(t[page], b)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def test_quantizing_write_matches_jax(models):
    """One mixed paged step over int8 pools: the codes and scales each
    layer writes equal the JAX model's (the hidden states agree to f32
    rounding, so the quantizer sees the same k and v)."""
    jm, tm = models
    rng = np.random.default_rng(3)
    pages, page, nkv, hd = 9, 4, 2, 16
    bt_slot = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    pos = np.concatenate([[9], np.arange(2, 10)]).astype(np.int32)
    bt = np.concatenate([bt_slot[:1], np.repeat(bt_slot[1:], 8, 0)])
    ids = rng.integers(0, 128, pos.size).astype(np.int32)
    pools = []
    for _ in range(2):
        k = rng.integers(-127, 128, (pages, page, nkv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (pages, page, nkv, hd)).astype(np.int8)
        ks = (rng.random((pages, page, nkv)) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.random((pages, page, nkv)) * 0.02 + 1e-3).astype(np.float32)
        pools.append((k, v, ks, vs))
    _jh, jcaches = jm.llama.forward_paged(
        paddle.to_tensor(ids[:, None]), paddle.to_tensor(pos),
        paddle.to_tensor(bt), [tuple(paddle.to_tensor(a) for a in c)
                               for c in pools])
    tcaches = [tuple(torch.from_numpy(a.copy()) for a in c) for c in pools]
    with torch.no_grad():
        tm.llama.forward_paged(torch.from_numpy(ids), torch.from_numpy(pos),
                               torch.from_numpy(bt), tcaches)
    for jc, tc in zip(jcaches, tcaches):
        for j, t in zip(jc, tc):
            j = np.asarray(j.numpy())[1:]
            t = t.numpy()[1:]
            if t.dtype == np.int8:  # a code may sit at a rounding tie
                assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
                assert (t != j).mean() < 1e-3
            else:
                np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)
    written = (tcaches[0][0][4:7] != torch.from_numpy(pools[0][0][4:7]))
    assert written.any()


def _int8_work(engine, temperature):
    rng = np.random.RandomState(8)
    shared = rng.randint(0, 128, 9)
    loop = np.tile(rng.randint(0, 128, 2), 4)
    rids = [engine.add_request(np.concatenate([shared, loop]),
                               max_new_tokens=9, temperature=temperature,
                               seed=1)]
    engine.step()  # 16 of its 17 prompt tokens
    engine.step()  # the last one: its full pages enter the prefix cache
    rids += [engine.add_request(
        np.concatenate([shared, rng.randint(0, 128, n)]), max_new_tokens=7,
        temperature=temperature, seed=2 + n) for n in (2, 5)]
    out = engine.run()
    return [out[r].token_ids for r in rids]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_int8_streams_match_jax(models, temperature):
    """Both engines on int8 pages with the prefix cache (the default) and
    two-token drafts: the streams, prefix hits and draft counts agree."""
    jm, tm = models
    jeng = JaxEngine(jm, page_size=4, max_batch_slots=3, token_budget=16,
                     kv_dtype=jnp.int8, spec_k=2)
    teng = ServingEngine(tm, page_size=4, max_batch_slots=3, token_budget=16,
                         kv_dtype="int8", spec_k=2, device="cpu")
    assert teng.pool.quantized and teng.pool.k_pools[0].dtype == torch.int8
    assert _int8_work(teng, temperature) == _int8_work(jeng, temperature)
    assert teng.stats["prefix_hit_tokens"] == \
        jeng.prefix_cache._m_saved.value == 2 * 8
    assert (teng.stats["spec_drafted"], teng.stats["spec_accepted"]) == \
        (jeng._m_spec_drafted.value, jeng._m_spec_accepted.value)
    assert teng.pool.used_pages == 0
    # the served pages hold codes and the scales they were written with
    assert bool((teng.pool.k_scales[0][1:] > 0).any())
