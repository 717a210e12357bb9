"""The port's host page tier against the JAX package's.

``offload_seq`` moves a sequence's exclusively owned written pages (and
an int8 pool's scale rows) to pinned host memory and releases them with
the unwritten tail reservation; ``prefetch_seq`` writes them back into
fresh pages of the same page tensors. The round trip must be bit-exact
in f32, bf16 and int8, and the page tensors keep their storage. The
pool's bookkeeping (tables, free lists, refcounts, ``spare_pages``,
``can_prefetch``, ``prefetch_cost``, admission) must equal the JAX
pool's after the same operations, and writes or forks of an offloaded
sequence raise in both. In the engines, pressure parks the cold
low-priority stream for an urgent one and restores it before its next
step: the streams must equal the JAX engine's and an uncontended run's,
with no late prefetch.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import PagedKVCachePool as JaxPool
from paddle_tpu.serving import PrefixCache as JaxPrefixCache
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.serving import (PagedKVCachePool, PrefixCache,
                                      ServingEngine)
from torch_suite import one_torch_thread  # noqa: F401

WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)


def _pool(pages=9, dtype="int8", layers=2):
    return PagedKVCachePool(num_layers=layers, num_pages=pages, page_size=4,
                            n_kv_heads=2, head_dim=8, dtype=dtype,
                            device="cpu")


def _fill(pool, seed):
    """Random bytes in every page (and scale row) of every layer."""
    gen = torch.Generator().manual_seed(seed)
    for _name, tensors in pool._page_tensors():
        for t in tensors:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))


def _pages(pool, table):
    idx = torch.tensor(table)
    return {name: [t[idx].clone() for t in tensors]
            for name, tensors in pool._page_tensors()}


@pytest.mark.parametrize("dtype", ["float32", "bf16", "int8"])
def test_offload_prefetch_round_trip_bit_exact(dtype):
    pool = _pool(dtype=dtype)
    _fill(pool, 4)
    ptrs = [t.data_ptr() for _n, ts in pool._page_tensors() for t in ts]
    pool.allocate("a", 7, max_total_tokens=12)
    pool.allocate("b", 3)
    before = _pages(pool, pool.block_table("a"))
    used = pool.used_pages
    assert pool.offload_seq("a") == 2 and pool.offloaded_pages("a") == 2
    assert pool.used_pages == used - 2 and pool.offloaded_pages() == 2
    assert pool.block_table("a") == [0, 0]
    assert pool.offload_seq("a") == 0  # parked already
    # the freed pages serve someone else, whose writes land in them
    pool.allocate("c", 8)
    _fill(pool, 5)
    assert pool.prefetch_seq("a") == 2 and pool.offloaded_pages("a") == 0
    after = _pages(pool, pool.block_table("a"))
    for name in before:
        for b, a in zip(before[name], after[name]):
            assert torch.equal(a, b), name
    assert [t.data_ptr() for _n, ts in pool._page_tensors()
            for t in ts] == ptrs
    assert sorted(name for name in before) == (
        ["k", "ks", "v", "vs"] if dtype == "int8" else ["k", "v"])
    for s in ("a", "b", "c"):
        pool.free(s)
    assert pool.used_pages == 0 and pool.offloaded_pages() == 0


def _tier_ops(pool, cache_cls):
    """Park a sequence whose first page the prefix cache shares, admit a
    head in its place, then bring it back; every probe on the way."""
    cache = cache_cls(pool)
    seen = []

    def snap():
        seen.append(({s: pool.block_table(s) for s in ("v", "h", "x")
                      if pool.has_seq(s)}, list(pool._free),
                     pool._ref.tolist(), pool.used_pages, pool.spare_pages(),
                     pool.offloaded_pages(), pool.offloaded_pages("v"),
                     pool.can_prefetch("v") if pool.has_seq("v") else None,
                     pool.prefetch_cost("v") if pool.has_seq("v") else None,
                     pool.can_admit(12), pool.can_admit(16)))

    pool.allocate("v", 10, max_total_tokens=20)      # 3 written, 2 tail
    cache.insert(np.arange(10), 10, pool.block_table("v"))  # 2 shared
    pool.allocate("x", 3, max_total_tokens=4)
    snap()
    seen.append(pool.offload_seq("v"))                # only its own page
    snap()
    pool.allocate("h", 12)
    snap()
    for op in (lambda: pool.extend("v", 11),
               lambda: pool.extend_write("v", 10, 12),
               lambda: pool.fork("v", "w")):
        try:
            op()
        except RuntimeError as e:
            seen.append("offloaded" in str(e))
    pool.free("h")
    snap()
    seen.append(pool.prefetch_seq("v"))
    snap()
    seen.append(pool.prefetch_seq("v"))
    pool.free("x")
    pool.free("v")
    cache.clear()
    snap()
    return seen


def test_tier_bookkeeping_matches_jax():
    got = _tier_ops(_pool(pages=10), PrefixCache)
    want = _tier_ops(JaxPool(num_layers=2, num_pages=10, page_size=4,
                             n_kv_heads=2, head_dim=8, dtype="int8"),
                     JaxPrefixCache)
    assert got == want
    assert got[1] == 1 and got[4:7] == [True, True, True]


def test_offloaded_sequence_refuses_writes_and_frees_cleanly():
    pool = _pool()
    pool.allocate("a", 5)
    pool.offload_seq("a")
    with pytest.raises(RuntimeError, match="offloaded"):
        pool.extend("a", 6)
    with pytest.raises(RuntimeError, match="offloaded"):
        pool.fork("a", "b")
    pool.free("a")  # drops its host copies, releases nothing twice
    assert pool.offloaded_pages() == 0 and pool.used_pages == 0
    assert pool._ref[0] == 0 and len(pool._free) == pool.usable_pages


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _pressure(eng, offloaded):
    """tests/test_kv_tiers.py's scenario: a low-priority stream decodes,
    an urgent request arrives that the pool cannot hold beside it."""
    lo = eng.add_request(np.arange(1, 9), max_new_tokens=10, priority=5)
    eng.step()
    eng.step()
    hi = eng.add_request(np.arange(2, 10), max_new_tokens=4, priority=0)
    outs, parked, overtook = {}, False, False
    for _ in range(60):
        for o in eng.step():
            outs[o.req_id] = o
        parked = parked or offloaded(eng, lo) > 0
        overtook = overtook or (hi in outs and lo not in outs)
        if not eng.has_work:
            break
    return outs[lo].token_ids, outs[hi].token_ids, parked, overtook


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_pressure_park_streams_match_jax_and_solo(models, kv_dtype):
    jm, tm = models
    kw = dict(page_size=4, max_batch_slots=3, num_pages=8,
              host_offload=True, kv_dtype=kv_dtype)
    jeng = JaxEngine(jm, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    want = _pressure(jeng, lambda e, r: e.pool.offloaded_pages(r))
    got = _pressure(teng, lambda e, r: e.pool.offloaded_pages(r))
    assert got == want
    assert got[2] and got[3], "the victim was never parked, or not overtaken"
    late = jeng._m_prefetch_late.value
    assert teng.stats["kv_prefetch_late_pages"] == late == 0
    assert teng.stats["parks"] == teng.stats["unparks"] > 0
    assert teng.stats["kv_offloaded_pages"] == \
        teng.stats["kv_prefetched_pages"] > 0
    assert teng.compile_counts() == jeng.compile_counts()
    assert teng.pool.used_pages == 0 and teng.pool.offloaded_pages() == 0
    solo = ServingEngine(tm, page_size=4, max_batch_slots=3,
                         kv_dtype=kv_dtype, device="cpu")
    rid = solo.add_request(np.arange(1, 9), max_new_tokens=10)
    assert solo.run()[rid].token_ids == got[0]


def test_park_unpark_public_api(models):
    jm, tm = models
    moved = {}
    for pkg, eng in (("jax", JaxEngine(jm, page_size=4, max_batch_slots=2,
                                       host_offload=True, kv_dtype="int8")),
                     ("torch", ServingEngine(tm, page_size=4,
                                             max_batch_slots=2,
                                             host_offload=True,
                                             kv_dtype="int8",
                                             device="cpu"))):
        rid = eng.add_request(np.arange(1, 9), max_new_tokens=6)
        eng.step()
        eng.step()
        n = eng.park_request(rid)
        assert n > 0 and eng.pool.offloaded_pages(rid) == n
        assert eng.park_request(rid) == 0  # idempotent
        eng.step()  # the parked slot has no rows, and stays parked
        assert eng.pool.offloaded_pages(rid) == n
        assert eng.unpark_request(rid) == n
        assert eng.unpark_request(rid) == 0
        moved[pkg] = (n, eng.run()[rid].token_ids)
    assert moved["torch"] == moved["jax"]
    plain = ServingEngine(tm, page_size=4, max_batch_slots=2, device="cpu")
    rid = plain.add_request(np.arange(1, 5), max_new_tokens=2)
    plain.step()
    with pytest.raises(RuntimeError, match="host_offload"):
        plain.park_request(rid)
    with pytest.raises(RuntimeError, match="host_offload"):
        plain.unpark_request(rid)
    plain.run()
