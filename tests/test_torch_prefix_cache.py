"""The port's refcounted pool and radix prefix cache against the JAX ones.

Allocator traffic through both packages' pools (adoption of cached
prefix pages, fork, copy-on-write, truncate, eviction under pressure,
admission accounting with cached pages) must give the same block tables,
refcounts, free lists and lengths. Both engines serve shared-prefix
traffic with the prefix cache on (the JAX engine's default, now the
port's too): the streams must be token-identical and the prompt tokens
the cache covered equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import FCFSScheduler as JaxScheduler
from paddle_tpu.serving import PagedKVCachePool as JaxPool
from paddle_tpu.serving import PrefixCache as JaxPrefixCache
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.serving import (FCFSScheduler, PagedKVCachePool,
                                      PrefixCache, Request, ServingEngine)

WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
PREFIX = np.random.RandomState(3).randint(0, 128, 10)


def _snap(pool, cache, seqs):
    return ({s: pool.block_table(s) for s in seqs if pool.has_seq(s)},
            {s: pool.seq_len(s) for s in seqs if pool.has_seq(s)},
            pool._ref.tolist(), list(pool._free), pool.used_pages,
            pool.peak_used, len(cache), cache.reclaimable_pages())


def _pool_ops(pool, cache_cls):
    """A prompt's pages cached, adopted by a second sequence, a fork
    diverging into a shared tail (copy-on-write), a draft burst rolled
    back, then pressure that evicts the cache's pages LRU-first."""
    cache = cache_cls(pool)
    seqs = ["a", "b", "c", "d", "e"]
    seen = []
    pool.allocate("a", 0, max_total_tokens=16)
    pool.extend_write("a", 0, 10)
    seen.append(cache.insert(np.arange(10), 10, pool.block_table("a")) != [])
    seen.append((cache.probe(np.arange(12)), cache.probe(np.arange(8)),
                 cache.probe(np.arange(9)), pool.prefix_match_len([5, 6])))
    seen.append(_snap(pool, cache, seqs))
    m, pages, _ = cache.match(np.concatenate([np.arange(8), [99, 98, 97]]))
    seen.append((m, pages))
    seen.append((pool.can_admit(20, cached_pages=m // 4),
                 pool.can_admit(20), pool.can_admit(30, 1, 2, 1)))
    pool.allocate("b", m, max_total_tokens=14, prefix_pages=pages,
                  prefix_tokens=m)
    pool.extend_write("b", m, 11)
    seen.append(_snap(pool, cache, seqs))
    pool.fork("a", "c", max_total_tokens=16)
    pool.extend("c", 11)             # into a's shared tail page: copied
    pool.extend_write("a", 10, 15)   # a's tail is its own again
    pool.truncate("a", 12)           # three "drafts" rejected
    seen.append(_snap(pool, cache, seqs))
    try:
        pool.truncate("a", 13)
    except ValueError:
        seen.append("grow refused")
    pool.free("a")
    pool.free("b")
    seen.append(_snap(pool, cache, seqs))
    pool.allocate("d", 20, max_total_tokens=24)  # evicts cached pages
    seen.append(_snap(pool, cache, seqs))
    try:
        pool.allocate("e", 24)
    except RuntimeError:
        seen.append("exhausted")
    pool.free("c")
    pool.free("d")
    seen.append(cache.clear())
    seen.append(_snap(pool, cache, seqs))
    return seen


def test_pool_refcounts_cow_and_eviction_match_jax():
    got = _pool_ops(PagedKVCachePool(1, 10, 4, 2, 8, device="cpu"),
                    PrefixCache)
    want = _pool_ops(JaxPool(1, 10, 4, 2, 8), JaxPrefixCache)
    assert got == want
    assert "exhausted" in got and "grow refused" in got
    assert sorted(got[-1][3]) == list(range(1, 10))  # every page free


def test_cow_copies_page_bytes_on_the_device():
    pool = PagedKVCachePool(2, 6, 4, 2, 8, device="cpu")
    pool.allocate("a", 6)
    page = pool.block_table("a")[1]
    for t in pool.k_pools + pool.v_pools:
        t[page] = torch.randn(4, 2, 8)
    before = [t[page].clone() for t in pool.k_pools + pool.v_pools]
    pool.fork("a", "b")
    pool.extend("b", 7)
    fresh = pool.block_table("b")[1]
    assert fresh != page and pool.cow_copies == 1
    for t, b in zip(pool.k_pools + pool.v_pools, before):
        assert torch.equal(t[fresh], b) and torch.equal(t[page], b)


def _sched_ops(sched, pool, cache_cls, req_cls):
    """Admission discounts the pages a prompt would adopt, and takes them
    off the reclaimable side for later batch-mates."""
    cache = cache_cls(pool)
    pool.allocate("x", 12, max_total_tokens=12)
    cache.insert(np.arange(12), 12, pool.block_table("x"))
    pool.free("x")
    reqs = [req_cls(prompt=np.arange(14), max_new_tokens=10),
            req_cls(prompt=np.arange(13), max_new_tokens=2),
            req_cls(prompt=np.arange(50, 58), max_new_tokens=8,
                    prefix_cache=False)]
    for r in reqs:
        sched.add(r)
    # by identity: dataclass equality compares prompt arrays
    first = [next(i for i, q in enumerate(reqs) if q is r)
             for r in sched.admit(3, pool)]
    return first, sched.queue_depth, len(pool._free), \
        cache.reclaimable_pages()


def test_prefix_aware_admission_matches_jax():
    got = _sched_ops(FCFSScheduler(4, 16),
                     PagedKVCachePool(1, 11, 4, 2, 8, device="cpu"),
                     PrefixCache, Request)
    want = _sched_ops(JaxScheduler(4, 16), JaxPool(1, 11, 4, 2, 8),
                      JaxPrefixCache, JaxRequest)
    assert got == want
    assert got[0] == [0, 1]  # the third would need pages the cache pins


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _shared_prefix_work(engine, temperature):
    """One request warms the cache, then four share its 10-token prefix
    (two full pages of 4): two admitted together, one whose prompt is
    the prefix itself (capped one token short: still two pages), one
    that opts out, and one more after the rest retire."""
    rng = np.random.RandomState(5)
    first = np.concatenate([PREFIX, rng.randint(0, 128, 4)])
    rids = [engine.add_request(first, max_new_tokens=6,
                               temperature=temperature, seed=1)]
    out = engine.run()
    for i, extra in enumerate((3, 6)):
        rids.append(engine.add_request(
            np.concatenate([PREFIX, rng.randint(0, 128, extra)]),
            max_new_tokens=7, temperature=temperature, seed=2 + i))
    rids.append(engine.add_request(PREFIX, max_new_tokens=5,
                                   temperature=temperature, seed=4))
    rids.append(engine.add_request(
        np.concatenate([PREFIX, [1, 2]]), max_new_tokens=4,
        temperature=temperature, seed=5, prefix_cache=False))
    out.update(engine.run())
    rids.append(engine.add_request(np.concatenate([PREFIX[:8], [7]]),
                                   max_new_tokens=4,
                                   temperature=temperature, seed=6))
    out.update(engine.run())
    return [out[r].token_ids for r in rids]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_shared_prefix_streams_match_jax(models, temperature):
    jm, tm = models
    jeng = JaxEngine(jm, page_size=4, max_batch_slots=3, token_budget=16)
    teng = ServingEngine(tm, page_size=4, max_batch_slots=3, token_budget=16,
                         device="cpu")
    assert teng.prefix_cache is not None and jeng.prefix_cache is not None
    want = _shared_prefix_work(jeng, temperature)
    got = _shared_prefix_work(teng, temperature)
    assert got == want
    saved = jeng.prefix_cache._m_saved.value
    assert teng.stats["prefix_hit_tokens"] == saved == 4 * 8
    assert teng.pool.used_pages == 0 == jeng.pool.used_pages
    assert teng.pool.peak_used == jeng.pool.peak_used
    assert sorted(teng.pool._free) == sorted(jeng.pool._free)
    assert len(teng.prefix_cache) == len(jeng.prefix_cache) > 0
    teng.prefix_cache.clear()
    assert len(teng.pool._free) == teng.pool.usable_pages


def test_prefix_cache_off_streams_equal_on(models):
    """Prefix hits are a cache length: the streams are the same with the
    cache off, which prefills every prompt in full."""
    _jm, tm = models
    on = ServingEngine(tm, page_size=4, max_batch_slots=3, token_budget=16,
                       device="cpu")
    off = ServingEngine(tm, page_size=4, max_batch_slots=3, token_budget=16,
                        prefix_cache=False, device="cpu")
    assert _shared_prefix_work(on, 0.8) == _shared_prefix_work(off, 0.8)
    assert off.prefix_cache is None and off.stats["prefix_hit_tokens"] == 0
    assert on.stats["prefix_hit_tokens"] > 0
