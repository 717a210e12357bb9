"""paddle_tpu_torch.serving.ServingEngine against the JAX ServingEngine.

Both engines serve the same ``llama_tiny`` weights (GQA, the widths of
tests/test_serving.py), carried across from the JAX model's state_dict;
the port runs on the CPU (``device="cpu"``), where its attention is the
kernel's plain version. The JAX engine runs with its prefix cache off,
which the port does not have yet.

The contract is exact: a request's token stream is a pure function of
(prompt, seed, temperature) in both packages, so the streams must be
token-identical, whatever the token budget, the batch composition or
the admission time. Logits agree to a few f32 ulps (tests/
test_torch_llama.py); on these inputs no argmax or Gumbel-max draw sits
close enough to a tie for that to flip a token.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import FCFSScheduler as JaxScheduler
from paddle_tpu.serving import PagedKVCachePool as JaxPool
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.serving import (FCFSScheduler, PagedKVCachePool,
                                      Request, ServingEngine)
from torch_suite import one_torch_thread  # noqa: F401

WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
PROMPTS = [np.random.RandomState(7).randint(0, 128, (n,)) for n in (5, 9, 3)]
TEMP_SEEDS = [0, 7, 2**31]
TEMP_PROMPTS = [np.random.RandomState(9).randint(0, 128, (n,))
                for n in (6, 11, 2, 8)]


def _workload(engine, eos, temperature=0.0, seed=0):
    """Mixed lengths, one request stopping on eos mid-batch, and one
    admitted after the first step. Returns the three token streams."""
    r0 = engine.add_request(PROMPTS[0], max_new_tokens=8, eos_token_id=eos,
                            temperature=temperature, seed=seed)
    r1 = engine.add_request(PROMPTS[1], max_new_tokens=6,
                            temperature=temperature, seed=seed + 1)
    engine.step()
    r2 = engine.add_request(PROMPTS[2], max_new_tokens=5,
                            temperature=temperature, seed=seed + 2)
    outs = engine.run()
    return [outs[r].token_ids for r in (r0, r1, r2)], \
        [outs[r].finish_reason for r in (r0, r1, r2)]


def _temp_workload(engine, seed, temperature=0.8):
    rids = [engine.add_request(p, max_new_tokens=7, temperature=temperature,
                               seed=seed + 11 * i)
            for i, p in enumerate(TEMP_PROMPTS)]
    outs = engine.run()
    return [outs[r].token_ids for r in rids]


@pytest.fixture(scope="module")
def reference():
    """The JAX model, its weights in the port, and the JAX engine's
    streams (computed once; they do not depend on the token budget)."""
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    eng = JaxEngine(jm, page_size=4, max_batch_slots=2, prefix_cache=False)
    probe = eng.add_request(PROMPTS[0], max_new_tokens=3)
    eos = int(eng.run()[probe].token_ids[2])   # request 0 stops at token 3
    greedy = _workload(eng, eos)
    greedy_peak = eng.pool.peak_used     # the probe used fewer pages
    temp = {s: _temp_workload(eng, s) for s in TEMP_SEEDS}
    return {"tm": tm, "eos": eos, "greedy": greedy, "temp": temp,
            "greedy_peak": greedy_peak, "jax_engine": eng}


def _engine(tm, **kw):
    return ServingEngine(tm, page_size=4, max_batch_slots=2, device="cpu",
                         **kw)


def test_greedy_streams_identical(reference):
    eng = _engine(reference["tm"])
    streams, reasons = _workload(eng, reference["eos"])
    assert streams == reference["greedy"][0]
    assert reasons == reference["greedy"][1] == ["stop", "length", "length"]
    assert streams[0][-1] == reference["eos"] and len(streams[0]) == 3
    assert eng.pool.used_pages == 0
    assert eng.pool.peak_used == reference["greedy_peak"]


@pytest.mark.parametrize("budget", [1, 5, 16, 1024])
def test_streams_identical_across_token_budgets(reference, budget):
    """Chunk boundaries are data: budget 1 prefills a token per step,
    1024 a whole prompt, and the streams do not move."""
    eng = _engine(reference["tm"], token_budget=budget)
    streams, _ = _workload(eng, reference["eos"])
    assert streams == reference["greedy"][0]


@pytest.mark.parametrize("seed", TEMP_SEEDS)
def test_temperature_streams_identical(reference, seed):
    eng = _engine(reference["tm"], token_budget=5)
    got = _temp_workload(eng, seed)
    assert got == reference["temp"][seed]
    greedy = _temp_workload(_engine(reference["tm"]), seed, temperature=0.0)
    assert got != greedy  # the noise really was applied


def test_bf16_greedy_streams_identical(reference):
    """An O2-decorated bf16 model over bf16 pages (what the card serves):
    the port's engine and the JAX engine give the same greedy and
    temperature streams. Both keep the norms f32 and, from the first
    layer on, the activations f32 (tests/test_torch_llama.py holds the
    hidden state), so only the pages round to bf16, in both alike."""
    import jax.numpy as jnp

    from paddle_tpu import amp as jamp

    paddle.seed(0)
    jm = jamp.decorate(JaxLlama(jax_llama_tiny(**WIDTHS)), level="O2",
                       dtype="bfloat16")
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu",
                          dtype=torch.bfloat16)
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    jeng = JaxEngine(jm, page_size=4, max_batch_slots=2, prefix_cache=False,
                     kv_dtype=jnp.bfloat16)
    teng = _engine(tm, kv_dtype=torch.bfloat16)
    eos = reference["eos"]
    want = _workload(jeng, eos)
    assert _workload(teng, eos) == want
    assert _temp_workload(teng, 7) == _temp_workload(jeng, 7)
    assert teng.pool.k_pools[0].dtype == torch.bfloat16


def test_pool_drains_and_reuses_pages(reference):
    """Retired sequences' pages serve later requests: the high-water mark
    stays under the dense equivalent."""
    eng = _engine(reference["tm"])
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, 128, (6,)), 6) for _ in range(6)]
    for p, n in reqs:
        eng.add_request(p, max_new_tokens=n)
    outs = eng.run()
    assert len(outs) == 6 and all(o.n_gen == 6 for o in outs.values())
    dense_pages_equiv = sum(-(-(len(p) + n) // eng.page_size)
                            for p, n in reqs)
    assert eng.pool.peak_used < dense_pages_equiv
    assert eng.pool.peak_used <= 2 * 3  # 2 slots x 3 pages worst case
    assert eng.pool.used_pages == 0


def test_page_bytes_match_reference():
    """Sizing math: Llama-0.76B (12 layers, 16 kv heads of 128) costs
    96 KiB of bf16 KV per token, 1.5 MiB per page of 16 tokens."""
    from paddle_tpu.serving import page_bytes as jax_page_bytes
    from paddle_tpu_torch.serving import page_bytes

    assert page_bytes(16, 16, 128, 12, kv_dtype="bf16") == 16 * 96 * 1024
    for kv in ("bf16", "f32"):
        assert page_bytes(16, 2, 64, 3, kv_dtype=kv) == \
            jax_page_bytes(16, 2, 64, 3, kv_dtype=kv)


def test_engine_checks_requests():
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    eng = _engine(tm)
    with pytest.raises(ValueError):
        eng.add_request(np.arange(60), max_new_tokens=10)  # > 64 tokens
    small = ServingEngine(tm, page_size=4, num_pages=3, max_batch_slots=1,
                          device="cpu")
    with pytest.raises(ValueError):
        small.add_request(np.arange(10), max_new_tokens=2)  # 3 pages > 2


def test_engine_counts_plain_path_on_cpu(reference):
    """On CPU tensors every layer of every step takes the plain version:
    one plain call per layer per step, no kernel launch."""
    from paddle_tpu_torch.ops import paged_attention as tpa

    eng = _engine(reference["tm"])
    launches, plain = tpa.kernel_launches, tpa.plain_calls
    streams, _ = _workload(eng, reference["eos"])
    assert tpa.kernel_launches == launches
    assert tpa.plain_calls - plain == 2 * eng.stats["steps"]
    assert eng.stats["generated_tokens"] == sum(len(s) for s in streams)
    assert isinstance(eng.pool.k_pools[0], torch.Tensor)


def test_grid_buckets_match_reference(reference):
    eng = _engine(reference["tm"])
    jax_eng = reference["jax_engine"]
    for total in range(1, 1100):
        assert eng._grid_tokens(total) == jax_eng._grid_tokens(total), total


def _pool_ops(pool):
    """The same allocator traffic for either package's pool: lazy growth,
    reservations, reuse of freed pages, can_admit with same-step pending
    pages, and exhaustion."""
    seen = []
    seen.append(pool.allocate("a", 6, max_total_tokens=12))
    seen.append((pool.used_pages, pool.can_admit(8), pool.can_admit(4),
                 pool.can_admit(4, 1)))
    pool.allocate("b", 0, max_total_tokens=4)
    pool.extend("a", 9)
    pool.extend_write("b", 0, 3)
    seen.append((pool.block_table("a"), pool.block_table("b"),
                 pool.used_pages, pool.peak_used,
                 pool.block_table_array(["b", None, "a"], 4).tolist()))
    pool.free("a")
    seen.append(pool.allocate("c", 8))
    seen.append((pool.used_pages, pool.peak_used, pool.utilization()))
    try:
        pool.allocate("d", 16)
    except RuntimeError:
        seen.append("exhausted")
    seen.append((pool.used_pages, pool.can_admit(1)))
    return seen


def test_pool_allocator_matches_reference():
    jax_pool = JaxPool(num_layers=1, num_pages=7, page_size=4, n_kv_heads=2,
                       head_dim=8)
    pool = PagedKVCachePool(num_layers=1, num_pages=7, page_size=4,
                            n_kv_heads=2, head_dim=8, device="cpu")
    got = _pool_ops(pool)
    assert got == _pool_ops(jax_pool)
    assert "exhausted" in got and 0 not in got[0]


def _sched_ops(sched, pool, req_cls):
    """Admission order by (priority, arrival), head-of-line blocking on
    the pool, and decode-first chunk planning."""
    reqs = [req_cls(prompt=np.arange(1, 6), max_new_tokens=3, priority=1),
            req_cls(prompt=np.arange(1, 40), max_new_tokens=2, priority=0),
            req_cls(prompt=np.arange(1, 3), max_new_tokens=2, priority=1),
            req_cls(prompt=np.arange(1, 9), max_new_tokens=30, priority=1)]
    for r in reqs:
        sched.add(r)

    def idx(r):  # by identity: dataclass equality compares prompt arrays
        return next(i for i, q in enumerate(reqs) if q is r)

    order = [idx(r) for r in sched.waiting]
    first = [idx(r) for r in sched.admit(2, pool)]
    blocked = [idx(r) for r in sched.admit(4, pool)]
    plan = sched.plan_chunks(3, [(k, n, reqs[i]) for k, n, i in
                                 (("x", 9, 0), ("y", 20, 1), ("z", 2, 2))])
    return order, first, blocked, plan, sched.queue_depth


def test_scheduler_matches_reference():
    got = _sched_ops(FCFSScheduler(max_batch_slots=4, token_budget=16),
                     PagedKVCachePool(1, 12, 4, 2, 8, device="cpu"), Request)
    want = _sched_ops(JaxScheduler(max_batch_slots=4, token_budget=16),
                      JaxPool(1, 12, 4, 2, 8), JaxRequest)
    assert got == want
    order, first, blocked, plan, depth = got
    # the 41-token head takes all 11 pages: the next request waits behind
    # it, and later the 38-token one blocks what follows
    assert order == [1, 0, 2, 3] and first == [1] and blocked == [0, 2]
    assert plan[0] == ("y", 13) and depth == 1
