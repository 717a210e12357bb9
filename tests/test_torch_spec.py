"""The port's speculative decoding against the JAX engine's.

``NGramDrafter.propose`` and ``FCFSScheduler.plan_drafts`` are host code
copied from the JAX package: they must give the same proposals and
grants. In the engines, drafts ride the unified step as extra grid rows
and are accepted by equality with the tokens sampled at their
positions, so the streams must be token-identical to the JAX engine's at
``spec_k`` 0, 2 and 4, greedy and at t = 0.8, equal to each other, and
the drafted and accepted counts equal the JAX engine's.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import FCFSScheduler as JaxScheduler
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.spec import NGramDrafter as JaxDrafter
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.serving import (FCFSScheduler, NGramDrafter, Request,
                                      ServingEngine)
from torch_suite import one_torch_thread  # noqa: F401

WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)


@settings(max_examples=60, deadline=None)
@given(ids=st.lists(st.integers(0, 5), min_size=0, max_size=40),
       k=st.integers(0, 6), max_ngram=st.integers(1, 4),
       min_ngram=st.integers(1, 2))
def test_ngram_proposals_match_jax(ids, k, max_ngram, min_ngram):
    """Small alphabets, so suffixes recur and proposals are non-empty."""
    if min_ngram > max_ngram:
        return
    ids = np.asarray(ids, np.int32)
    got = NGramDrafter(k=4, max_ngram=max_ngram,
                       min_ngram=min_ngram).propose(ids, k)
    want = JaxDrafter(k=4, max_ngram=max_ngram,
                      min_ngram=min_ngram).propose(ids, k)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_ngram_latest_match_and_default_k():
    d = NGramDrafter(k=3, max_ngram=2)
    ids = np.array([1, 2, 3, 9, 1, 2, 4, 5, 6, 1, 2], np.int32)
    np.testing.assert_array_equal(d.propose(ids), [4, 5, 6])
    assert d.propose(np.array([1, 2, 3], np.int32)).size == 0
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=1, min_ngram=2)


def _plan_drafts(sched_cls, req_cls):
    reqs = [req_cls(prompt=[1], priority=p) for p in (1, 0, 1, 0)]
    wants = [(i, w, r) for i, (w, r) in enumerate(zip((4, 2, 3, 5), reqs))]
    sched = sched_cls(max_batch_slots=4, token_budget=16)
    return [sched.plan_drafts(left, wants) for left in (0, 1, 6, 9, 100)] + \
        [sched.plan_drafts(5, []), sched.plan_drafts(5, [(7, 0, reqs[0])])]


def test_plan_drafts_matches_jax():
    got = _plan_drafts(FCFSScheduler, Request)
    assert got == _plan_drafts(JaxScheduler, JaxRequest)
    assert got[2] == [(1, 2), (3, 4)]  # priority 0 first, then arrival


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _spec_work(engine, temperature):
    """Four requests, two of which repeat a short n-gram (the drafter
    finds it), admitted in two waves, with budgets tight enough that
    drafts are rationed in some steps."""
    rng = np.random.RandomState(17)
    loop = np.tile(rng.randint(0, 128, 3), 4)
    prompts = [loop, rng.randint(0, 128, 9),
               np.concatenate([rng.randint(0, 128, 5), loop[:7]]),
               rng.randint(0, 128, 4)]
    rids = []
    for i, p in enumerate(prompts):
        rids.append(engine.add_request(p, max_new_tokens=10 + i,
                                       temperature=temperature, seed=3 + i))
        if i == 1:
            engine.step()
    out = engine.run()
    return [out[r].token_ids for r in rids]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_streams_match_jax_and_each_other(models, temperature):
    jm, tm = models
    streams, counts = {}, {}
    for k in (0, 2, 4):
        jeng = JaxEngine(jm, page_size=4, max_batch_slots=3, token_budget=12,
                         spec_k=k)
        teng = ServingEngine(tm, page_size=4, max_batch_slots=3,
                             token_budget=12, spec_k=k, device="cpu")
        want = _spec_work(jeng, temperature)
        got = _spec_work(teng, temperature)
        assert got == want, k
        streams[k] = got
        counts[k] = (teng.stats["spec_drafted"], teng.stats["spec_accepted"])
        assert counts[k] == (jeng._m_spec_drafted.value,
                             jeng._m_spec_accepted.value)
        assert teng.compile_counts() == jeng.compile_counts()
        assert teng.pool.used_pages == 0
    assert streams[0] == streams[2] == streams[4]
    assert counts[0] == (0, 0) and counts[2][0] > 0 and counts[4][0] > 0
    if temperature == 0.0:
        # the greedy tiny model falls into the loops its prompts repeat
        assert counts[2][1] > 0 and counts[4][1] > 0


def test_custom_drafter_and_rollback(models):
    """A drafter that always proposes the wrong tokens: every draft is
    rejected and rolled back, the stream is the plain one, and no page
    outlives its request."""
    _jm, tm = models

    class Wrong:
        def propose(self, ids, k):
            return np.full(k, 127, np.int32)

    plain = ServingEngine(tm, page_size=4, max_batch_slots=3,
                          token_budget=12, device="cpu")
    eng = ServingEngine(tm, page_size=4, max_batch_slots=3, token_budget=12,
                        drafter=Wrong(), device="cpu")
    assert eng.spec_k == 1
    assert _spec_work(eng, 0.0) == _spec_work(plain, 0.0)
    assert eng.stats["spec_drafted"] > 0
    assert eng.stats["spec_accepted"] < eng.stats["spec_drafted"]
    assert eng.pool.used_pages == 0
