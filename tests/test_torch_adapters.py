"""The port's multi-LoRA adapters against the JAX package's.

``AdapterStore`` keeps the JAX store's semantics (slot 0 the zero
identity, first-fit slots, validate before write, a full store and bad
shapes refused) and writes in place, so the stacks' storage never moves.
``random_adapter`` draws bit-equal weights in both packages. The port's
``lora_delta`` and the step's grouped form (every slot's A and B at once,
other slots' columns zeroed) are held to the JAX ``lora_delta`` at atol
1e-6 in f32, and one mixed paged step with adapter rows to the JAX
trunk's at atol = rtol = 1e-5 (the tolerance of the plain paged step's
test). Engines serving base and adapter requests give the JAX engine's
streams, greedy and at t = 0.8; base requests are bit-identical with
tenants loaded; a hot-load in mid-traffic builds no program. The prefix
cache keys pages on token ids only in both packages, so a base request
adopts the pages an adapter request wrote for the same prompt: the
hazard shows in both alike.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import AdapterStore as JaxStore
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import random_adapter as jax_random_adapter
from paddle_tpu.serving.adapters import lora_delta as jax_lora_delta
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.serving import (AdapterRows, AdapterStore,
                                      ServingEngine, grouped_lora_delta,
                                      lora_delta, random_adapter)
from torch_suite import one_torch_thread  # noqa: F401

WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
PROMPTS = [np.random.RandomState(17).randint(0, 128, (n,)) for n in (5, 9, 3)]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _store(capacity=4):
    return AdapterStore([("q", 8, 8), ("mlp", 8, 16)], num_layers=2, rank=2,
                        capacity=capacity, device="cpu")


def _ptrs(store):
    return [t.data_ptr() for t in store.arrays()]


# ────────────────────────────── the store ──────────────────────────────


def test_store_slots_identity_first_fit_and_in_place_writes():
    s = _store()
    ptrs = _ptrs(s)
    assert s.slot(None) == 0 and s.holds(None)
    assert not any(t.any() for t in s.arrays())
    assert s.register("a", random_adapter(s, seed=1)) == 1
    assert s.register("b", random_adapter(s, seed=2)) == 2
    assert s.arrays()[0][1].any() and not s.arrays()[0][0].any()
    s.unregister("a")
    assert not s.holds("a") and not s.arrays()[0][1].any()
    assert s.register("c", random_adapter(s, seed=3)) == 1  # first fit
    assert s.register("c", random_adapter(s, seed=9)) == 1  # hot swap
    np.testing.assert_array_equal(s.arrays()[2][1].numpy(),
                                  random_adapter(s, seed=9)["mlp"][0])
    assert sorted(s.names()) == ["b", "c"]
    assert _ptrs(s) == ptrs  # never rebound: a captured step sees it all
    assert [tuple(t.shape) for t in s.arrays()] == [
        (4, 2, 2, 8), (4, 2, 8, 2), (4, 2, 2, 8), (4, 2, 16, 2)]


def test_store_refusals_match_jax():
    s = _store(capacity=2)
    s.register("a", random_adapter(s, seed=1))
    with pytest.raises(ValueError, match="adapter store full"):
        s.register("b", random_adapter(s, seed=2))
    s = _store()
    w = random_adapter(s, seed=1)
    bad = dict(w)
    bad["mlp"] = (w["mlp"][0][:, :1], w["mlp"][1])  # wrong rank, one site
    with pytest.raises(ValueError, match="expected A"):
        s.register("x", bad)
    assert not s.holds("x") and not any(t.any() for t in s.arrays())
    with pytest.raises(ValueError, match="missing sites"):
        s.register("y", {"q": w["q"]})
    with pytest.raises(KeyError, match="not registered"):
        s.slot("ghost")
    with pytest.raises(ValueError, match="capacity must be >= 2"):
        AdapterStore([("q", 4, 4)], num_layers=1, capacity=1, device="cpu")


def test_random_adapter_and_stacks_equal_jax():
    sites = [("q", 8, 8), ("mlp", 8, 16)]
    js = JaxStore(sites, num_layers=2, rank=2, capacity=4)
    s = _store()
    for seed, name in ((1, "a"), (2, "b")):
        want = jax_random_adapter(js, seed=seed)
        got = random_adapter(s, seed=seed)
        for site in want:
            for g, w in zip(got[site], want[site]):
                np.testing.assert_array_equal(g, w)
        js.register(name, want)
        s.register(name, got)
    js.unregister("a")
    s.unregister("a")
    for g, w in zip(s.arrays(), js.arrays()):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ─────────────────────────────── the delta ───────────────────────────────


def test_lora_delta_and_grouped_form_match_jax():
    """Both forms against JAX's on per-row gathered stacks, f32, atol
    1e-6, site by site and for a group of two sites that read one input
    (one A product and one mask); a slot-0 row's delta is exactly zero
    and its base comes back bit for bit."""
    rng = np.random.default_rng(0)
    sites = [("q", 16, 24), ("k", 16, 8), ("o", 24, 16)]
    s = AdapterStore(sites, num_layers=3, rank=4, capacity=4, device="cpu",
                     groups=[("q", "k")])
    for name, seed in (("a", 1), ("b", 2), ("c", 3)):
        s.register(name, random_adapter(s, seed=seed, scale=0.5))
    slots = np.array([0, 1, 2, 3, 2, 0, 1], np.int64)
    rows = AdapterRows(s, torch.from_numpy(slots))
    stacks = s.arrays()
    for layer in range(3):
        # q and k read one input, o its own
        xs = {16: rng.standard_normal((slots.size, 16)).astype(np.float32),
              24: rng.standard_normal((slots.size, 24)).astype(np.float32)}
        bases = {site: torch.from_numpy(rng.standard_normal(
            (slots.size, d_out)).astype(np.float32))
            for site, _d_in, d_out in sites}
        pair = rows.apply_group(("q", "k"), layer, torch.from_numpy(xs[16]),
                                (bases["q"], bases["k"]))
        for si, (site, d_in, d_out) in enumerate(sites):
            x, tb = xs[d_in], bases[site]
            A, B = (stacks[2 * si + j].numpy()[slots] for j in (0, 1))
            want = np.asarray(jax_lora_delta(
                paddle.to_tensor(x[:, None]), paddle.to_tensor(A),
                paddle.to_tensor(B), layer).numpy())[:, 0]
            tx = torch.from_numpy(x)
            a_l, b_l = s.slabs[site]
            got = {
                "lora_delta": lora_delta(tx, torch.from_numpy(A),
                                         torch.from_numpy(B), layer),
                "grouped": grouped_lora_delta(tx, a_l[layer], b_l[layer],
                                              rows.keep),
                "apply": rows.apply(site, layer, tx, tb)}
            if site != "o":
                got["apply_group"] = pair[si]
            for name, g in got.items():
                delta = g - tb if name.startswith("apply") else g
                np.testing.assert_allclose(delta.numpy(), want, atol=1e-6,
                                           rtol=0, err_msg=name)
                if name.startswith("apply"):
                    np.testing.assert_array_equal(g[slots == 0].numpy(),
                                                  tb[slots == 0].numpy())
            assert not got["grouped"][slots == 0].any()
            assert np.abs(want[slots != 0]).min() > 0
    with pytest.raises(ValueError, match="one input width"):
        AdapterStore(sites, num_layers=1, device="cpu", groups=[("q", "o")])


def _mixed_step():
    """Slot A decodes at 12 on adapter slot 1, slot B feeds a 5-token
    chunk at 7..11 on slot 2, slot C decodes at 0 on the base model."""
    rng = np.random.default_rng(11)
    page, pages, nkv, hd = 4, 16, 2, 16
    slot_bt = np.array([[1, 2, 3, 4], [5, 6, 7, 0], [8, 0, 0, 0]], np.int32)
    q_lens, starts, adp = [1, 5, 1], [12, 7, 0], [1, 2, 0]
    bt = np.concatenate([np.repeat(slot_bt[i:i + 1], n, axis=0)
                         for i, n in enumerate(q_lens)])
    pos = np.concatenate([np.arange(s, s + n)
                          for s, n in zip(starts, q_lens)]).astype(np.int32)
    tok_adp = np.repeat(np.array(adp, np.int32), q_lens)
    ids = rng.integers(0, 128, pos.size).astype(np.int32)
    pools = [(rng.standard_normal((pages, page, nkv, hd)).astype(np.float32),
              rng.standard_normal((pages, page, nkv, hd)).astype(np.float32))
             for _ in range(2)]
    return ids, pos, bt, tok_adp, pools


def test_forward_paged_with_adapters_matches_jax(models):
    jm, tm = models
    ids, pos, bt, tok_adp, pools = _mixed_step()
    js = JaxStore.from_model(jm, rank=4, capacity=4)
    ts = AdapterStore.from_model(tm, rank=4, capacity=4)
    for name, seed in (("a1", 3), ("a2", 4)):
        js.register(name, jax_random_adapter(js, seed=seed, scale=0.3))
        ts.register(name, random_adapter(ts, seed=seed, scale=0.3))
    arrs = [np.asarray(a) for a in js.arrays()]
    gathered = {site: (paddle.to_tensor(arrs[2 * i][tok_adp]),
                       paddle.to_tensor(arrs[2 * i + 1][tok_adp]))
                for i, (site, _, _) in enumerate(js.sites)}
    jh, _ = jm.llama.forward_paged(
        paddle.to_tensor(ids[:, None]), paddle.to_tensor(pos),
        paddle.to_tensor(bt),
        [(paddle.to_tensor(k), paddle.to_tensor(v)) for k, v in pools],
        adapters=gathered)
    jh = np.asarray(jh.numpy()).reshape(ids.size, -1)
    hidden = {}
    for store in ("tenants", "empty"):
        caches = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
                  for k, v in pools]
        rows = AdapterRows(ts if store == "tenants"
                           else AdapterStore.from_model(tm),
                           torch.from_numpy(tok_adp))
        with torch.no_grad():
            hidden[store] = tm.llama.forward_paged(
                torch.from_numpy(ids), torch.from_numpy(pos),
                torch.from_numpy(bt), caches, adapters=rows).numpy()
    np.testing.assert_allclose(hidden["tenants"], jh, atol=1e-5, rtol=1e-5)
    # the adapters acted on their rows; slot C, on slot 0 and attending
    # its own page alone, is bit for bit the store-less step
    assert not np.allclose(hidden["tenants"][:6], hidden["empty"][:6])
    np.testing.assert_array_equal(hidden["tenants"][6], hidden["empty"][6])


# ─────────────────────────────── engines ───────────────────────────────


def _register(engine, rand):
    engine.register_adapter("a1", rand(engine.adapters, seed=3))
    engine.register_adapter("a2", rand(engine.adapters, seed=4, scale=0.5))


def _work(engine, temperature, adapters=(None, "a1", "a2", "a1", None)):
    rng = np.random.RandomState(5)
    rids = []
    for i, a in enumerate(adapters):
        rids.append(engine.add_request(
            rng.randint(0, 128, 4 + 3 * i), max_new_tokens=6 + i,
            temperature=temperature, seed=20 + i, adapter_id=a))
        if i == 1:
            engine.step()
    out = engine.run()
    return [out[r].token_ids for r in rids]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_adapter_streams_match_jax(models, temperature):
    jm, tm = models
    kw = dict(page_size=4, max_batch_slots=3, token_budget=12)
    jeng = JaxEngine(jm, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    _register(jeng, jax_random_adapter)
    _register(teng, random_adapter)
    got = _work(teng, temperature)
    assert got == _work(jeng, temperature)
    assert teng.compile_counts() == jeng.compile_counts()
    assert teng.pool.used_pages == 0
    # the adapters change the streams they serve
    plain = ServingEngine(tm, device="cpu", **kw)
    base = _work(plain, temperature, adapters=(None,) * 5)
    assert got[0] == base[0] and got[4] == base[4]
    assert got[1:4] != base[1:4]


def test_base_requests_bit_identical_with_tenants_loaded(models):
    _jm, tm = models
    kw = dict(page_size=4, max_batch_slots=4, device="cpu")

    def run(eng):
        rids = [eng.add_request(p, max_new_tokens=6, temperature=0.8,
                                seed=40 + i) for i, p in enumerate(PROMPTS)]
        outs = eng.run()
        return [outs[r].token_ids for r in rids]

    base = run(ServingEngine(tm, **kw))
    eng = ServingEngine(tm, **kw)
    eng.register_adapter("acme", random_adapter(eng.adapters, seed=3,
                                                scale=1.0))
    eng.add_request(np.arange(4), max_new_tokens=4, temperature=0.8,
                    seed=99, adapter_id="acme")
    assert run(eng) == base


def test_hot_load_mid_traffic_builds_no_program(models):
    jm, tm = models
    counts = {}
    for pkg, eng, rand in (
            ("jax", JaxEngine(jm, page_size=4, max_batch_slots=2),
             jax_random_adapter),
            ("torch", ServingEngine(tm, page_size=4, max_batch_slots=2,
                                    device="cpu"), random_adapter)):
        def traffic(tenant):
            slow = eng.add_request(PROMPTS[0], max_new_tokens=12,
                                   temperature=0.6, seed=7)
            eng.step()  # slow is live when the tenant's request arrives
            if tenant:
                eng.register_adapter("acme", rand(eng.adapters, seed=3))
            rid = eng.add_request(PROMPTS[2], max_new_tokens=4,
                                  adapter_id="acme" if tenant else None)
            outs = eng.run()
            return outs[slow].token_ids, outs[rid].token_ids

        warm = traffic(False)
        before = eng.compile_counts()
        hot = traffic(True)
        assert eng.compile_counts() == before, pkg
        assert hot[0] == warm[0], pkg  # the live stream never noticed
        counts[pkg] = (before, warm, hot)
    assert counts["torch"] == counts["jax"]
    ptrs = [t.data_ptr() for t in eng.adapters.arrays()]
    with pytest.raises(ValueError, match="not registered on this"):
        eng.add_request(PROMPTS[0], adapter_id="ghost")
    eng.add_request(PROMPTS[0], max_new_tokens=2, adapter_id="acme")
    with pytest.raises(ValueError, match="in use"):
        eng.unregister_adapter("acme")
    eng.run()
    eng.unregister_adapter("acme")
    assert not eng.adapters.holds("acme")
    assert [t.data_ptr() for t in eng.adapters.arrays()] == ptrs


def test_prefix_cache_adopts_across_adapters_as_jax_does(models):
    """The hazard of the reference, kept by the port: the cache's key is
    the prompt's token ids alone, so a base request adopts the prefix
    pages an adapter request wrote (k/v carrying the adapter's delta), in
    both packages alike, and its stream then differs from the same
    request served on a cold cache."""
    jm, tm = models
    prompt = PROMPTS[1]  # 9 tokens: 2 full pages of 4 are cached
    kw = dict(page_size=4, max_batch_slots=2)
    streams, hits = {}, {}
    for pkg, eng, rand in (("jax", JaxEngine(jm, **kw), jax_random_adapter),
                           ("torch", ServingEngine(tm, device="cpu", **kw),
                            random_adapter)):
        eng.register_adapter("loud", rand(eng.adapters, seed=5, scale=1.0))
        tenant = eng.add_request(prompt, max_new_tokens=6,
                                 adapter_id="loud")
        first = eng.run()[tenant].token_ids
        base = eng.add_request(prompt, max_new_tokens=6)
        streams[pkg] = (first, eng.run()[base].token_ids)
        hits[pkg] = (eng.prefix_cache._m_saved.value if pkg == "jax"
                     else eng.stats["prefix_hit_tokens"])
    assert streams["torch"] == streams["jax"]
    assert hits["torch"] == hits["jax"] == 8
    teng = eng
    assert teng.stats["prefix_hit_tokens_cross_adapter"] == 8
    cold = ServingEngine(tm, device="cpu", **kw)
    rid = cold.add_request(prompt, max_new_tokens=6)
    assert cold.run()[rid].token_ids != streams["torch"][1]
