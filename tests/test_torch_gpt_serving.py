"""The serving half of paddle_tpu_torch.models.gpt against the JAX package.

The JAX ``gpt_tiny`` at ``tests/test_serving.py``'s widths (2 layers,
hidden 64, 4 heads, vocab 128) is built from its own seed and its
``state_dict`` carried across with ``load_reference_state_dict``.

- One mixed paged step (decode rows and a prompt chunk, as the engine's
  unified step lays them out) through both packages' ``forward_paged``
  on the same numpy pools: f32 at atol = rtol = 1e-5 (summation orders
  of the two packages' CPU matmuls over two layers), int8 pages too.
- The same step under ``amp.decorate(level="O2")``: the port's dtypes
  must equal the JAX package's at every stage (the embeddings, the
  LayerNorms, q/k/v with the bf16 bias, the attention output, the
  hidden state and the logits are all bf16; only the LayerNorm weights
  stay f32). Values agree to bf16 rounding (tolerance stated there).
- Engines: the port's ``ServingEngine`` over the GPT against the JAX
  engine over the same weights, f32: greedy and t = 0.8 streams, int8
  pages, an adapter on every GPT site, ``spec_k`` 4 and the prefix cache;
  and the O2 model on bf16 pages. A request's stream is a pure function
  of (prompt, seed, temperature) in both, so the streams must be
  token-identical.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import random_adapter as jax_random_adapter
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.models.convert import _to_torch
from paddle_tpu_torch.serving import ServingEngine, random_adapter
from paddle_tpu_torch.serving.adapters import AdapterRows, AdapterStore
from torch_router_common import one_thread  # noqa: F401 (autouse)

ATOL = RTOL = 1e-5
WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              max_position_embeddings=64, hidden_dropout_prob=0.0,
              attention_dropout_prob=0.0)
PROMPTS = [np.random.RandomState(7).randint(0, 128, (n,))
           for n in (5, 9, 3, 12)]


def _pair(o2=False):
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(**WIDTHS))
    if o2:
        jm = jamp.decorate(jm, level="O2", dtype="bfloat16")
    ref = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(**WIDTHS), device="cpu", seed=1,
                        dtype=torch.bfloat16 if o2 else torch.float32)
    load_reference_state_dict(tm, ref)
    return jm, tm, ref


@pytest.fixture(scope="module")
def models():
    return _pair()


def _mixed_step(kv_dtype=np.float32):
    """Rows of one unified step: slot A decodes at position 12, slot B
    feeds a 5-token chunk at positions 7..11, slot C decodes at 0. Each
    slot owns distinct pages; positions before each row are pre-filled
    KV history (MHA: 4 kv heads of 16)."""
    rng = np.random.default_rng(11)
    page, pages, nkv, hd = 4, 16, 4, 16
    slot_bt = np.array([[1, 2, 3, 4], [5, 6, 7, 0], [8, 0, 0, 0]], np.int32)
    q_lens, starts = [1, 5, 1], [12, 7, 0]
    bt = np.concatenate([np.repeat(slot_bt[i:i + 1], n, axis=0)
                         for i, n in enumerate(q_lens)])
    pos = np.concatenate([np.arange(s, s + n)
                          for s, n in zip(starts, q_lens)]).astype(np.int32)
    ids = rng.integers(0, 128, pos.size).astype(np.int32)
    pools = [tuple(rng.standard_normal((pages, page, nkv, hd)).astype(
        np.float32).astype(kv_dtype) for _ in range(2)) for _ in range(2)]
    return ids, pos, bt, pools


def _jax_step(jm, ids, pos, bt, caches):
    jh, jcaches = jm.gpt.forward_paged(
        paddle.to_tensor(ids[:, None]), paddle.to_tensor(pos),
        paddle.to_tensor(bt),
        [tuple(paddle.to_tensor(a) for a in c) for c in caches])
    jlogits = jm.logits(jh)
    return jh, jlogits, jcaches


def test_lora_sites_match_jax(models):
    jm, tm, _ = models
    assert tm.lora_sites() == jm.lora_sites()
    # four sites, four inputs: no two share an A product
    assert tm.lora_site_groups() == ()
    assert tm._cache_spec() == jm._cache_spec() == (2, 4, 16)


def test_forward_paged_mixed_rows_match_jax(models):
    jm, tm, _ = models
    ids, pos, bt, pools = _mixed_step()
    jh, jlogits, jcaches = _jax_step(jm, ids, pos, bt, pools)
    jh = np.asarray(jh.numpy()).reshape(ids.size, -1)
    tcaches = [tuple(torch.from_numpy(a.copy()) for a in c) for c in pools]
    with torch.no_grad():
        th = tm.gpt.forward_paged(torch.from_numpy(ids),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(bt), tcaches)
        tlogits = tm.logits(th)
    np.testing.assert_allclose(th.numpy(), jh, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tlogits.numpy(), np.asarray(jlogits.numpy()).reshape(ids.size, -1),
        atol=ATOL, rtol=RTOL)
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jk.numpy())[1:],
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tv.numpy()[1:], np.asarray(jv.numpy())[1:],
                                   atol=ATOL, rtol=RTOL)
    # the chunk landed in slot B's pages; the learned positions differ
    assert not np.allclose(tcaches[0][0].numpy()[6], pools[0][0][6])


def test_forward_paged_int8_pages_match_jax(models):
    """int8 pages with per-slot scales: the codes and scales written and
    the hidden state agree (a code may land one step off where its f32
    value sits at a rounding midpoint: atol 1 on the codes)."""
    jm, tm, _ = models
    ids, pos, bt, pools = _mixed_step()
    rng = np.random.default_rng(3)
    q = [(rng.integers(-127, 128, k.shape).astype(np.int8),
          rng.integers(-127, 128, v.shape).astype(np.int8),
          (rng.random(k.shape[:3]) * 0.02 + 0.01).astype(np.float32),
          (rng.random(v.shape[:3]) * 0.02 + 0.01).astype(np.float32))
         for k, v in pools]
    jh, _jl, jcaches = _jax_step(jm, ids, pos, bt, q)
    tcaches = [tuple(torch.from_numpy(a.copy()) for a in c) for c in q]
    with torch.no_grad():
        th = tm.gpt.forward_paged(torch.from_numpy(ids),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(bt), tcaches)
    np.testing.assert_allclose(
        th.numpy(), np.asarray(jh.numpy()).reshape(ids.size, -1),
        atol=1e-4, rtol=1e-4)
    for jc, tc in zip(jcaches, tcaches):
        for j, t in zip(jc, tc):
            j = np.asarray(j.numpy())[1:]
            t = t.numpy()[1:]
            if t.dtype == np.int8:
                assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() \
                    <= 1
            else:
                np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)


def test_o2_state_dict_crosses_bit_for_bit():
    """``load_reference_state_dict`` carries an O2 GPT's bf16 arrays as
    their 16-bit patterns and its f32 LayerNorms as they are."""
    jm, tm, ref = _pair(o2=True)
    for n, p in tm.named_parameters():
        want = ref[n].T if n.endswith("weight") and p.dim() == 2 and \
            "embeddings" not in n else ref[n]
        is_ln = ".ln" in n
        assert p.dtype == (torch.float32 if is_ln else torch.bfloat16), n
        assert ref[n].dtype == (np.float32 if is_ln else ml_dtypes.bfloat16)
        assert torch.equal(p.detach(), _to_torch(np.ascontiguousarray(want)))


def test_o2_paged_step_follows_jax_dtypes():
    """The O2 model's paged step over bf16 pools: every stage in the JAX
    package's dtype (all bf16 here, unlike Llama, whose RMSNorm widens to
    f32), recorded by hooks on both sides. Values: the two packages round
    bf16 intermediates at different points (the JAX LayerNorm keeps bf16
    statistics, the port's computes in f32 and rounds once), so the
    hidden state agrees to a few bf16 ulps: atol = rtol = 2^-5 (measured
    max abs difference 2.3e-2 on activations up to 3.8)."""
    jm, tm, _ = _pair(o2=True)
    ids, pos, bt, pools = _mixed_step(ml_dtypes.bfloat16)
    jdt, tdt = [], []

    import paddle_tpu.models.gpt as jgpt
    orig = jgpt.GPTAttention.forward_paged

    def jattn(self, x, *a, **k):
        out, nc = orig(self, x, *a, **k)
        jdt.append((str(x.dtype), str(out.dtype)))
        return out, nc

    jgpt.GPTAttention.forward_paged = jattn
    try:
        jh, jlogits, jcaches = _jax_step(jm, ids, pos, bt, pools)
    finally:
        jgpt.GPTAttention.forward_paged = orig
    seen = {}

    def record(name):
        def hook(mod, inp, out):
            seen[name] = out.dtype
        return hook

    hooks = [m.register_forward_hook(record(name))
             for name, m in tm.named_modules()
             if name.endswith(("ln1", "qkv_proj", "out_proj", "ln_f"))]
    tattn = tm.gpt.layers[0].attn
    orig_t = type(tattn).forward_paged

    def tattn_fp(self, x, *a, **k):
        out = orig_t(self, x, *a, **k)
        tdt.append((str(x.dtype).replace("torch.", ""),
                    str(out.dtype).replace("torch.", "")))
        return out

    type(tattn).forward_paged = tattn_fp
    tcaches = [tuple(_to_torch(a) for a in c) for c in pools]
    try:
        with torch.no_grad():
            th = tm.gpt.forward_paged(torch.from_numpy(ids),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(bt), tcaches)
            tl = tm.logits(th)
    finally:
        type(tattn).forward_paged = orig_t
        for h in hooks:
            h.remove()
    assert tdt == jdt == [("bfloat16", "bfloat16")] * 2
    assert set(seen.values()) == {torch.bfloat16}
    assert str(jh.dtype) == "bfloat16" and th.dtype == torch.bfloat16
    assert str(jlogits.dtype) == "bfloat16" and tl.dtype == torch.bfloat16
    for (jk, _jv), (tk, _tv) in zip(jcaches, tcaches):
        assert str(jk.dtype) == "bfloat16" and tk.dtype == torch.bfloat16
    jh = np.asarray(jh.numpy()).astype(np.float32).reshape(ids.size, -1)
    np.testing.assert_allclose(th.float().numpy(), jh, atol=2.0 ** -5,
                               rtol=2.0 ** -5)


def test_adapter_rows_at_every_site(models):
    """One step with rows on an adapter slot and rows on slot 0: the slot-0
    rows equal the store-less step bit for bit, and the adapter rows equal
    the JAX step over the same gathered stacks (1e-5)."""
    jm, tm, _ = models
    from paddle_tpu.serving import AdapterStore as JaxStore
    ids, pos, bt, pools = _mixed_step()
    store = AdapterStore.from_model(tm, rank=4, capacity=3)
    w = random_adapter(store, seed=4, scale=0.2)
    store.register("a", w)
    slots = np.array([1, 0, 0, 0, 0, 1, 1], np.int32)
    outs = {}
    for name, adp in (("none", None),
                      ("rows", AdapterRows(store, torch.from_numpy(slots)))):
        caches = [tuple(torch.from_numpy(a.copy()) for a in c)
                  for c in pools]
        with torch.no_grad():
            outs[name] = tm.gpt.forward_paged(
                torch.from_numpy(ids), torch.from_numpy(pos),
                torch.from_numpy(bt), caches, adapters=adp)
    base_rows = slots == 0
    # slot-0 rows whose attention reads no adapter-written key: slot B's
    # chunk (rows 1-4) reads only its own pages
    assert torch.equal(outs["rows"][1:5], outs["none"][1:5])
    assert not torch.allclose(outs["rows"][0], outs["none"][0])
    # the JAX step's per-row gathered stacks ({site: (A, B)})
    jstore = JaxStore.from_model(jm, rank=4, capacity=3)
    jstore.register("a", jax_random_adapter(jstore, seed=4, scale=0.2))
    arrs = [np.asarray(a) for a in jstore.arrays()]
    gathered = {site: (paddle.to_tensor(arrs[2 * i][slots]),
                       paddle.to_tensor(arrs[2 * i + 1][slots]))
                for i, (site, _, _) in enumerate(jstore.sites)}
    jh, _c = jm.gpt.forward_paged(
        paddle.to_tensor(ids[:, None]), paddle.to_tensor(pos),
        paddle.to_tensor(bt),
        [tuple(paddle.to_tensor(a) for a in c) for c in pools],
        adapters=gathered)
    np.testing.assert_allclose(
        outs["rows"].numpy(), np.asarray(jh.numpy()).reshape(ids.size, -1),
        atol=ATOL, rtol=RTOL)
    assert base_rows.sum() == 4


# ─────────────────────────────── engines ────────────────────────────────


def _serve(engine, adapter=None, spec_budget=None):
    """Three greedy and three t = 0.8 requests, the last ones on
    ``adapter``; one admitted after the first step. Returns the streams
    and finish reasons in request order."""
    rids = []
    for i, p in enumerate(PROMPTS[:3]):
        rids.append(engine.add_request(p, max_new_tokens=8,
                                       temperature=0.0 if i % 2 else 0.8,
                                       seed=11 * i))
    engine.step()
    for i, p in enumerate(PROMPTS[1:]):
        rids.append(engine.add_request(
            p, max_new_tokens=7, temperature=0.8 if i % 2 else 0.0,
            seed=5 + i, adapter_id=adapter if i else None))
    outs = engine.run()
    return [(list(outs[r].token_ids), outs[r].finish_reason) for r in rids]


@pytest.mark.parametrize("case", ["plain", "int8", "adapter_spec4"])
def test_engine_streams_match_jax(models, case):
    jm, tm, _ = models
    kw = dict(page_size=4, max_batch_slots=2, token_budget=12)
    if case == "int8":
        kw["kv_dtype"] = "int8"
    if case == "adapter_spec4":
        kw["spec_k"] = 4
    jeng = JaxEngine(jm, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    adapter = None
    if case == "adapter_spec4":
        adapter = "t1"
        jeng.register_adapter("t1", jax_random_adapter(jeng.adapters, seed=9,
                                                       scale=0.2))
        teng.register_adapter("t1", random_adapter(teng.adapters, seed=9,
                                                   scale=0.2))
    want = _serve(jeng, adapter)
    got = _serve(teng, adapter)
    assert got == want
    assert any(len(set(t)) > 1 for t, _r in got)
    assert teng.pool.used_pages == 0
    assert teng.compile_counts() == {"step": len(teng._grid_buckets_seen),
                                     "step_buckets":
                                         len(teng._grid_buckets_seen)}
    if case == "adapter_spec4":
        assert teng.stats["spec_drafted"] > 0


def test_engine_max_model_len_bounded_by_positions(models):
    """The learned position table bounds the context window."""
    _jm, tm, _ = models
    eng = ServingEngine(tm, device="cpu", max_model_len=1000,
                        max_batch_slots=1)
    assert eng.max_model_len == 64
    with pytest.raises(ValueError, match="max_model_len=64"):
        eng.add_request(np.arange(60) % 128, max_new_tokens=8)


def test_o2_engine_streams_match_jax():
    """The serving path over the O2 model, its weights carried bit for
    bit, bf16 pages: the port's streams equal the JAX engine's, greedy
    and sampled (the two packages round bf16 intermediates at different
    points, test_o2_paged_step_follows_jax_dtypes; on these inputs no
    argmax or draw sits near enough a tie for that to flip a token)."""
    jm, tm, _ = _pair(o2=True)
    kw = dict(page_size=4, max_batch_slots=2, kv_dtype="bfloat16")
    want = _serve(JaxEngine(jm, **kw))
    got = _serve(ServingEngine(tm, device="cpu", **kw))
    assert got == want
    assert any(len(set(t)) > 1 for t, _r in got)
