"""paddle_tpu_torch.serving.overload against the JAX package's.

- The controller, fed the same observations: a seeded sequence of
  per-engine queue depths, step-time EWMAs and health gates over a
  host-only fleet double (the JAX suite's), with requests of every tier
  and deadline offered to the admission gate at every tick. The level
  sequence, every ``observe()`` decision, the actions each level maps to
  (drafts paused, chunk cap, admission hold, preemption cut) and every
  shed (its cause and ``retry_after_s``) must equal the JAX package's;
  so must the retry budget's takes and refills, and the priority hold
  of ``FCFSScheduler.admit``.
- Real engines (the tiny Llama of ``tests/test_overload.py``, weights
  carried by ``load_reference_state_dict``), both packages on the same
  traffic: a batch-tier stream preempted at level 3, held, and restored
  after de-escalation ends as the undisturbed run, stream chunks
  exactly-once; the gate's shed and the backpressure hint are one
  number; journaled queued work times out where untouched work expires.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from torch_router_common import one_thread  # noqa: F401 (autouse)

PACKAGES = ("paddle_tpu", "paddle_tpu_torch")
LLAMA = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _FakeTrace:
    def __init__(self):
        self.events = []

    def emit(self, name, req_id, arg=0.0, label="", **kw):
        self.events.append((name, arg, label))


class _FakeSched:
    def __init__(self):
        self.queue_depth = 0
        self.waiting = []


class _FakeEngine:
    def __init__(self):
        self.scheduler = _FakeSched()
        self.avg_step_s = 0.05
        self._trace = _FakeTrace()
        self._overload = None


class _FakeRouter:
    """Real ``EngineHandle`` states of ``pkg`` around host-only engines."""

    def __init__(self, pkg, n):
        handle = _mod(pkg, "serving.router").EngineHandle
        self._hs = [handle(_FakeEngine(), f"m/{i}", "m") for i in range(n)]

    def _resolve_model(self, model):
        return "m"

    def handles(self, model=None):
        return list(self._hs)


CONFIGS = {
    "default": dict(hot_backlog_s=1.0, cold_backlog_s=0.25, hot_steps=2,
                    cold_steps=3, cooldown_steps=2),
    "twitchy": dict(hot_backlog_s=0.3, cold_backlog_s=0.1, hot_steps=1,
                    cold_steps=1, cooldown_steps=0, max_level=4,
                    batch_chunk_cap=2, deadline_slack=0.5),
    "capped": dict(hot_backlog_s=0.6, cold_backlog_s=0.2, hot_steps=2,
                   cold_steps=4, cooldown_steps=3, max_level=3),
}


def _trajectory(pkg, cfg, seed, ticks=150):
    """Drive one controller through a seeded storm; record everything."""
    ov = _mod(pkg, "serving.overload")
    sch = _mod(pkg, "serving.scheduler")
    router = _FakeRouter(pkg, 3)
    ctl = ov.OverloadController(router, config=ov.OverloadConfig(**cfg))
    rng = np.random.default_rng(seed)
    # a storm: pressure ramps up, plateaus, drains, with noise; then calm
    n = (ticks - 30) // 3
    envelope = np.concatenate([np.linspace(0, 40, n), np.full(n, 40.0),
                               np.linspace(40, 0, ticks - 30 - 2 * n),
                               np.zeros(30)])
    out = []
    for t in range(ticks):
        for i, h in enumerate(router.handles()):
            h.engine.scheduler.queue_depth = int(max(
                envelope[t] * (0.5 + i * 0.3) + rng.normal(0, 3), 0))
            h.engine.avg_step_s = float(rng.uniform(0.01, 0.06))
            h.state = "healthy" if rng.random() > 0.1 else "degraded"
        decision = ctl.observe()
        sheds = []
        eng = router.handles()[int(rng.integers(3))].engine
        for prio in (0, 1, 2):
            deadline = (None if rng.random() < 0.3
                        else float(rng.uniform(0.05, 3.0)))
            req = sch.Request(prompt=np.arange(1, 4), priority=prio,
                              deadline_s=deadline)
            try:
                ctl.admission_check(eng, req)
                sheds.append(None)
            except ov.AdmissionShedError as e:
                sheds.append((e.cause, round(e.retry_after_s, 12),
                              e.queue_depth))
        out.append((decision, ctl.level, ctl.drafts_paused,
                    ctl.chunk_cap(), ctl.admit_priority_cap(),
                    ctl.preempt_priority_cut(), ctl.park_batch,
                    ctl.interactive_only, round(ctl.signal(), 12),
                    tuple(sheds)))
    return out, list(ctl.events)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_ladder_and_sheds_match_jax(config, seed):
    want = _trajectory("paddle_tpu", CONFIGS[config], seed)
    got = _trajectory("paddle_tpu_torch", CONFIGS[config], seed)
    assert got == want
    decisions = {rec[0] for rec in got[0]}
    assert max(rec[1] for rec in got[0]) >= 2
    assert {"escalate", "de-escalate"} <= decisions


def test_config_validation_matches():
    bad = [dict(hot_backlog_s=0.1, cold_backlog_s=0.2), dict(hot_steps=0),
           dict(cooldown_steps=-1), dict(max_level=9),
           dict(batch_chunk_cap=0), dict(deadline_slack=0.0)]
    for pkg in PACKAGES:
        cfg = _mod(pkg, "serving.overload").OverloadConfig
        for kw in bad:
            with pytest.raises(ValueError):
                cfg(**kw)
    assert _mod(PACKAGES[0], "serving.overload").LEVELS == \
        _mod(PACKAGES[1], "serving.overload").LEVELS


def _budget_trace(pkg):
    rb = _mod(pkg, "serving.overload").RetryBudget(capacity=4.0,
                                                    refill_per_step=0.5)
    rng = np.random.default_rng(5)
    out = []
    for _ in range(60):
        mid = ("a", "b")[int(rng.integers(2))]
        if rng.random() < 0.3:
            rb.refill()
            out.append(("refill", rb.tokens("a"), rb.tokens("b")))
        else:
            out.append((mid, rb.try_take(mid), rb.tokens(mid)))
    return out


def test_retry_budget_matches():
    got = _budget_trace("paddle_tpu_torch")
    assert got == _budget_trace("paddle_tpu")
    assert any(x[1] is False for x in got)


class _AdmitPool:
    page_size = 4

    def prefix_match_len(self, ids):
        return 0

    def can_admit(self, max_total, pending, cached_pages=0,
                  pending_cached=0):
        return True

    def pages_needed(self, n):
        return 1


def _hold(pkg):
    sch = _mod(pkg, "serving.scheduler")
    sched = sch.FCFSScheduler(max_batch_slots=4)
    reqs = [sch.Request(prompt=np.arange(1, 4), priority=p)
            for p in (2, 1, 0, 2, 1)]
    for r in reqs:
        sched.add(r)
    idx = {r.req_id: i for i, r in enumerate(reqs)}
    out = []
    for cap in (1, 0, None):
        out.append([idx[r.req_id] for r in sched.admit(4, _AdmitPool(),
                                                       max_priority=cap)])
        out.append((sched.queue_depth, sched.pending_steps))
    return out


def test_priority_hold_matches():
    assert _hold("paddle_tpu_torch") == _hold("paddle_tpu")


# ───────────────────────────── real engines ──────────────────────────────


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**LLAMA))
    tm = LlamaForCausalLM(llama_tiny(**LLAMA), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return {"paddle_tpu": jm, "paddle_tpu_torch": tm}


def _kw(pkg):
    return {"device": "cpu"} if pkg == "paddle_tpu_torch" else {}


def _counter(pkg, name, **labels):
    fam = _mod(pkg, "metrics").get_registry().get(name)
    if fam is None:
        return 0.0
    return (fam.labels(**labels) if labels else fam).value


def _armed(pkg, model, **cfg_kw):
    sv = _mod(pkg, "serving")
    router = sv.Router()
    router.add_model("m", model, replicas=1, page_size=4, num_pages=64,
                     max_batch_slots=2, max_model_len=64, token_budget=32,
                     min_step_tokens=32, **_kw(pkg))
    cfg_kw.setdefault("hot_backlog_s", 1.0)
    cfg_kw.setdefault("cold_backlog_s", 0.25)
    ctl = sv.OverloadController(router, config=sv.OverloadConfig(**cfg_kw))
    return router, router.engine("m/0"), ctl


def _preemption(pkg, model):
    engine_cls = _mod(pkg, "serving").ServingEngine
    pb, pa = np.arange(1, 9), np.arange(3, 7)
    ref = engine_cls(model, page_size=4, max_batch_slots=2, num_pages=64,
                     token_budget=32, min_step_tokens=32, **_kw(pkg))
    rb = ref.add_request(pb, max_new_tokens=10, temperature=0.7, seed=11,
                         priority=2)
    ra = ref.add_request(pa, max_new_tokens=6, temperature=0.7, seed=5,
                         priority=0)
    ref_outs = ref.run()
    _router, engine, ctl = _armed(pkg, model)
    chunks = []
    b = engine.add_request(pb, max_new_tokens=10, temperature=0.7, seed=11,
                           priority=2, stream_cb=lambda rid, tok, fin, seq:
                           chunks.append((seq, tok, fin)))
    for _ in range(3):
        engine.step()
    lbl = dict(event="preempted", engine_id="m/0", model_id="m")
    p0 = _counter(pkg, "paddle_tpu_serving_requests_total", **lbl)
    ctl.level = 3
    engine.step()
    after = (_counter(pkg, "paddle_tpu_serving_requests_total", **lbl) - p0,
             [s is None for s in engine.slots], engine.pool.used_pages,
             engine.scheduler.queue_depth)
    a = engine.add_request(pa, max_new_tokens=6, temperature=0.7, seed=5,
                           priority=0)
    while engine.slots[0] is None and engine.slots[1] is None:
        engine.step()
    engine.step()
    held = engine.scheduler.queue_depth
    ctl.level = 0
    outs = engine.run()
    counts = engine.compile_counts()
    return (after, held, outs[b].finish_reason, outs[b].token_ids,
            outs[a].token_ids, ref_outs[rb].token_ids,
            ref_outs[ra].token_ids, chunks,
            counts["step"] == counts["step_buckets"],
            engine.pool.used_pages)


def test_preempted_stream_restores_bit_identical(models):
    want = _preemption("paddle_tpu", models["paddle_tpu"])
    got = _preemption("paddle_tpu_torch", models["paddle_tpu_torch"])
    assert got == want
    after, held, reason, tb, ta, rb, ra, chunks, ok, pages = got
    assert after == (1, [True, True], 0, 1) and held == 1
    assert tb == rb and ta == ra and ok and pages == 0
    toks = [c for c in chunks if c[1] is not None]
    assert [s for s, _t, _f in toks] == list(range(len(tb)))
    assert chunks[-1] == (len(toks), None, reason)


def _gate(pkg, model):
    sv = _mod(pkg, "serving")
    _router, engine, ctl = _armed(pkg, model)
    engine.add_request(np.arange(1, 5), max_new_tokens=4)
    predicted = ctl.estimator.for_engine(engine)
    hint = engine._estimate_retry_after()
    r0 = _counter(pkg, "paddle_tpu_serving_requests_total", event="rejected",
                  engine_id="m/0", model_id="m")
    try:
        engine.add_request(np.arange(1, 4), max_new_tokens=4,
                           deadline_s=predicted / 100.0)
        shed = None
    except sv.AdmissionShedError as e:
        shed = (e.cause, e.retry_after_s == predicted)
    rejected = _counter(pkg, "paddle_tpu_serving_requests_total",
                        event="rejected", engine_id="m/0",
                        model_id="m") - r0
    depth = engine.scheduler.queue_depth
    outs = engine.run()
    return (hint == predicted, shed, rejected, depth,
            sorted(o.finish_reason for o in outs.values()))


def test_gate_sheds_with_the_backpressure_hint(models):
    got = _gate("paddle_tpu_torch", models["paddle_tpu_torch"])
    assert got == _gate("paddle_tpu", models["paddle_tpu"])
    assert got[:4] == (True, ("deadline", True), 1, 1)


def _expiry(pkg, model):
    sv = _mod(pkg, "serving")
    engine = sv.ServingEngine(model, page_size=4, max_batch_slots=1,
                              **_kw(pkg))
    e0 = _counter(pkg, "paddle_tpu_serving_expired_total",
                  engine_id=engine.engine_id, model_id="default")
    live = engine.add_request(np.arange(1, 5), max_new_tokens=3)
    dead = engine.add_request(np.arange(1, 4), max_new_tokens=3,
                              deadline_s=0.0)
    req = sv.Request(prompt=np.arange(1, 5), max_new_tokens=6,
                     deadline_s=0.0, resume_tokens=[7, 9])
    engine.scheduler.add(req)
    outs = engine.run()
    return ([(outs[r].finish_reason, outs[r].token_ids)
             for r in (live, dead, req.req_id)],
            _counter(pkg, "paddle_tpu_serving_expired_total",
                     engine_id=engine.engine_id, model_id="default") - e0,
            engine.pool.used_pages)


def test_queued_expiry_is_untouched_work_only(models):
    got = _expiry("paddle_tpu_torch", models["paddle_tpu_torch"])
    assert got == _expiry("paddle_tpu", models["paddle_tpu"])
    assert got[0][1:] == [("expired", []), ("timeout", [7, 9])]
    assert got[1] == 1
