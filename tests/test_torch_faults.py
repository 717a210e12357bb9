"""The port's fault injection and serving resilience against the JAX package.

- The primitives (fault points, retry, deadlines, the step watchdog, the
  lock sanitizer) run the JAX package's own unit cases, once per
  package: both ``faults`` packages are jax-free and must behave the
  same.
- Every serving drill of the JAX package's fault tests (NaN quarantine in
  decode and in prefill, f32 and int8 pages; suspect-prefix eviction; the
  refcount-aware scrub and ``poison_seq``'s refusal of shared pages; pool
  exhaustion mid-decode and in a prefill's allocation, with its
  rollback; a transient step-build failure; deadlines, queued and
  admitted; cancel queued, decoding and from the request's own stream
  callback; backpressure; a raising callback; the watchdog with
  ``/healthz``) runs through both engines on the same weights (carried by
  ``load_reference_state_dict``), inputs and fault schedule. The
  outcomes must be equal: finish reasons, ``n_gen``, token streams,
  four-argument callbacks' ``(token, finished, seq)`` tuples, reason
  counters (deltas in each package's own registry), ``used_pages`` and
  prefix hits. Streams and counters compare exactly.
- The port's own: a failure of the step program itself propagates out of
  ``step()``, unretried and unisolated, with the watchdog's bracket
  closed.
"""
import importlib
import json
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import BackpressureError as JaxBackpressure
from paddle_tpu.serving import PagedKVCachePool as JaxPool
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.serving import BackpressureError, PagedKVCachePool
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import engine as torch_engine

PACKAGES = ("paddle_tpu", "paddle_tpu_torch")
LLAMA = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)
TINY = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=1,
            num_key_value_heads=1, max_position_embeddings=32)
P5, P9, P3, P4 = (np.random.RandomState(7).randint(0, 128, (n,))
                  for n in (5, 9, 3, 4))


def _counter(metrics_mod, name, **labels):
    fam = metrics_mod.get_registry().get(name)
    if fam is None:
        return 0.0
    if labels and set(labels) != set(fam.label_names):
        return fam.sum_labels(**labels)
    return (fam.labels(**labels) if labels else fam).value


@dataclass
class Side:
    """One package's serving stack: its faults and metrics modules, its
    engine and pool, and the two models (same weights on both sides)."""
    name: str
    faults: object
    metrics: object
    engine_cls: type
    pool_cls: type
    backpressure: type
    models: dict
    kw: dict = field(default_factory=dict)

    def engine(self, which="llama", **kw):
        return self.engine_cls(self.models[which], **kw, **self.kw)

    def pool(self, **kw):
        return self.pool_cls(**kw, **self.kw)

    def counter(self, name, **labels):
        return _counter(self.metrics, name, **labels)


def _model_pair(widths):
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**widths))
    tm = LlamaForCausalLM(llama_tiny(**widths), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def sides():
    jl, tl = _model_pair(LLAMA)
    jt, tt = _model_pair(TINY)
    jax_side = Side("paddle_tpu", importlib.import_module("paddle_tpu.faults"),
                    importlib.import_module("paddle_tpu.metrics"), JaxEngine,
                    JaxPool, JaxBackpressure, {"llama": jl, "tiny": jt})
    torch_side = Side(
        "paddle_tpu_torch", importlib.import_module("paddle_tpu_torch.faults"),
        importlib.import_module("paddle_tpu_torch.metrics"), ServingEngine,
        PagedKVCachePool, BackpressureError, {"llama": tl, "tiny": tt},
        {"device": "cpu"})
    return jax_side, torch_side


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    """No armed fault survives a test, in either package."""
    mods = [importlib.import_module(f"{p}.faults") for p in PACKAGES]
    for m in mods:
        m.reset()
    yield
    for m in mods:
        assert m.active_faults() == []
        m.reset()


def _both(sides, drill, **kw):
    """Run ``drill`` through both packages; the outcomes must be equal."""
    want = drill(sides[0], **kw)
    got = drill(sides[1], **kw)
    assert got == want
    return got


# ─────────────────────────── the primitives, per package ───────────────────


@pytest.fixture(params=PACKAGES)
def F(request):
    return importlib.import_module(f"{request.param}.faults")


@pytest.fixture
def M(F):
    return importlib.import_module(F.__name__.replace(".faults", ".metrics"))


class TestFaultPoints:
    def test_unarmed_point_is_free_and_inert(self, F):
        F.point("nonexistent.point")

    def test_scoping_is_hermetic(self, F):
        with F.inject("t.scope", raise_=F.FaultInjected):
            with pytest.raises(F.FaultInjected):
                F.point("t.scope")
        F.point("t.scope")

    def test_raise_once_schedule(self, F):
        with F.inject("t.once", raise_=RuntimeError, times=1) as spec:
            with pytest.raises(RuntimeError):
                F.point("t.once")
            for _ in range(5):
                F.point("t.once")
        assert spec.fired == 1 and spec.hits == 6

    def test_every_n_and_after_schedule(self, F):
        fired = []
        with F.inject("t.sched", call=lambda: fired.append(1), every=3,
                      after=2) as spec:
            for _ in range(11):
                F.point("t.sched")
        assert spec.hits == 11 and len(fired) == 3

    def test_probability_gate_is_seeded_deterministic(self, F):
        def count(seed):
            with F.inject("t.p", call=lambda: None, p=0.5,
                          seed=seed) as spec:
                for _ in range(50):
                    F.point("t.p")
            return spec.fired

        a, b = count(3), count(3)
        assert a == b and 0 < a < 50
        assert count(4) != a or count(5) != a

    def test_raise_instance_and_class_and_exhaustion_type(self, F):
        with F.inject("t.inst", raise_=ValueError("specific"), times=1):
            with pytest.raises(ValueError, match="specific"):
                F.point("t.inst")
        with F.inject("t.cls", raise_=F.ResourceExhausted, times=1):
            with pytest.raises(F.ResourceExhausted, match="t.cls"):
                F.point("t.cls")

    def test_firing_increments_point_labeled_metric(self, F, M):
        name = "paddle_tpu_faults_injected_total"
        before = _counter(M, name, point="t.metric")
        with F.inject("t.metric", delay_s=0.0001, times=2):
            for _ in range(3):
                F.point("t.metric")
        assert _counter(M, name, point="t.metric") == before + 2

    def test_spec_validation(self, F):
        with pytest.raises(ValueError, match="do something"):
            F.FaultSpec("t.x")
        with pytest.raises(ValueError):
            F.FaultSpec("t.x", delay_s=1, every=0)
        with pytest.raises(ValueError):
            F.FaultSpec("t.x", delay_s=1, p=1.5)

    def test_known_points_catalog_covers_serving(self, F):
        importlib.import_module(F.__name__.replace(".faults", ".serving"))
        pts = F.known_points()
        for name in ("serving.step", "serving.prefill",
                     "serving.decode_step", "serving.compile_step",
                     "serving.kv_alloc", "tracing.dump"):
            assert name in pts and pts[name]


class TestRetryAndDeadline:
    def test_backoff_delays_deterministic_capped(self, F):
        kw = dict(base_delay_s=0.1, factor=2.0, max_delay_s=0.5, jitter=0.5,
                  seed=9)
        a = list(F.backoff_delays(6, **kw))
        assert a == list(F.backoff_delays(6, **kw)) and len(a) == 5
        assert all(d <= 0.5 for d in a)
        assert list(F.backoff_delays(4, base_delay_s=0.1, jitter=0.0,
                                     max_delay_s=10.0)) == [0.1, 0.2, 0.4]

    def test_retry_recovers_and_reraises_original(self, F, M):
        slept, calls = [], []
        before = _counter(M, "paddle_tpu_faults_retries_total")

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert F.retry(flaky, attempts=3, base_delay_s=0.01,
                       sleep=slept.append) == "ok"
        assert len(calls) == 3 and len(slept) == 2
        assert _counter(M, "paddle_tpu_faults_retries_total") == before + 2
        with pytest.raises(OSError, match="always"):
            F.retry(lambda: (_ for _ in ()).throw(OSError("always")),
                    attempts=2, base_delay_s=0.0, sleep=lambda d: None)

    def test_retry_honors_deadline(self, F):
        t = [0.0]
        dl = F.Deadline(1.0, clock=lambda: t[0])

        def fail():
            t[0] += 0.7
            raise OSError("transient")

        with pytest.raises(F.DeadlineExceeded) as ei:
            F.retry(fail, attempts=10, base_delay_s=0.0,
                    sleep=lambda d: None, deadline=dl)
        assert isinstance(ei.value.__cause__, OSError)

    def test_deadline_basics(self, F):
        assert not F.Deadline.never().expired()
        assert F.Deadline.never().remaining() == float("inf")
        assert F.Deadline(-1).expired()
        t = [0.0]
        dl = F.Deadline(2.0, clock=lambda: t[0])
        assert not dl.expired() and dl.remaining() == 2.0
        t[0] = 2.5
        assert dl.expired()
        with pytest.raises(F.DeadlineExceeded, match="decode"):
            dl.check("decode")


class TestStepWatchdog:
    def test_trip_recover_state_machine(self, F):
        wd = F.StepWatchdog(stall_threshold_s=1.0, recovery_steps=2)
        assert wd.end_step(0.5) is False and wd.status() == "ok"
        assert wd.end_step(1.5) is True
        assert wd.end_step(2.0) is False
        assert wd.trips == 1 and wd.status() == "degraded"
        wd.end_step(0.1)
        assert wd.status() == "degraded"
        wd.end_step(0.1)
        assert wd.status() == "ok"
        assert wd.end_step(9.9) is True and wd.trips == 2

    def test_stalled_now_detects_live_hang_from_other_thread(self, F):
        t = [0.0]
        wd = F.StepWatchdog(stall_threshold_s=1.0, clock=lambda: t[0])
        wd.begin_step()
        t[0] = 0.5
        assert not wd.stalled_now() and wd.status() == "ok"
        t[0] = 1.6
        assert wd.stalled_now() and wd.status() == "degraded"
        assert wd.end_step() is True


class TestLockSanitizer:
    """The lock sanitizer, once per package: it must see actual
    cross-thread acquisition order."""

    def test_consistent_order_is_clean(self, F, M):
        import threading
        san = F.LockSanitizer(order=("router", "engine"))
        a = san.wrap(threading.Lock(), "router")
        b = san.wrap(threading.Lock(), "engine")

        def fwd():
            for _ in range(20):
                with a:
                    with b:
                        pass
        t = threading.Thread(target=fwd)
        t.start()
        t.join()
        with a:
            with b:
                pass
        san.assert_clean()
        assert san.report() == "LockSanitizer: clean"

    def test_two_thread_inversion_detected(self, F, M):
        import threading
        san = F.LockSanitizer(order=("router", "engine"))
        a = san.wrap(threading.Lock(), "router")
        b = san.wrap(threading.Lock(), "engine")
        with a:
            with b:
                pass

        def rev():   # never concurrent with fwd — no real deadlock,
            with b:  # but the hazard must still be reported
                with a:
                    pass
        t = threading.Thread(target=rev)
        t.start()
        t.join()
        kinds = {v.kind for v in san.violations}
        assert "order-inversion" in kinds
        assert "canonical-order" in kinds   # rank check needs no 2nd path
        inv = next(v for v in san.violations
                   if v.kind == "order-inversion")
        assert inv.locks == ("engine", "router")
        assert "router -> engine" in inv.detail   # both witnesses named
        assert "engine -> router" in inv.detail
        with pytest.raises(AssertionError, match="order-inversion"):
            san.assert_clean()

    def test_rlock_reentry_is_legal(self, F, M):
        import threading
        san = F.LockSanitizer()
        r = san.wrap(threading.RLock(), "r")
        with r:
            with r:
                assert r.locked()   # owned-by-me for the RLock duck type
        san.assert_clean()

    def test_nonreentrant_reacquire_raises_instead_of_deadlocking(self, F, M):
        import threading
        san = F.LockSanitizer()
        p = san.wrap(threading.Lock(), "p")
        with p:
            with pytest.raises(RuntimeError, match="would deadlock"):
                p.acquire()
        assert [v.kind for v in san.violations] == [
            "non-reentrant-reacquire"]

    def test_leaf_lock_must_not_nest(self, F, M):
        import threading
        san = F.LockSanitizer(leaves=("metrics.registry",))
        leaf = san.wrap(threading.Lock(), "metrics.registry")
        other = san.wrap(threading.Lock(), "other")
        with other:      # acquiring a leaf while holding others: fine
            with leaf:
                pass
        san.assert_clean()
        # a fresh sanitizer (so the reverse edge above doesn't ALSO
        # read as an inversion): holding a leaf across an acquisition
        san2 = F.LockSanitizer(leaves=("metrics.registry",))
        leaf2 = san2.wrap(threading.Lock(), "metrics.registry")
        other2 = san2.wrap(threading.Lock(), "other")
        with leaf2:
            with other2:
                pass
        assert [v.kind for v in san2.violations] == ["leaf-holds"]

    def test_attach_restores_and_metrics_flow(self, F, M):
        import threading

        class Holder:
            def __init__(self):
                self._lock = threading.Lock()

        h = Holder()
        san = F.LockSanitizer()
        orig = san.attach(h, "_lock", "holder")
        hold0 = M.get_registry().get(
            "paddle_tpu_lock_hold_seconds").labels(lock="holder").count
        wait0 = M.get_registry().get(
            "paddle_tpu_lock_wait_seconds").labels(lock="holder").count
        with h._lock:
            pass
        assert M.get_registry().get(
            "paddle_tpu_lock_hold_seconds").labels(
                lock="holder").count == hold0 + 1
        assert M.get_registry().get(
            "paddle_tpu_lock_wait_seconds").labels(
                lock="holder").count == wait0 + 1
        h._lock = orig          # the finally-restore idiom
        assert h._lock is orig

    def test_violations_deduplicate(self, F, M):
        import threading
        san = F.LockSanitizer()
        a = san.wrap(threading.Lock(), "a")
        b = san.wrap(threading.Lock(), "b")

        def once(first, second):
            with first:
                with second:
                    pass
        v0 = M.get_registry().get(
            "paddle_tpu_lock_order_violations_total").value
        for _ in range(5):      # same inversion five times -> one record
            t = threading.Thread(target=once, args=(a, b))
            t.start()
            t.join()
            t = threading.Thread(target=once, args=(b, a))
            t.start()
            t.join()
        inv = [v for v in san.violations if v.kind == "order-inversion"]
        assert len(inv) == 1
        assert M.get_registry().get(
            "paddle_tpu_lock_order_violations_total").value == v0 + 1


# ─────────────────────────── serving drills, both engines ───────────────────


def _recorder(log):
    """A four-argument stream callback appending (token, finished, seq)."""
    def cb(rid, token, finished, seq):
        log.setdefault(rid, []).append((token, finished, seq))
    return cb


def _outcome(out):
    return (out.finish_reason, out.n_gen, list(map(int, out.token_ids)))


def drill_nan_quarantine(side, kv_dtype):
    """Poison one sequence's KV mid-decode: it retires "nan" with the
    tokens before the poisoned step, its mate's stream equals a
    fault-free run's, every page comes back, each bucket built once."""
    ref_eng = side.engine(page_size=4, max_batch_slots=2, kv_dtype=kv_dtype)
    rm = ref_eng.add_request(P5, max_new_tokens=8)
    ref_eng.add_request(P9, max_new_tokens=8)
    ref = ref_eng.run()
    nan0 = side.counter("paddle_tpu_serving_nan_quarantines_total")
    jit0 = side.counter("paddle_tpu_jit_compiles_total", fn="serving_step")
    eng = side.engine(page_size=4, max_batch_slots=2, kv_dtype=kv_dtype)
    log = {}
    mate = eng.add_request(P5, max_new_tokens=8, stream_cb=_recorder(log))
    victim = eng.add_request(P9, max_new_tokens=8, stream_cb=_recorder(log))
    eng.step()
    poisoned = []
    with side.faults.inject(
            "serving.decode_step",
            call=lambda: poisoned.append(eng.pool.poison_seq(victim)),
            times=1) as spec:
        outs = eng.run()
    counts = eng.compile_counts()
    return dict(
        fired=spec.fired, poisoned=poisoned,
        victim=_outcome(outs[victim]), mate=_outcome(outs[mate]),
        mate_equals_ref=list(outs[mate].token_ids) == list(ref[rm].token_ids),
        callbacks=[log[mate], log[victim]], used=eng.pool.used_pages,
        nan=side.counter("paddle_tpu_serving_nan_quarantines_total") - nan0,
        builds=counts["step"] == counts["step_buckets"],
        jit=side.counter("paddle_tpu_jit_compiles_total",
                         fn="serving_step") - jit0 == counts["step"])


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_nan_quarantine_no_poison_invariant(sides, kv_dtype):
    got = _both(sides, drill_nan_quarantine, kv_dtype=kv_dtype)
    assert got["fired"] == 1 and got["poisoned"][0] > 0
    assert got["victim"][0] == "nan" and 1 <= got["victim"][1] < 8
    assert got["mate"][0] == "length" and got["mate_equals_ref"]
    assert got["used"] == 0 and got["nan"] == 1
    assert got["builds"] and got["jit"]
    # the victim's terminal call carries its token count, no garbage token
    assert got["callbacks"][1][-1] == (None, "nan", got["victim"][1])


def _poison_parameters(model):
    if isinstance(model, LlamaForCausalLM):
        with torch.no_grad():
            for p in model.parameters():
                p.data.fill_(float("nan"))
        return
    import jax.numpy as jnp

    for p in model.parameters():
        p._value = jnp.full_like(p._value, jnp.nan)


def drill_prefill_nan(side):
    """Every parameter NaN (in place, on the port): the request retires
    "nan" before any token streams or any page stays held."""
    model = side.models["nan"]
    eng = side.engine_cls(model, page_size=4, max_batch_slots=1, **side.kw)
    streamed = []
    rid = eng.add_request(np.arange(1, 5), max_new_tokens=4,
                          stream_cb=lambda r, t, d: streamed.append((t, d)))
    outs = eng.run()
    return _outcome(outs[rid]), eng.pool.used_pages, streamed


def test_prefill_nan_quarantined_before_any_token(sides):
    jm, tm = _model_pair(TINY)
    _poison_parameters(jm)
    _poison_parameters(tm)
    sides[0].models["nan"], sides[1].models["nan"] = jm, tm
    got = _both(sides, drill_prefill_nan)
    assert got == (("nan", 0, []), 0, [(None, "nan")])


def drill_pool_exhaustion_mid_decode(side):
    eng = side.engine(page_size=4, max_batch_slots=2)
    victim = eng.add_request(P4, max_new_tokens=6)
    mate = eng.add_request(P3, max_new_tokens=6)
    queued = eng.add_request(P3, max_new_tokens=4)
    eng.step()
    err0 = side.counter("paddle_tpu_serving_request_errors_total")
    with side.faults.inject("serving.kv_alloc",
                            raise_=side.faults.ResourceExhausted, times=1):
        outs = eng.run()
    counts = eng.compile_counts()
    return (len(outs), _outcome(outs[victim]),
            "ResourceExhausted" in outs[victim].error,
            _outcome(outs[mate]), _outcome(outs[queued]),
            eng.pool.used_pages,
            side.counter("paddle_tpu_serving_request_errors_total") - err0,
            counts["step"] == counts["step_buckets"])


def test_page_pool_exhaustion_mid_decode_drains(sides):
    got = _both(sides, drill_pool_exhaustion_mid_decode)
    n, victim, named, mate, queued, used, errors, builds = got
    assert n == 3 and victim[0] == "error" and named
    assert mate[:2] == ("length", 6) and queued[0] == "length"
    assert used == 0 and errors == 1 and builds


def drill_exhaustion_in_prefill_allocate(side):
    eng = side.engine("tiny", page_size=4, max_batch_slots=1)
    rid = eng.add_request(np.arange(1, 7), max_new_tokens=2)
    ok = eng.add_request(np.arange(1, 4), max_new_tokens=2)
    with side.faults.inject("serving.kv_alloc",
                            raise_=side.faults.ResourceExhausted, times=1,
                            after=1):
        outs = eng.run()
    return (_outcome(outs[rid]), _outcome(outs[ok]), eng.pool.used_pages,
            eng.pool.has_seq(rid))


def test_exhaustion_during_prefill_allocate_rolls_back(sides):
    rid, ok, used, held = _both(sides, drill_exhaustion_in_prefill_allocate)
    assert rid[:2] == ("error", 0) and ok[0] == "length"
    assert used == 0 and not held


def drill_pool_allocate_rollback(side):
    pool = side.pool(num_layers=1, num_pages=9, page_size=4, n_kv_heads=2,
                     head_dim=8)
    with side.faults.inject("serving.kv_alloc",
                            raise_=side.faults.ResourceExhausted, after=1):
        with pytest.raises(side.faults.ResourceExhausted):
            pool.allocate("a", 10)
    state = (pool.used_pages, pool.has_seq("a"), sorted(pool._free))
    return state, pool.allocate("b", 10)


def test_pool_allocate_rollback_unit(sides):
    (used, held, free), table = _both(sides, drill_pool_allocate_rollback)
    assert used == 0 and not held and free == list(range(1, 9))
    assert len(table) == 3


def drill_compile_retry(side):
    eng = side.engine("tiny", page_size=4, max_batch_slots=1)
    retries0 = side.counter("paddle_tpu_faults_retries_total")
    rid = eng.add_request(np.arange(1, 5), max_new_tokens=3)
    with side.faults.inject("serving.compile_step",
                            raise_=RuntimeError("flaky build"),
                            times=1) as sp:
        outs = eng.run()
    counts = eng.compile_counts()
    return (sp.fired, _outcome(outs[rid]),
            side.counter("paddle_tpu_faults_retries_total") - retries0,
            counts["step"] == counts["step_buckets"])


def test_compile_failure_retried_compiles_once(sides):
    fired, out, retries, builds = _both(sides, drill_compile_retry)
    assert fired == 1 and out[:2] == ("length", 3)
    assert retries == 1 and builds


def drill_deadlines(side):
    eng = side.engine("tiny", page_size=4, max_batch_slots=1)
    t0 = side.counter("paddle_tpu_serving_request_timeouts_total")
    e0 = side.counter("paddle_tpu_serving_expired_total")
    log = {}
    live = eng.add_request(np.arange(1, 5), max_new_tokens=4,
                           stream_cb=_recorder(log))
    dead = eng.add_request(np.arange(1, 4), max_new_tokens=4,
                           deadline_s=0.0, stream_cb=_recorder(log))
    eng.step()
    after_one = (side.counter("paddle_tpu_serving_expired_total") - e0,
                 side.counter("paddle_tpu_serving_request_timeouts_total")
                 - t0)
    eng.slots[0].req.deadline = side.faults.Deadline(-1.0)
    outs = eng.run()
    return (after_one, _outcome(outs[dead]), _outcome(outs[live]),
            side.counter("paddle_tpu_serving_request_timeouts_total") - t0,
            side.counter("paddle_tpu_serving_expired_total") - e0,
            eng.pool.used_pages, [log[live], log[dead]])


def test_deadline_expiry_queued_and_mid_decode(sides):
    got = _both(sides, drill_deadlines)
    after_one, dead, live, timeouts, expired, used, calls = got
    assert after_one == (1, 0)
    assert dead[:2] == ("expired", 0) and live[0] == "timeout"
    assert 1 <= live[1] < 4
    assert timeouts == 1 and expired == 1 and used == 0
    assert calls[1] == [(None, "expired", 0)]
    assert calls[0][-1] == (None, "timeout", live[1])


def drill_cancel(side):
    eng = side.engine("tiny", page_size=4, max_batch_slots=1)
    c0 = side.counter("paddle_tpu_serving_cancellations_total")
    running = eng.add_request(np.arange(1, 5), max_new_tokens=6)
    waiting = eng.add_request(np.arange(1, 4), max_new_tokens=6)
    eng.step()
    seen = [eng.cancel(waiting), eng.scheduler.queue_depth,
            eng.cancel(running), eng.pool.used_pages, eng.slots[0] is None,
            eng.cancel(running), eng.cancel("no-such-id")]
    outs = eng.run()
    return (seen, _outcome(outs[waiting]), _outcome(outs[running]),
            side.counter("paddle_tpu_serving_cancellations_total") - c0)


def test_cancel_while_queued_and_while_decoding(sides):
    seen, waiting, running, cancels = _both(sides, drill_cancel)
    assert seen == [True, 0, True, 0, True, False, False]
    assert waiting[:2] == ("cancelled", 0)
    assert running[0] == "cancelled" and running[1] >= 1
    assert cancels == 2


def drill_cancel_reentrant(side):
    # mid-prefill: cancel on the first streamed token
    eng1 = side.engine("tiny", page_size=4, max_batch_slots=1)
    r1 = eng1.add_request(np.arange(1, 5), max_new_tokens=4,
                          stream_cb=lambda rid, tok, done: eng1.cancel(rid)
                          if not done else None)
    o1 = eng1.run()
    first = (_outcome(o1[r1]), eng1.pool.used_pages, eng1.slots[0] is None)
    # mid-decode, on the token that would have finished the request
    eng2 = side.engine("tiny", page_size=4, max_batch_slots=1)
    seen = []

    def cb(rid, tok, done):
        if not done:
            seen.append(tok)
            if len(seen) == 2:
                eng2.cancel(rid)

    r2 = eng2.add_request(np.arange(1, 5), max_new_tokens=2, stream_cb=cb)
    o2 = eng2.run()
    second = (_outcome(o2[r2]), eng2.pool.used_pages, eng2.slots[0] is None)
    # four arguments: seq 0, 1, 2, and the terminal call gets the count
    eng3 = side.engine("tiny", page_size=4, max_batch_slots=1)
    calls = []

    def cb4(rid, tok, done, seq):
        calls.append((tok, done, seq))
        if seq == 2 and not done:
            eng3.cancel(rid)

    r3 = eng3.add_request(np.arange(1, 5), max_new_tokens=6, stream_cb=cb4)
    o3 = eng3.run()
    third = (_outcome(o3[r3]), eng3.pool.used_pages, calls)
    return first, second, third


def test_cancel_reentrant_from_stream_callback(sides):
    first, second, third = _both(sides, drill_cancel_reentrant)
    assert first[0][0] == "cancelled" and first[0][1] <= 1
    assert first[1:] == (0, True)
    assert second[0][0] == "cancelled" and second[1:] == (0, True)
    out, used, calls = third
    assert out[:2] == ("cancelled", 3) and used == 0
    assert [c[2] for c in calls] == [0, 1, 2, 3]
    assert calls[-1][:2] == (None, "cancelled")


def drill_backpressure(side):
    eng = side.engine("tiny", page_size=4, max_batch_slots=1, max_queue=1)
    rej0 = side.counter("paddle_tpu_serving_queue_rejections_total")
    ok = eng.add_request(np.arange(1, 4), max_new_tokens=2)
    with pytest.raises(side.backpressure, match="max_queue=1") as ei:
        eng.add_request(np.arange(1, 4), max_new_tokens=2)
    hint = (ei.value.retry_after_s > 0, ei.value.queue_depth)
    rejected = side.counter("paddle_tpu_serving_queue_rejections_total") - rej0
    outs = eng.run()
    again = eng.add_request(np.arange(1, 4), max_new_tokens=1)
    return hint, rejected, _outcome(outs[ok]), _outcome(eng.run()[again])


def test_bounded_queue_backpressure_retry_after(sides):
    hint, rejected, ok, again = _both(sides, drill_backpressure)
    assert hint == (True, 1) and rejected == 1
    assert ok[0] == "length" and again[:2] == ("length", 1)


def drill_callback_isolated(side):
    eng = side.engine(page_size=4, max_batch_slots=2)
    cb0 = side.counter("paddle_tpu_serving_callback_errors_total")
    seen = []

    def bad_cb(rid, tok, done):
        seen.append(tok)
        if len(seen) >= 2:
            raise ValueError("user callback bug")

    bad = eng.add_request(P5, max_new_tokens=6, stream_cb=bad_cb)
    good = eng.add_request(P9, max_new_tokens=6)
    outs = eng.run()
    return (_outcome(outs[bad]), "user callback bug" in outs[bad].error,
            _outcome(outs[good]),
            side.counter("paddle_tpu_serving_callback_errors_total") - cb0,
            eng.pool.used_pages, seen)


def test_stream_callback_exception_isolated(sides):
    bad, named, good, errors, used, seen = _both(sides,
                                                 drill_callback_isolated)
    assert bad[:2] == ("error", 2) and named
    assert good[:2] == ("length", 6) and errors == 1 and used == 0
    assert len(seen) == 2


def drill_watchdog_healthz(side):
    """A step delayed past the threshold trips the watchdog: ``/healthz``
    503 and ``degraded`` 1; two healthy (empty) steps recover it. The
    threshold and the delay are generous: the states are compared, never
    the times."""
    eng = side.engine("tiny", page_size=4, max_batch_slots=1,
                      watchdog_stall_s=0.05, watchdog_recovery_steps=2)
    trips0 = side.counter("paddle_tpu_serving_watchdog_trips_total")
    lbl = dict(engine_id=eng.engine_id, model_id=eng.model_id)
    seen = []
    with side.metrics.MetricsServer(health_cb=eng.health, port=0) as srv:
        url = f"{srv.url}/healthz"
        with urllib.request.urlopen(url, timeout=10) as r:
            seen.append((r.status, json.loads(r.read())["status"]))
        with side.faults.inject("serving.step", delay_s=0.25, times=1):
            eng.step()
        seen.append(side.counter("paddle_tpu_serving_watchdog_trips_total")
                    - trips0)
        seen.append(side.counter("paddle_tpu_serving_degraded", **lbl))
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=10)
        seen.append((ei.value.code, json.loads(ei.value.read())["status"]))
        eng.step()
        eng.step()
        seen.append(side.counter("paddle_tpu_serving_degraded", **lbl))
        with urllib.request.urlopen(url, timeout=10) as r:
            seen.append((r.status, json.loads(r.read())["status"]))
    seen.append(side.counter("paddle_tpu_serving_watchdog_trips_total")
                - trips0)
    return seen


def test_watchdog_trips_healthz_degrades_and_recovers(sides):
    got = _both(sides, drill_watchdog_healthz)
    assert got == [(200, "ok"), 1, 1.0, (503, "degraded"), 0.0, (200, "ok"),
                   1]


def drill_step_crash_closes_bracket(side):
    eng = side.engine("tiny", page_size=4, max_batch_slots=1,
                      watchdog_stall_s=0.05)
    with side.faults.inject("serving.step", raise_=side.faults.FaultInjected,
                            times=1):
        with pytest.raises(side.faults.FaultInjected):
            eng.step()
    time.sleep(0.1)  # idle past the threshold
    return eng.watchdog.stalled_now(), eng.health()["status"]


def test_step_crash_closes_watchdog_bracket(sides):
    assert _both(sides, drill_step_crash_closes_bracket) == (False, "ok")


# ─────────────────────── refcount-aware scrub, both pools ───────────────────


def _filled_pool(side):
    pool = side.pool(num_layers=1, num_pages=9, page_size=4, n_kv_heads=2,
                     head_dim=8)
    if side.name == "paddle_tpu":
        import jax.numpy as jnp

        k = jnp.full((9, 4, 2, 8), 7.0, jnp.float32)
        pool.set_arrays([k], [k + 1.0])
    else:
        pool.k_pools[0].fill_(7.0)
        pool.v_pools[0].fill_(8.0)
    return pool


def _pages(pool, table, kind="k"):
    t = (pool.k_pools if kind == "k" else pool.v_pools)[0]
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t._value)
    return t[np.asarray(table)]


def drill_scrub_defers(side):
    pool = _filled_pool(side)
    ptrs = ([t.data_ptr() for t in pool.k_pools + pool.v_pools]
            if side.name == "paddle_tpu_torch" else None)
    pool.allocate("src", 6)
    table = pool.block_table("src")
    pool.fork("src", "dst")
    pool.free("src", scrub=True)
    held = (pool.used_pages, bool((_pages(pool, table) == 7.0).all()))
    pool.free("dst")
    t2 = pool.allocate("new", 8)
    scrubbed = (bool((_pages(pool, table) == 0.0).all()),
                bool((_pages(pool, table, "v") == 0.0).all()))
    if ptrs is not None:  # scrubbed in place, never rebound
        assert [t.data_ptr() for t in pool.k_pools + pool.v_pools] == ptrs
    return held, pool.used_pages, set(table) <= set(t2), scrubbed


def test_scrub_defers_while_sibling_holds_reference(sides):
    held, used, reused, scrubbed = _both(sides, drill_scrub_defers)
    assert held == (2, True) and used == 2 and reused
    assert scrubbed == (True, True)


def drill_poison_refuses_shared(side):
    pool = _filled_pool(side)
    pool.allocate("src", 6)
    src_table = pool.block_table("src")
    pool.fork("src", "dst")
    with pytest.raises(ValueError, match="shared"):
        pool.poison_seq("src")
    pool.extend("dst", 7)
    n = pool.poison_seq("dst")
    dst_tail = _pages(pool, pool.block_table("dst")[1:])
    return (n, bool(np.isfinite(_pages(pool, src_table)).all()),
            int(np.isnan(dst_tail).sum()))


def test_poison_seq_refuses_shared_pages_poisons_exclusive(sides):
    n, src_finite, nans = _both(sides, drill_poison_refuses_shared)
    assert n == 3 and src_finite and nans == 3 * 2 * 8


def drill_suspect_prefix_evicted(side):
    eng = side.engine(page_size=4, max_batch_slots=2)
    lbl = dict(engine_id=eng.engine_id, model_id=eng.model_id)
    healthy_p = np.random.RandomState(50).randint(0, 128, (5,))
    victim_p = np.random.RandomState(99).randint(0, 128, (9,))
    eng.add_request(healthy_p, max_new_tokens=2)
    eng.run()
    victim = eng.add_request(victim_p, max_new_tokens=8)
    eng.step()
    with side.faults.inject("serving.decode_step",
                            call=lambda: eng.pool.poison_seq(victim),
                            times=1):
        outs = eng.run()
    h0 = side.counter("paddle_tpu_serving_prefix_hits_total", **lbl)
    m0 = side.counter("paddle_tpu_serving_prefix_misses_total", **lbl)
    again = eng.add_request(victim_p, max_new_tokens=2)
    o1 = eng.run()
    missed = side.counter("paddle_tpu_serving_prefix_misses_total",
                          **lbl) - m0
    healthy = eng.add_request(healthy_p, max_new_tokens=2)
    o2 = eng.run()
    hit = side.counter("paddle_tpu_serving_prefix_hits_total", **lbl) - h0
    return (_outcome(outs[victim]), missed, hit, _outcome(o1[again]),
            _outcome(o2[healthy]), eng.pool.used_pages)


def test_nan_quarantine_evicts_suspect_prefix_nodes(sides):
    victim, missed, hit, again, healthy, used = _both(
        sides, drill_suspect_prefix_evicted)
    assert victim[0] == "nan" and missed == 1 and hit == 1
    assert again[0] == healthy[0] == "length" and used == 0


# ─────────────────────────────── the port's own ──────────────────────────────


def test_step_program_failure_propagates_unretried(sides, monkeypatch):
    """A failure of the step itself (the model, the kernel, a capture) is
    not a request's fault: it leaves ``step()`` at once, retried by
    nothing, no request retired for it, and the watchdog's bracket
    closes behind it."""
    eng = sides[1].engine("tiny", page_size=4, max_batch_slots=1,
                          watchdog_stall_s=0.05)
    rid = eng.add_request(np.arange(1, 5), max_new_tokens=3)
    calls = []

    def broken(self, batch):
        calls.append(self.T)
        raise RuntimeError("CUDA error: an illegal memory access")

    retries0 = sides[1].counter("paddle_tpu_faults_retries_total")
    monkeypatch.setattr(torch_engine._StepProgram, "__call__", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.step()
    assert len(calls) == 1
    assert sides[1].counter("paddle_tpu_faults_retries_total") == retries0
    assert eng.take_outputs() == {} and eng.slots[0].req.req_id == rid
    time.sleep(0.1)
    assert not eng.watchdog.stalled_now()
    assert eng.compile_counts()["step"] == 0
    monkeypatch.undo()
    assert eng.run()[rid].finish_reason == "length"


@pytest.fixture
def one_thread():
    """Its hundreds of small steps run on one intra-op thread: tiny
    tensors gain nothing from more, and beside other test processes the
    threads' contention costs more than the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_chaos_drills_on_the_cpu(one_thread):
    """``tools/serve_chaos.py``, the card's resilience phase, on the CPU
    at a small size (f32, hidden 64, 2 layers, vocab 256, f32 pages):
    every drill passes its own checks, and the registry's
    ``serving_step`` compiles equal the buckets its engines built."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.tools import serve_chaos

    def model(seed):
        cfg = LlamaConfig(vocab_size=256, hidden_size=64, num_layers=2,
                          num_heads=4, num_key_value_heads=4,
                          max_position_embeddings=256)
        return LlamaForCausalLM(cfg, device="cpu", seed=seed)

    lines = []
    recs = serve_chaos.run_drills(
        model(0), model(1), log=lines.append,
        engine_kw=dict(device="cpu", max_model_len=256,
                       kv_dtype=torch.float32))
    assert len(lines) == 9 and all(line.startswith("chaos ") for line in lines)
    assert [recs[k]["kv_dtype"] for k in (
        "nan_quarantine", "nan_quarantine_int8")] == ["float32", "int8"]
    assert recs["nan_quarantine_tenancy"]["mates_equal"] == 7
    assert recs["deadlines_cancel"]["reentrant_seqs"] == [0, 1, 2, 3]
    m = recs["metrics"]
    assert m["compiles_serving_step"] == m["buckets"] > 0
    assert m["reasons"]["nan"] == 4 and m["reasons"]["error"] == 1
