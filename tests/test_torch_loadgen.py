"""paddle_tpu_torch.loadgen against the JAX package's.

- Traces: :func:`generate_trace` is a pure function of ``TraceConfig``
  from one numpy generator, so the port's traces must equal the JAX
  package's byte for byte (``to_jsonl``) for every knob: bursts, tiers,
  Zipf families, slow consumers, adapter and schema mixes.
- The driver: the same trace replayed by ``LoadDriver`` against a
  one-engine fleet of each package (the tiny Llama of
  ``tests/test_loadgen.py``, weights carried by
  ``load_reference_state_dict``): the exactly-once accounting holds and
  every field that does not read a wall clock is equal (outcomes,
  submissions, steps, tokens delivered, prefix-hit ratio, per-tenant
  keys, grammar validity). With the autoscaler, a fault schedule and the
  overload controller on a small fleet, placement reads the wall-clock
  step EWMA, so the equal fields are the accounting: exactly-once, the
  outcome count and the fleet's final size.
- The autoscaler's hysteresis over a host-only fleet double: the same
  depth sequence gives the same scale events in both packages.
- The restart drill on the CPU (three child processes of the port):
  every stream is bit-identical across the SIGKILL with seqs
  exactly-once; the recovering child built no kernel and counted one
  capture (on the CPU: one program) per bucket of its own engine.
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
WIDTHS = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=2,
              num_key_value_heads=1, max_position_embeddings=64)
ENGINE_KW = dict(page_size=4, max_batch_slots=2, token_budget=32,
                 watchdog_stall_s=None)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


TRACE_CASES = {
    "default": dict(seed=0),
    "burst": dict(seed=42, num_requests=40, arrival_rate=12.0,
                  burst_start=0.3, burst_duration=1.0, burst_factor=5.0,
                  slow_consumer_fraction=0.1),
    "tiers": dict(seed=7, num_requests=30, vocab_size=32000,
                  num_prompt_families=3, prefix_len=64, max_prompt_len=320,
                  suffix_len_mean=96.0, output_len_mean=24.0,
                  max_output_len=32, tiers="custom"),
    "tenancy": dict(seed=33, num_requests=14, vocab_size=32,
                    adapter_mix=((None, 0.5), ("acme", 0.5)),
                    schema_mix=((None, 0.5), ("[0-9]{1,6}", 0.5))),
}


def _trace_cfg(pkg, case):
    lg = _mod(pkg, "loadgen")
    kw = dict(TRACE_CASES[case])
    if kw.get("tiers") == "custom":
        kw["tiers"] = (lg.TierSpec("gold", 0, 1.0, None, 1.0, 0.5),
                       lg.TierSpec("std", 1, 2.0, 6.0, 2.0, 1.0),
                       lg.TierSpec("bronze", 2, 1.0, None, 8.0, 4.0))
    return lg.TraceConfig(**kw)


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_equals_jax(case):
    want = _mod("paddle_tpu", "loadgen").generate_trace(
        _trace_cfg("paddle_tpu", case))
    got = _mod("paddle_tpu_torch", "loadgen").generate_trace(
        _trace_cfg("paddle_tpu_torch", case))
    assert got.to_jsonl() == want.to_jsonl()
    assert len(got.requests) == TRACE_CASES[case].get("num_requests", 64)


def test_zipf_and_clock_equal_jax():
    a, b = (_mod(p, "loadgen") for p in PACKAGES)
    for n, s in ((4, 1.2), (9, 0.7)):
        np.testing.assert_array_equal(a.zipf_pmf(n, s), b.zipf_pmf(n, s))
    ca, cb = a.VirtualClock(), b.VirtualClock()
    for dt in (0.1, 0.25, 3.0):
        ca.advance(dt)
        cb.advance(dt)
        assert ca.now() == cb.now()


# ─────────────────────────────── the driver ───────────────────────────────


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return {"paddle_tpu": jm, "paddle_tpu_torch": tm}


def _router(pkg, models, replicas, **extra):
    r = _mod(pkg, "serving").Router(**extra)
    kw = dict(ENGINE_KW)
    if pkg == "paddle_tpu_torch":
        kw["device"] = "cpu"
    r.add_model("m", models[pkg], replicas=replicas, **kw)
    return r


DETERMINISTIC = ("seed", "num_requests", "submitted", "steps",
                 "goodput_tokens", "total_tokens", "outcomes", "rejected",
                 "prefix_hit_ratio", "spec_acceptance", "fresh_compiles",
                 "engines_start", "engines_peak", "engines_final",
                 "scale_ups", "scale_downs", "constrained_validity",
                 "exactly_once", "violations", "unavailable_rate",
                 "timeout_rate", "shed_rate", "expired_rate")


def _replay(pkg, models, case):
    lg = _mod(pkg, "loadgen")
    r = _router(pkg, models, 1)
    if case == "tenancy":
        sv = _mod(pkg, "serving")
        r.register_adapter("acme", sv.random_adapter(
            r.engine("m/0").adapters, seed=6), model="m")
    cfg = dict(seed=3, num_requests=12, vocab_size=32, arrival_rate=10.0,
               prefix_len=5, max_prompt_len=16, max_output_len=6)
    if case == "tenancy":
        cfg.update(adapter_mix=((None, 0.5), ("acme", 0.5)),
                   schema_mix=((None, 0.5), ("[0-9]{1,6}", 0.5)))
    rep = lg.LoadDriver(r, lg.generate_trace(lg.TraceConfig(**cfg))).run()
    d = rep.to_dict()
    out = {k: d[k] for k in DETERMINISTIC}
    out["adapter_goodput_keys"] = sorted(d["adapter_goodput"])
    out["tiers"] = {k: v["requests"] for k, v in d["tiers"].items()}
    out["pages"] = r.engine("m/0").pool.used_pages
    return out


@pytest.mark.parametrize("case", ["plain", "tenancy"])
def test_driver_report_matches_jax(models, case):
    want = _replay("paddle_tpu", models, case)
    got = _replay("paddle_tpu_torch", models, case)
    # the port counts one program per bucket, as the JAX engine compiles
    assert got == want
    assert got["exactly_once"] and got["violations"] == []
    assert sum(got["outcomes"].values()) == 12 and got["pages"] == 0


def _fleet_drill(pkg, models):
    """Autoscaler, a kill with revival, a latency storm and the overload
    controller on a two-engine fleet."""
    lg = _mod(pkg, "loadgen")
    sv = _mod(pkg, "serving")
    r = _router(pkg, models, 1,
                retry_budget=sv.RetryBudget(capacity=16.0,
                                            refill_per_step=1.0))
    scaler = lg.QueueDepthAutoscaler(r, config=lg.AutoscalerConfig(
        min_engines=1, max_engines=3, scale_up_depth=2.0,
        scale_down_depth=0.25, hot_steps=2, cold_steps=6,
        cooldown_steps=6))
    trace = lg.generate_trace(lg.TraceConfig(
        seed=15, num_requests=24, vocab_size=32, arrival_rate=8.0,
        burst_start=0.2, burst_duration=1.0, burst_factor=8.0,
        num_prompt_families=4, prefix_len=6, max_prompt_len=20,
        max_output_len=6))
    schedule = lg.FaultSchedule([
        lg.FaultEvent(t_s=0.1, kind="latency", delay_s=0.002, steps=20),
        lg.FaultEvent(t_s=0.5, kind="kill", engine_index=0, down_s=0.4)])
    ctl = sv.OverloadController(r, config=sv.OverloadConfig(
        hot_backlog_s=0.5, cold_backlog_s=0.1))
    rep = lg.LoadDriver(r, trace, autoscaler=scaler, overload=ctl,
                        fault_schedule=schedule).run()
    return (rep.exactly_once, rep.violations,
            sum(rep.outcomes.values()), rep.engines_final,
            all(e.pool.used_pages == 0 for e in r.engines("m")),
            sorted(r._requeued), rep.engines_peak >= 2)


def test_chaos_fleet_accounting_matches_jax(models):
    want = _fleet_drill("paddle_tpu", models)
    got = _fleet_drill("paddle_tpu_torch", models)
    assert got == want
    assert got[:5] == (True, [], 24, 1, True)


class _FakeSched:
    def __init__(self):
        self.queue_depth = 0
        self.waiting = []


class _FakeEngine:
    def __init__(self):
        self.scheduler = _FakeSched()
        self.avg_step_s = 0.05
        self.has_work = False

    def load_score(self):
        return self.scheduler.queue_depth * self.avg_step_s


class _FakeRouter:
    """Topology and gates of ``pkg``'s router around host-only engines."""

    def __init__(self, pkg, n=1):
        self._rt = _mod(pkg, "serving.router")
        self._hs, self._next = [], 0
        for _ in range(n):
            self._spawn()

    def _spawn(self):
        h = self._rt.EngineHandle(_FakeEngine(), f"m/{self._next}", "m")
        self._next += 1
        self._hs.append(h)
        return h.engine_id

    def _resolve_model(self, model):
        return "m"

    def handles(self, model=None):
        return list(self._hs)

    def states(self):
        return {h.engine_id: h.state for h in self._hs}

    def engine(self, eid):
        return next(h.engine for h in self._hs if h.engine_id == eid)

    def add_engine(self, model):
        return self._spawn()

    def drain(self, eid):
        next(h for h in self._hs if h.engine_id == eid).state = \
            self._rt.DRAINING

    def undrain(self, eid):
        next(h for h in self._hs if h.engine_id == eid).state = \
            self._rt.HEALTHY

    def remove_engine(self, eid):
        h = next(h for h in self._hs if h.engine_id == eid)
        if h.engine.has_work:
            raise ValueError("still has work")
        self._hs.remove(h)


def _scale_trace(pkg, seed):
    lg = _mod(pkg, "loadgen")
    r = _FakeRouter(pkg)
    s = lg.QueueDepthAutoscaler(r, config=lg.AutoscalerConfig(
        min_engines=1, max_engines=4, scale_up_depth=4.0,
        scale_down_depth=1.0, hot_steps=3, cold_steps=3, cooldown_steps=5))
    rng = np.random.default_rng(seed)
    out = []
    for t in range(160):
        depth = int(max(12 * np.sin(t / 15.0) + rng.normal(0, 2), 0))
        for h in r.handles():
            h.engine.scheduler.queue_depth = depth
            h.engine.has_work = depth > 0 and rng.random() < 0.5
        out.append((s.observe(), len(r.handles()),
                    sorted((h.engine_id, h.state) for h in r.handles())))
    return out, list(s.events)


@pytest.mark.parametrize("seed", [0, 1])
def test_autoscaler_decisions_match_jax(seed):
    got = _scale_trace("paddle_tpu_torch", seed)
    assert got == _scale_trace("paddle_tpu", seed)
    kinds = {d for d, _n in got[1]}
    assert {"scale-up", "scale-down"} <= kinds


# ─────────────────────────── the restart drill ───────────────────────────


def test_restart_drill_on_cpu(tmp_path):
    from paddle_tpu_torch.loadgen import restart
    res = restart.run_restart_drill(
        str(tmp_path), replicas_before=2, replicas_after=1, num_requests=6,
        kill_after_chunks=8, device="cpu", size="tiny", timeout_s=240.0)
    ref = restart.streams_by_index(res["ref_chunks"])
    full = restart.streams_by_index(res["pre_chunks"] + res["post_chunks"])
    assert res["killed_after"] < len(res["ref_chunks"])
    assert set(full) == set(ref)
    for idx, chunks in ref.items():
        assert full[idx] == chunks, idx
        assert [s for _t, _f, s in full[idx]] == list(range(len(chunks)))
    timing = res["timing"]
    assert timing["outcomes"].get("resumed", 0) >= 1
    # the port's compile contract: no kernel built; programs only of the
    # recovering process's own engine's buckets
    assert timing["nvcc_runs"] == 0
    assert timing["fresh_compiles"] == timing["captures"] > 0
    assert res["rto_s"] is not None
    for run in ("ref", "killed", "recover"):
        c = res["counts"][run]
        assert c["kernel_launches"] == 0 and c["plain_calls"] > 0, run
