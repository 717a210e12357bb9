"""The port's request tracer against the JAX package's.

The tracer's unit cases (ring, exactly-once audit, TTFT attribution,
flight recorder) run once per package: both ``serving.tracing`` modules
are jax-free and must behave the same (times compared at 1e-12, the
attribution's float residual). Then one workload through the JAX and the
port engine, each with a private tracer on a clock of its own: every
request's sequence of event names, args and labels must be equal, and
each timeline must pass the exactly-once audit.
"""
import importlib
import json
import os
from contextlib import contextmanager

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.serving import ServingEngine

PACKAGES = ("paddle_tpu", "paddle_tpu_torch")
TINY = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=1,
            num_key_value_heads=1, max_position_embeddings=32)
ATOL = 1e-12


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _ev(t, rid, seq, name, arg=0.0, label=""):
    return {"t": t, "req_id": rid, "seq": seq, "name": name, "arg": arg,
            "label": label}


@pytest.fixture(params=PACKAGES)
def pkg(request):
    """(tracing module, faults module, metrics module) of one package."""
    return tuple(importlib.import_module(f"{request.param}.{m}")
                 for m in ("serving.tracing", "faults", "metrics"))


def _counter(metrics_mod, name, **labels):
    fam = metrics_mod.get_registry().get(name)
    if fam is None:
        return 0.0
    return (fam.labels(**labels) if labels else fam).value


class TestRing:
    def test_interleaved_streams_snapshot_in_seq_order(self, pkg):
        tracing = pkg[0]
        clk = _Clock()
        tr = tracing.RequestTracer(capacity=64, clock=clk)
        for i in range(5):
            clk.t = float(i)
            tr.emit("req.token", "a", arg=float(i))
            tr.emit("req.token", "b", arg=float(i), label="m/0")
        a = tr.events_for("a")
        assert [e["seq"] for e in a] == list(range(5))
        assert [e["arg"] for e in a] == [0.0, 1.0, 2.0, 3.0, 4.0]
        assert tr.events_for("b")[0]["label"] == "m/0"
        assert tracing.validate_events(tr.events()) == []
        assert tr.dropped == 0

    def test_wrap_drops_oldest_prefix_and_counts(self, pkg):
        tracing = pkg[0]
        tr = tracing.RequestTracer(capacity=16)
        for _ in range(24):
            tr.emit("req.token", "r")
        assert tr.dropped == 8
        evs = tr.events_for("r")
        assert [e["seq"] for e in evs] == list(range(8, 24))
        assert tracing.validate_events(evs) == []

    def test_validate_flags_dupes_and_holes(self, pkg):
        tracing = pkg[0]
        dupe = [_ev(0.0, "r", 0, "req.token"), _ev(0.1, "r", 0, "req.token")]
        assert any("duplicate" in p for p in tracing.validate_events(dupe))
        hole = [_ev(0.0, "r", 0, "req.token"), _ev(0.2, "r", 2, "req.token")]
        assert any("missing" in p for p in tracing.validate_events(hole))
        assert tracing.validate_events([]) == []

    def test_disabled_emit_journals_nothing(self, pkg):
        tr = pkg[0].RequestTracer(capacity=64, enabled=False)
        tr.emit("req.token", "r")
        assert tr.events() == [] and tr.dropped == 0

    def test_reset_forgets_events_seqs_and_drops(self, pkg):
        tr = pkg[0].RequestTracer(capacity=16)
        for _ in range(20):
            tr.emit("req.token", "r")
        tr.reset()
        assert tr.events() == [] and tr.dropped == 0
        tr.emit("req.token", "r")
        assert tr.events_for("r")[0]["seq"] == 0

    def test_flush_metrics_moves_drop_count_once(self, pkg):
        tracing, _faults, metrics = pkg
        tr = tracing.RequestTracer(capacity=16)
        for _ in range(20):
            tr.emit("req.token", "r")
        name = "paddle_tpu_trace_dropped_events_total"
        tr.flush_metrics()  # the family exists from here on
        before = _counter(metrics, name)
        for _ in range(4):
            tr.emit("req.token", "r")
        tr.flush_metrics()
        assert _counter(metrics, name) == before + 4 and tr.dropped == 0
        tr.flush_metrics()
        assert _counter(metrics, name) == before + 4


class TestAttribution:
    def test_gap_classification_and_exact_sum(self, pkg):
        tracing = pkg[0]
        evs = [_ev(0.2, "r", 0, "req.dispatch", label="m/0"),
               _ev(1.0, "r", 1, "req.admit"),
               _ev(1.5, "r", 2, "req.compile"),
               _ev(2.0, "r", 3, "req.chunk"),
               _ev(2.5, "r", 4, "req.token")]
        bd = tracing.attribute_ttft(evs, t_submit=0.0, t_first=2.75)
        assert set(bd) == set(tracing.TTFT_BUCKETS)
        want = dict(queue=0.8, compile=0.5, cold_prefill=0.5,
                    warm_prefill=0.0, decode=0.5, migration=0.0,
                    host_overhead=0.45)
        for k, v in want.items():
            assert bd[k] == pytest.approx(v, abs=ATOL), k
        assert sum(bd.values()) == pytest.approx(2.75, abs=ATOL)

    def test_prefix_hit_turns_prefill_warm(self, pkg):
        evs = [_ev(1.0, "r", 0, "req.admit"),
               _ev(1.1, "r", 1, "req.prefix_hit", arg=4.0),
               _ev(2.0, "r", 2, "req.chunk")]
        bd = pkg[0].attribute_ttft(evs, t_submit=0.0, t_first=2.0)
        assert bd["warm_prefill"] == pytest.approx(0.9, abs=ATOL)
        assert bd["cold_prefill"] == 0.0
        assert bd["queue"] == pytest.approx(1.1, abs=ATOL)
        assert sum(bd.values()) == pytest.approx(2.0, abs=ATOL)

    def test_empty_window_is_all_host_overhead(self, pkg):
        evs = [_ev(9.0, "r", 7, "req.token")]
        bd = pkg[0].attribute_ttft(evs, t_submit=10.0, t_first=10.5)
        assert bd["host_overhead"] == pytest.approx(0.5, abs=ATOL)
        assert sum(bd.values()) == pytest.approx(0.5, abs=ATOL)


class TestFlightRecorder:
    def test_dump_windows_groups_and_counts(self, pkg, tmp_path):
        tracing, _faults, metrics = pkg
        clk = _Clock()
        tr = tracing.RequestTracer(capacity=64, clock=clk,
                                   flight_dir=str(tmp_path), window_s=5.0)
        tr.emit("req.enqueue", "old")
        clk.t = 10.0
        tr.emit("req.admit", "a")
        tr.emit("req.chunk", "a")
        tr.emit("step.tokens", "m/0", arg=3.0)
        name = "paddle_tpu_trace_recorder_dumps_total"
        fam = metrics.get_registry().get(name)
        before = 0.0 if fam is None else fam.labels(reason="why not+ok").value
        path = tr.dump_flight(reason="why not+ok")
        assert os.path.dirname(path) == str(tmp_path)
        assert "why-not-ok" in os.path.basename(path)
        with open(path) as f:
            payload = json.load(f)
        assert payload["reason"] == "why not+ok"
        assert payload["window_s"] == 5.0
        names = {e["name"] for e in payload["events"]}
        assert names == {"req.admit", "req.chunk", "step.tokens"}
        assert [e["seq"] for e in payload["requests"]["a"]] == [0, 1]
        assert _counter(metrics, name, reason="why not+ok") == before + 1

    def test_dump_fault_point_raises_to_caller(self, pkg, tmp_path):
        tracing, faults, _metrics = pkg
        tr = tracing.RequestTracer(capacity=16, flight_dir=str(tmp_path))
        tr.emit("req.enqueue", "r")
        with faults.inject("tracing.dump", raise_=RuntimeError("disk full"),
                           times=1):
            with pytest.raises(RuntimeError):
                tr.dump_flight(reason="boom")
        assert os.listdir(str(tmp_path)) == []


# ─────────────────── one workload through both engines ───────────────────


@contextmanager
def _fresh(tracing, **kw):
    """A private process tracer, installed before the engine is built
    (an engine takes ``get_tracer()`` at construction)."""
    tracer = tracing.RequestTracer(**kw)
    old = tracing.set_tracer(tracer)
    try:
        yield tracer
    finally:
        tracing.set_tracer(old)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**TINY))
    tm = LlamaForCausalLM(llama_tiny(**TINY), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _workload(engine, faults):
    """Shared-prefix requests (a hit), drafts (2 a step), one request
    expired in the queue, one cancelled mid-decode, one poisoned
    mid-decode; returns the request ids in submission order."""
    rng = np.random.RandomState(7)
    shared = rng.randint(1, 32, (8,))
    rids = [engine.add_request(np.concatenate([shared, [1]]),
                               max_new_tokens=5)]
    engine.run()
    rids.append(engine.add_request(np.concatenate([shared, [2]]),
                                   max_new_tokens=4))
    rids.append(engine.add_request(rng.randint(1, 32, (5,)),
                                   max_new_tokens=6, temperature=0.8, seed=3))
    rids.append(engine.add_request(rng.randint(1, 32, (3,)),
                                   max_new_tokens=4, deadline_s=0.0))
    engine.step()
    engine.cancel(rids[2])
    engine.run()
    victim = engine.add_request(rng.randint(1, 32, (6,)), max_new_tokens=8)
    rids.append(victim)
    engine.step()
    with faults.inject("serving.decode_step",
                       call=lambda: engine.pool.poison_seq(victim), times=1):
        engine.run()
    return rids


class _EchoDrafter:
    """Proposes the stream's last ``k`` tokens again: drafts every decode
    step, some accepted, most not."""

    def propose(self, ids, k):
        return np.asarray(ids[-k:], np.int32)


def _timelines(tracing, faults, engine_cls, model, **kw):
    with _fresh(tracing, capacity=8192, clock=_Clock()) as tr:
        engine = engine_cls(model, page_size=4, max_batch_slots=2, spec_k=2,
                            drafter=_EchoDrafter(), **kw)
        rids = _workload(engine, faults)
        steps = [e for e in tr.events() if e["name"] == "step.tokens"]
        # req.compile's arg is the build's wall time: compared by name
        return ([[(e["name"],
                   None if e["name"] == "req.compile" else e["arg"],
                   e["label"] if e["name"] == "req.retire" else "")
                  for e in tr.events_for(r)] for r in rids],
            [tracing.validate_events(tr.events_for(r)) for r in rids],
            [e["arg"] for e in steps])


def test_engine_event_sequences_match_jax(models):
    import paddle_tpu.faults as jax_faults
    import paddle_tpu.serving.tracing as jax_tracing
    import paddle_tpu_torch.faults as torch_faults
    import paddle_tpu_torch.serving.tracing as torch_tracing

    jm, tm = models
    want, want_audit, want_steps = _timelines(jax_tracing, jax_faults,
                                              JaxEngine, jm)
    got, got_audit, got_steps = _timelines(torch_tracing, torch_faults,
                                           ServingEngine, tm, device="cpu")
    assert got == want
    assert got_steps == want_steps
    assert got_audit == want_audit == [[]] * len(got)
    names = [[n for n, _a, _l in tl] for tl in got]
    first, hit, cancelled, expired, victim = names
    assert first[0] == "req.enqueue" and first[-1] == "req.retire"
    assert "req.prefix_hit" in hit and "req.compile" in first
    assert "req.drafts" in first and "req.spec_reject" in first
    assert expired == ["req.enqueue", "req.expire", "req.retire"]
    assert got[2][-1] == ("req.retire", 0.0, "cancelled")
    # the engine-scoped events: the tokens each step landed
    assert got[4][-1] == ("req.retire", 0.0, "nan")
