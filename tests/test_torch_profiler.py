"""``paddle_tpu_torch.profiler`` against the JAX package's
(``paddle_tpu/profiler/__init__.py``), on the CPU target (the GPU
target's device events are held on the card by ``chip_smoke.py``).

- ``make_scheduler``'s states, and the steps at which ``on_trace_ready``
  fires with the events of each window, equal the JAX package's over a
  grid of ``closed``/``ready``/``record``/``repeat``/``skip_first``.
- The JAX test file's cases (``tests/test_profiler.py``) run on both
  packages: spans, decorators, windows, the chrome trace, the summary,
  ``step_info``, the serving engine's ``engine_step`` spans and gauges.
- The registry bridge: a span adds one observation to
  ``paddle_tpu_profiler_event_seconds{event=...}`` and a counter sets
  its gauge, in each package's own registry, profiler or not.
- The device events of torch's trace join the window on the host clock
  (a synthetic trace on the CPU).

Everything compared here is counts, names and states: exact.
"""
import itertools
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

BOTH = [pt, paddle]


def _cpu(P, **kw):
    return P.profiler.Profiler(targets=[P.profiler.ProfilerTarget.CPU],
                               **kw)


GRID = list(itertools.product([0, 1, 2], [0, 1], [1, 2, 3], [0, 1, 2],
                              [0, 2]))


def test_make_scheduler_states_equal_over_a_grid():
    for closed, ready, record, repeat, skip in GRID:
        kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
                  skip_first=skip)
        js = pt.profiler.make_scheduler(**kw)
        ts = paddle.profiler.make_scheduler(**kw)
        assert [ts(i).name for i in range(24)] == \
            [js(i).name for i in range(24)], kw
    for P in BOTH:
        with pytest.raises(ValueError):
            P.profiler.make_scheduler(closed=-1, ready=0, record=1)
        with pytest.raises(ValueError):
            P.profiler.make_scheduler(closed=0, ready=0, record=0)


def _windows(P, tmp_path, **kw):
    """(step_num, span names) at each ``on_trace_ready``, over 10 steps
    with one span a step."""
    fired = []
    prof = _cpu(P, scheduler=P.profiler.make_scheduler(**kw),
                on_trace_ready=lambda p: fired.append(
                    (p.step_num, [n for n, _, _ in p._events],
                     len(p._step_times))),
                trace_dir=str(tmp_path))
    with prof:
        for i in range(10):
            with P.profiler.RecordEvent(f"s{i}"):
                pass
            prof.step()
    return fired


@pytest.mark.parametrize("closed,ready,record,repeat,skip",
                         [g for g in GRID if g[3] != 0 or g[4] == 0][::3])
def test_on_trace_ready_fires_at_the_same_steps(tmp_path, closed, ready,
                                                 record, repeat, skip):
    kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
              skip_first=skip)
    assert _windows(paddle, tmp_path, **kw) == _windows(pt, tmp_path, **kw)


def _export(P, tmp_path, steps=2, names=("forward", "backward")):
    prof = _cpu(P, scheduler=P.profiler.make_scheduler(
        closed=0, ready=0, record=steps, repeat=1),
        on_trace_ready=P.profiler.export_chrome_tracing(str(tmp_path)),
        trace_dir=str(tmp_path))
    prof.start()
    for _ in range(steps):
        with P.profiler.RecordEvent(names[0]):
            x = P.to_tensor(np.ones((4, 4), "float32"))
            (x @ x).numpy()
        with P.profiler.RecordEvent(names[1]):
            pass
        prof.step()
    prof.stop()
    files = [f for f in os.listdir(tmp_path)
             if f.endswith(".paddle_trace.json")]
    assert len(files) == 1
    return P.profiler.load_profiler_result(os.path.join(tmp_path, files[0]))


def _shape(trace):
    return sorted((e["name"], e["ph"], e["cat"]) for e in trace["traceEvents"])


def test_record_events_and_export(tmp_path):
    j = _export(pt, tmp_path / "j")
    t = _export(paddle, tmp_path / "t")
    assert _shape(t) == _shape(j)
    names = {e["name"] for e in t["traceEvents"]}
    assert {"forward", "backward", "ProfileStep#0", "ProfileStep#1"} <= names
    for e in t["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] >= 0 and e["ts"] > 0


def test_record_event_noop_when_closed_and_decorators(tmp_path):
    for P in BOTH:
        prof = _cpu(P, scheduler=lambda step: P.profiler.ProfilerState.CLOSED,
                    trace_dir=str(tmp_path))
        prof.start()
        with P.profiler.RecordEvent("invisible"):
            pass
        prof.stop()
        assert prof._events == []
    names = {}
    for P in BOTH:
        prof = _cpu(P, trace_dir=str(tmp_path),
                    on_trace_ready=lambda p: None)
        prof.start()

        @P.profiler.RecordEvent("decorated")
        def f():
            return 1

        assert f() == 1
        ev = P.profiler.RecordEvent("manual")
        ev.begin()
        ev.end()
        prof.stop()
        names[P] = [n for n, _, _ in prof._hist_events + prof._events]
    assert names[paddle] == names[pt] == ["decorated", "manual"]


def test_summary_step_info_and_repeat_windows(tmp_path, capsys):
    for P in BOTH:
        prof = _cpu(P, trace_dir=str(tmp_path),
                    on_trace_ready=lambda p: None)
        prof.start()
        for _ in range(3):
            with P.profiler.RecordEvent("matmul"):
                pass
            prof.step(num_samples=32)
        prof.stop()
        out = prof.summary()
        assert "matmul" in out and "ProfileStep" in out
        info = prof.step_info()
        assert "ips" in info and "avg_cost" in info
    exports = {}
    for P in BOTH:
        got = []
        prof = _cpu(P, scheduler=P.profiler.make_scheduler(
            closed=1, ready=0, record=1, repeat=2),
            on_trace_ready=lambda p: got.append(
                [n for n, _, _ in p._events]), trace_dir=str(tmp_path))
        with prof:
            for i in range(4):
                if prof.current_state.name.startswith("RECORD"):
                    with P.profiler.RecordEvent(f"work{i}"):
                        pass
                prof.step()
        exports[P] = got
    assert exports[paddle] == exports[pt] == [["work1"], ["work3"]]
    for P in BOTH:
        assert P.profiler.benchmark() is P.profiler.benchmark()
        assert P.profiler.SummaryView.KernelView == 4
        assert [k.name for k in P.profiler.SortedKeys][:2] == [
            "CPUTotal", "CPUAvg"]


def test_engine_step_spans_and_counters_in_trace(tmp_path):
    """The serving engine's steps are ``engine_step`` spans and its four
    gauges counter tracks, in both packages' traces and summaries."""
    from paddle_tpu.models import LlamaForCausalLM as JLlama
    from paddle_tpu.models import llama_tiny as jtiny
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                         load_reference_state_dict)
    from paddle_tpu_torch.serving import ServingEngine

    kw = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
              num_key_value_heads=2, max_position_embeddings=32)
    pt.seed(0)
    jm = JLlama(jtiny(**kw))
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu", seed=0)
    load_reference_state_dict(tm, {k: np.asarray(v.numpy())
                                   for k, v in jm.state_dict().items()})
    engines = {pt: JEngine(jm, page_size=4, max_batch_slots=1),
               paddle: ServingEngine(tm, page_size=4, max_batch_slots=1,
                                     device="cpu")}
    seen = {}
    for P, engine in engines.items():
        engine.add_request(np.arange(4), max_new_tokens=2)
        d = tmp_path / P.__name__
        prof = _cpu(P, on_trace_ready=P.profiler.export_chrome_tracing(
            str(d)), trace_dir=str(d))
        prof.start()
        while engine.has_work:
            engine.step()
            prof.step()
        prof.stop()
        (f,) = os.listdir(d)
        trace = P.profiler.load_profiler_result(os.path.join(d, f))
        spans = sum(e["name"] == "engine_step" and e["ph"] == "X"
                    for e in trace["traceEvents"])
        counters = sorted({e["name"] for e in trace["traceEvents"]
                           if e["ph"] == "C"})
        out = prof.summary()
        assert "engine_step" in out and "serving.queue_depth" in out
        seen[P] = (spans, counters)
    assert seen[paddle] == seen[pt]
    assert seen[paddle][0] > 0 and "serving.tokens_per_sec" in seen[paddle][1]


def test_registry_bridge_in_each_packages_registry():
    got = {}
    for P in BOTH:
        P.profiler.record_counter("orphan.gauge", 1.0)  # no profiler
        reg = P.metrics.get_registry()
        hist = reg.histogram("paddle_tpu_profiler_event_seconds",
                             labels=("event",)).labels(event="bridge_span")
        before = hist.count
        for _ in range(3):
            with P.profiler.RecordEvent("bridge_span"):
                pass
        P.profiler.record_counter("bridge.value", 7.5)
        gauge = reg.get("paddle_tpu_bridge_value")
        got[P] = (hist.count - before, gauge.kind, gauge.value,
                  reg.get("paddle_tpu_orphan_gauge").value)
    assert got[paddle] == got[pt] == (3, "gauge", 7.5, 1.0)


def test_device_events_join_the_window_on_the_host_clock():
    """``_device_trace`` keeps the device categories of torch's trace and
    moves them onto the host clock by the marker's offset."""
    from paddle_tpu_torch.profiler import Profiler

    class Fake:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": [
                    {"name": "ProfileStep#3", "ph": "X", "cat": "user_annotation",
                     "ts": 1000.0, "dur": 50.0},
                    {"name": "flash_fwd_bf16_kernel", "ph": "X",
                     "cat": "kernel", "ts": 1010.0, "dur": 5.0},
                    {"name": "Memcpy HtoD", "ph": "X", "cat": "gpu_memcpy",
                     "ts": 1020.0, "dur": 1.0},
                    {"name": "aten::mm", "ph": "X", "cat": "cpu_op",
                     "ts": 1001.0, "dur": 3.0},
                    {"name": "flow", "ph": "f", "cat": "ac2g", "ts": 1010.0}]},
                    f)

    marker = (2.0, torch.profiler.record_function("ProfileStep#3"))
    ev = Profiler._device_trace(Fake(), marker)
    assert [(e["name"], e["ts"]) for e in ev] == [
        ("flash_fwd_bf16_kernel", 2.0e6 + 10.0), ("Memcpy HtoD", 2.0e6 + 20.0)]


def test_gpu_target_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        paddle.profiler.Profiler()
    with pytest.raises(RuntimeError):
        paddle.profiler.Profiler(targets=[paddle.profiler.ProfilerTarget.TPU])
    _cpu(paddle)
    assert set(pt.profiler.__all__) <= set(paddle.profiler.__all__)
