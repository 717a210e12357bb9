"""``paddle.profiler`` (``paddle_tpu/profiler/__init__.py``) on
``torch.profiler``.

The scheduler (``make_scheduler``: skip_first, then closed -> ready ->
record, the last record step ``RECORD_AND_RETURN``, ``repeat`` times)
and the windows are the JAX package's. During a RECORD window:

- the host spans (``RecordEvent``), the step spans (``ProfileStep#<n>``)
  and the counter samples (``record_counter``) are kept on the host
  clock, as there; a ``RecordEvent`` also opens a
  ``torch.profiler.record_function`` of its name;
- with the GPU target (``ProfilerTarget.GPU``; ``TPU`` is the same
  target under the JAX package's name) a ``torch.profiler.profile``
  with CUDA activity runs, whose kernel, memcpy and memset events
  (CUPTI sees the port's kernels launched through ctypes too) join the
  window's chrome trace on the host clock: the window's first step span
  opens with a ``record_function`` marker, and the device events are
  shifted by the marker's offset.

``export_chrome_tracing`` writes ``<worker>_time_..._w<n>.paddle_trace
.json`` (host spans ``"ph": "X"``, ``"cat": "host"``; steps ``"step"``;
device events with their CUPTI category; counters ``"ph": "C"``).
``summary()`` prints the step and host-span tables, the counters and
the device operations by total time. Every span also lands in the
metrics registry's ``paddle_tpu_profiler_event_seconds{event=...}``
histogram and every counter sample in a ``paddle_tpu_<name>`` gauge,
always on (unless the registry is disabled), as the JAX package wires
them.

The GPU target needs a card: a ``Profiler`` whose targets include it
(the default: CPU and GPU) raises ``RuntimeError`` without one; pass
``targets=[ProfilerTarget.CPU]`` to profile the host alone.
"""
from __future__ import annotations

import json
import os
import socket
import time
from enum import Enum
from typing import Callable, Iterable, Optional

import torch

__all__ = [
    "ProfilerState", "ProfilerTarget", "Profiler", "RecordEvent",
    "make_scheduler", "export_chrome_tracing", "export_protobuf",
    "load_profiler_result", "SortedKeys", "record_counter", "SummaryView",
    "benchmark",
]

# CUPTI's categories of device work in torch's chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 3
    TPU = 4


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView:
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """The state of each step: ``skip_first`` CLOSED steps, then
    ``closed`` CLOSED, ``ready`` READY and ``record`` RECORD steps (the
    last one RECORD_AND_RETURN), ``repeat`` times (0: for ever)."""
    if closed < 0 or ready < 0 or record <= 0 or repeat < 0 or skip_first < 0:
        raise ValueError("make_scheduler: closed/ready >= 0, record >= 1")
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _default_state_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str,
                          worker_name: Optional[str] = None) -> Callable:
    """An ``on_trace_ready`` handler writing each window's chrome trace
    under ``dir_name``."""
    os.makedirs(dir_name, exist_ok=True)
    seq = [0]

    def handle(prof: "Profiler"):
        w = worker_name or f"host_{socket.gethostname()}_{os.getpid()}"
        seq[0] += 1
        path = os.path.join(
            dir_name,
            f"{w}_time_{time.strftime('%Y_%m_%d_%H_%M_%S')}_w{seq[0]}"
            ".paddle_trace.json")
        prof._write_chrome_trace(path)
        prof._last_export_path = path

    return handle


def export_protobuf(dir_name: str,
                    worker_name: Optional[str] = None) -> Callable:
    """The chrome trace (there is no separate protobuf here)."""
    return export_chrome_tracing(dir_name, worker_name)


def load_profiler_result(filename: str):
    with open(filename) as f:
        return json.load(f)


# --------------------------------------------------------------- record event
_active_profiler: Optional["Profiler"] = None
_counter_gauges: dict = {}
_event_hist = None


def _registry_gauge(name: str):
    g = _counter_gauges.get(name)
    if g is None:
        from ..metrics import get_registry, sanitize_metric_name

        g = get_registry().gauge(
            sanitize_metric_name(name),
            f"record_counter({name!r}) gauge (profiler bridge)")
        _counter_gauges[name] = g
    return g


def _registry_event_hist():
    global _event_hist
    if _event_hist is None:
        from ..metrics import get_registry

        _event_hist = get_registry().histogram(
            "paddle_tpu_profiler_event_seconds",
            "RecordEvent span durations (profiler bridge)",
            labels=("event",))
    return _event_hist


def _recording() -> Optional["Profiler"]:
    prof = _active_profiler
    return prof if prof is not None and prof._recording else None


class RecordEvent:
    """A named host span: into the registry's event histogram always,
    and while a profiler records into its window (and, as a
    ``record_function``, into the torch profiler's)."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self.event_type = event_type
        self._t0 = None
        self._fn = None
        self._to_prof = False

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()

    def __call__(self, func):
        import functools

        @functools.wraps(func)
        def wrapped(*args, **kwargs):
            with RecordEvent(self.name):
                return func(*args, **kwargs)

        return wrapped

    def begin(self):
        self._to_prof = _recording() is not None
        if self._to_prof:
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        elif not _registry_event_hist()._registry.enabled:
            return  # nothing to feed: no clock read
        self._t0 = time.perf_counter()

    def end(self):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        if self._fn is not None:
            self._fn.__exit__(None, None, None)
            self._fn = None
        hist = _registry_event_hist()
        if hist._registry.enabled:
            hist.labels(event=self.name).observe(dt)
        prof = _recording()
        if self._to_prof and prof is not None:
            prof._events.append((self.name, self._t0, dt))
        self._t0 = None
        self._to_prof = False


def record_counter(name: str, value) -> None:
    """One gauge sample: the registry's ``paddle_tpu_<name>`` gauge
    always, and the recording window's counter track."""
    v = float(value)
    _registry_gauge(name).set(v)
    prof = _recording()
    if prof is not None:
        prof._counters.append((name, time.perf_counter(), v))


# ------------------------------------------------------------------- profiler
class Profiler:
    """``paddle.profiler.Profiler`` (module docstring). ``scheduler`` is a
    callable, a ``(start, end)`` pair of steps or None (always record);
    ``on_trace_ready`` runs at each window's end (default: chrome traces
    under ``trace_dir``)."""

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready: Optional[Callable] = None,
                 record_shapes: bool = False, profile_memory: bool = False,
                 timer_only: bool = False, emit_nvtx: bool = False,
                 custom_device_types=None,
                 trace_dir: str = "./profiler_log"):
        self.targets = set(targets) if targets is not None else {
            ProfilerTarget.CPU, ProfilerTarget.GPU}
        self._device = bool(self.targets & {ProfilerTarget.GPU,
                                            ProfilerTarget.TPU})
        if self._device and not torch.cuda.is_available():
            raise RuntimeError(
                "Profiler's GPU target traces a CUDA device and none is "
                "available; pass targets=[ProfilerTarget.CPU] to profile "
                "the host alone")
        if scheduler is None:
            self._scheduler = _default_state_scheduler
        elif isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            self._scheduler = make_scheduler(
                closed=max(start - 1, 0), ready=min(start, 1),
                record=end - start, repeat=1)
        else:
            self._scheduler = scheduler
        self.on_trace_ready = on_trace_ready or export_chrome_tracing(
            trace_dir)
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.timer_only = timer_only
        self.trace_dir = trace_dir
        self.current_state = ProfilerState.CLOSED
        self.step_num = 0
        # the current window's (name, t0, dur_s), (t0, dur_s),
        # (name, t, value) and device events (chrome dicts, host clock)
        self._events: list = []
        self._step_times: list = []
        self._counters: list = []
        self._device_events: list = []
        self._window_step0 = 0
        # the run's, for summary(); each window's buffers are cleared
        self._hist_events: list = []
        self._hist_step_times: list = []
        self._hist_counters: list = []
        self._hist_device_events: list = []
        self._step_t0 = None
        self._recording = False
        self._torch_prof = None
        self._marker = None
        self._last_export_path = None
        self._benchmark = _Benchmark()

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def start(self):
        global _active_profiler
        _active_profiler = self
        self._step_t0 = time.perf_counter()
        self.current_state = self._scheduler(self.step_num)
        self._transition(ProfilerState.CLOSED, self.current_state)
        self._benchmark.begin()

    def stop(self):
        global _active_profiler
        if self._recording:
            self._close_window()
        if _active_profiler is self:
            _active_profiler = None
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples: Optional[int] = None):
        """One step boundary: the step's span closes and the scheduler
        moves on."""
        now = time.perf_counter()
        if self._step_t0 is not None and self._recording:
            self._step_times.append((self._step_t0, now - self._step_t0))
        self._step_t0 = now
        self._benchmark.step(num_samples)
        old = self.current_state
        self.step_num += 1
        self.current_state = self._scheduler(self.step_num)
        self._transition(old, self.current_state)

    def step_info(self, unit: str = "samples") -> str:
        return self._benchmark.step_info(unit)

    # -- state machine ------------------------------------------------------
    def _transition(self, old: ProfilerState, new: ProfilerState):
        rec = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        was, now = old in rec, new in rec
        if was and (old == ProfilerState.RECORD_AND_RETURN or not now):
            self._close_window()
            was = False
        if now and not was:
            self._open_window()

    def _open_window(self):
        self._recording = True
        if self.timer_only or not self._device:
            return
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._torch_prof = torch.profiler.profile(
            activities=acts, record_shapes=self.record_shapes,
            profile_memory=self.profile_memory)
        self._torch_prof.__enter__()
        # the clock marker: opened now, on both clocks
        self._marker = (time.perf_counter(),
                        torch.profiler.record_function(
                            f"ProfileStep#{self.step_num}"))
        self._marker[1].__enter__()

    def _close_window(self):
        if self._torch_prof is not None:
            torch.cuda.synchronize()
            self._marker[1].__exit__(None, None, None)
            self._torch_prof.__exit__(None, None, None)
            self._device_events = self._device_trace(self._torch_prof,
                                                     self._marker)
            self._torch_prof = self._marker = None
        self._recording = False
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)
        self._hist_events.extend(self._events)
        self._hist_step_times.extend(self._step_times)
        self._hist_counters.extend(self._counters)
        self._hist_device_events.extend(self._device_events)
        self._events, self._step_times, self._counters = [], [], []
        self._device_events = []
        self._window_step0 = self.step_num

    @staticmethod
    def _device_trace(prof, marker) -> list:
        """The window's device events from torch's chrome trace, their
        ``ts`` moved onto the host clock (µs of ``perf_counter``) by the
        marker span's offset."""
        import tempfile

        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        t_host, fn = marker
        name = fn.name if hasattr(fn, "name") else None
        marks = [e["ts"] for e in events
                 if e.get("ph") == "X" and e.get("name") == name]
        shift = t_host * 1e6 - (min(marks) if marks else 0.0)
        out = []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
                e = dict(e, ts=e["ts"] + shift)
                out.append(e)
        return out

    # -- export -------------------------------------------------------------
    def _write_chrome_trace(self, path: str):
        pid = os.getpid()
        events = [{"name": name, "ph": "X", "cat": "host", "ts": t0 * 1e6,
                   "dur": dur * 1e6, "pid": pid, "tid": 0}
                  for name, t0, dur in self._events]
        for i, (t0, dt) in enumerate(self._step_times):
            events.append({"name": f"ProfileStep#{self._window_step0 + i}",
                           "ph": "X", "cat": "step", "ts": t0 * 1e6,
                           "dur": dt * 1e6, "pid": pid, "tid": 1})
        events.extend(self._device_events)
        for name, t, value in self._counters:
            events.append({"name": name, "ph": "C", "cat": "counter",
                           "ts": t * 1e6, "pid": pid,
                           "args": {"value": value}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)

    def device_totals(self) -> dict:
        """Device time by operation over the run's windows: ``{name:
        (total_us, calls)}``."""
        agg: dict = {}
        for e in self._hist_device_events + self._device_events:
            tot, n = agg.get(e["name"], (0.0, 0))
            agg[e["name"]] = (tot + float(e.get("dur", 0.0)), n + 1)
        return agg

    # -- reporting ----------------------------------------------------------
    def summary(self, sorted_by=SortedKeys.CPUTotal, op_detail: bool = True,
                thread_sep: bool = False, time_unit: str = "ms",
                top: int = 20):
        """Print the step, host-span, counter and device tables; returns
        the text."""
        unit = {"s": 1.0, "ms": 1e3, "us": 1e6}.get(time_unit, 1e3)
        lines = []
        all_steps = self._hist_step_times + self._step_times
        if all_steps:
            ts = [dur for _, dur in all_steps]
            lines += ["-" * 72,
                      f"{'Step summary':<30}{'calls':>8}{'avg':>10}"
                      f"{'min':>10}{'max':>10}  [{time_unit}]", "-" * 72,
                      f"{'ProfileStep':<30}{len(ts):>8}"
                      f"{sum(ts) / len(ts) * unit:>10.3f}"
                      f"{min(ts) * unit:>10.3f}{max(ts) * unit:>10.3f}"]
        agg = {}
        for name, _, dur in self._hist_events + self._events:
            tot, cnt, mn, mx = agg.get(name, (0.0, 0, float("inf"), 0.0))
            agg[name] = (tot + dur, cnt + 1, min(mn, dur), max(mx, dur))
        if agg:
            key = {
                SortedKeys.CPUTotal: lambda kv: -kv[1][0],
                SortedKeys.CPUAvg: lambda kv: -(kv[1][0] / kv[1][1]),
                SortedKeys.CPUMax: lambda kv: -kv[1][3],
                SortedKeys.CPUMin: lambda kv: kv[1][2],
            }.get(sorted_by, lambda kv: -kv[1][0])
            lines += ["-" * 72,
                      f"{'Event (host)':<30}{'calls':>8}{'total':>10}"
                      f"{'avg':>10}{'max':>10}  [{time_unit}]", "-" * 72]
            for name, (tot, cnt, mn, mx) in sorted(agg.items(), key=key):
                lines.append(f"{name[:29]:<30}{cnt:>8}{tot * unit:>10.3f}"
                             f"{tot / cnt * unit:>10.3f}{mx * unit:>10.3f}")
        cagg = {}
        for name, _, val in self._hist_counters + self._counters:
            tot, cnt, mx, last = cagg.get(name, (0.0, 0, float("-inf"), 0.0))
            cagg[name] = (tot + val, cnt + 1, max(mx, val), val)
        if cagg:
            lines += ["-" * 72,
                      f"{'Counter (gauge)':<30}{'samples':>8}{'last':>10}"
                      f"{'avg':>10}{'max':>10}", "-" * 72]
            for name, (tot, cnt, mx, last) in sorted(cagg.items()):
                lines.append(f"{name[:29]:<30}{cnt:>8}{last:>10.3f}"
                             f"{tot / cnt:>10.3f}{mx:>10.3f}")
        dev = self.device_totals()
        if dev:
            total = sum(t for t, _ in dev.values())
            lines += ["-" * 72,
                      f"{'Device operation':<44}{'calls':>7}{'total':>10}"
                      f"{'share':>8}  [{time_unit}]", "-" * 72]
            for name, (tot, n) in sorted(dev.items(),
                                         key=lambda kv: -kv[1][0])[:top]:
                lines.append(f"{name[:43]:<44}{n:>7}"
                             f"{tot * 1e-6 * unit:>10.3f}"
                             f"{tot / total:>8.1%}")
        if self._last_export_path:
            lines.append(f"chrome trace: {self._last_export_path}")
        out = "\n".join(lines) if lines else "(no profiling data recorded)"
        print(out)
        return out


# ------------------------------------------------------------------ benchmark
class _Benchmark:
    """Step cost and throughput (``step_info``)."""

    def __init__(self):
        self._t0 = None
        self._steps = 0
        self._samples = 0
        self._elapsed = 0.0

    def begin(self):
        self._t0 = time.perf_counter()

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._t0 is not None:
            self._elapsed += now - self._t0
            self._steps += 1
            if num_samples:
                self._samples += num_samples
        self._t0 = now

    def step_info(self, unit: str = "samples") -> str:
        if not self._steps or self._elapsed <= 0:
            return "avg_cost: -, ips: -"
        avg = self._elapsed / self._steps
        ips = (self._samples or self._steps) / self._elapsed
        return f"avg_cost: {avg:.5f} sec, ips: {ips:.5f} {unit}/sec"


_global_benchmark = None


def benchmark() -> _Benchmark:
    """The process's benchmark timer."""
    global _global_benchmark
    if _global_benchmark is None:
        _global_benchmark = _Benchmark()
    return _global_benchmark
