"""Typed metrics registry: Counter / Gauge / Histogram with labels.

The always-on half of observability (the profiler is the sampled half):
process-wide instruments that cost nanoseconds per sample, accumulate
forever, and export as a Prometheus text exposition or a JSON snapshot.
Stdlib-only by design — the registry must be importable from every layer
(jit, optimizer, serving) without pulling jax or creating import cycles.

Design notes:

- **Families and children.** ``registry.counter(name, help, labels=(...))``
  returns a *family*; ``family.labels(route="/v1")`` returns the *child*
  holding one labeled series. A family declared without labels acts as its
  own single child, so ``registry.counter("x").inc()`` just works.
- **O(1), allocation-free observe.** Histograms default to fixed
  exponential buckets; the bucket index is computed with one ``math.log``
  (plus a clamp loop for float edge cases) instead of a search, and the
  per-bucket counts live in a pre-sized list — no allocation on the hot
  path. Custom bucket lists fall back to ``bisect``.
- **Thread safety.** Every mutation takes the family lock; ``inc`` under
  concurrency is exact (asserted by the metrics tests).
- **Kill switch.** ``registry.enabled = False`` turns every ``inc`` /
  ``set`` / ``observe`` / ``time()`` into an early-return flag check —
  the overhead-guard test pins that a disabled registry adds no
  measurable cost to an engine step.
"""
from __future__ import annotations

import bisect
import math
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "exponential_buckets", "get_registry", "sanitize_metric_name",
    "time_histogram",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default latency buckets: 100 µs .. ~52 s, x2 per bucket (20 bounds +
# +Inf). Wide enough for a CPU-fallback prefill and tight enough for
# sub-ms TPU decode steps.
_DEFAULT_START = 1e-4
_DEFAULT_FACTOR = 2.0
_DEFAULT_COUNT = 20


def exponential_buckets(start: float, factor: float,
                        count: int) -> List[float]:
    """``count`` upper bounds ``start * factor**k`` (the +Inf bucket is
    implicit)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("exponential_buckets: start > 0, factor > 1, "
                         "count >= 1")
    return [start * factor ** k for k in range(count)]


def sanitize_metric_name(raw: str) -> str:
    """Map a free-form counter name (e.g. ``serving.queue_depth`` from
    ``profiler.record_counter``) onto the ``paddle_tpu_*`` convention."""
    s = re.sub(r"[^a-zA-Z0-9_:]", "_", str(raw))
    if not s or not _NAME_RE.match(s):
        s = "_" + s
    if not s.startswith("paddle_tpu_"):
        s = "paddle_tpu_" + s
    return s


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v: float) -> str:
    """Prometheus value formatting: integers without the trailing .0 noise,
    floats with repr precision."""
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == -math.inf:
        return "-Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# ------------------------------------------------------------------ children
class _CounterChild:
    __slots__ = ("_family", "_value")

    def __init__(self, family):
        self._family = family
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._family._registry.enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._family._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class _GaugeChild:
    __slots__ = ("_family", "_value")

    def __init__(self, family):
        self._family = family
        self._value = 0.0

    def set(self, value: float) -> None:
        if not self._family._registry.enabled:
            return
        with self._family._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._family._registry.enabled:
            return
        with self._family._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class _HistogramChild:
    __slots__ = ("_family", "_counts", "_sum", "_count")

    def __init__(self, family):
        self._family = family
        # one slot per finite bound + the +Inf bucket; pre-sized so
        # observe() never allocates
        self._counts = [0] * (len(family.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        fam = self._family
        if not fam._registry.enabled:
            return
        v = float(value)
        i = fam._bucket_index(v)
        with fam._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def time(self) -> "_Timer":
        return _Timer(self)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Prometheus-style ``histogram_quantile``: locate the bucket where
        the cumulative count crosses ``q * count`` and interpolate linearly
        inside it (first bucket interpolates from 0; the +Inf bucket clamps
        to the last finite bound). None before any observation."""
        fam = self._family
        with fam._lock:
            total = self._count
            counts = list(self._counts)
        return _quantile_from_counts(counts, total, fam.buckets, q)

    def fraction_le(self, bound: float) -> Optional[float]:
        """Fraction of observations ``<= bound`` — the quantile read run
        backwards (SLO attainment: "what share of TTFTs beat 200 ms?"),
        interpolated inside the bucket containing ``bound`` exactly like
        :meth:`quantile`. None before any observation."""
        fam = self._family
        with fam._lock:
            total = self._count
            counts = list(self._counts)
        return _fraction_from_counts(counts, total, fam.buckets, bound)


def _fraction_from_counts(counts, total, bounds,
                          bound: float) -> Optional[float]:
    """Inverse of the quantile math: cumulative share at ``bound`` with
    linear interpolation in its bucket (first bucket interpolates from 0;
    past the last finite bound everything counts)."""
    if total == 0:
        return None
    b = float(bound)
    if b >= bounds[-1]:
        return 1.0
    if b < 0.0:
        return 0.0
    cum = 0.0
    for i, hi in enumerate(bounds):
        lo = 0.0 if i == 0 else bounds[i - 1]
        if b <= hi:
            frac = 0.0 if hi == lo else (b - lo) / (hi - lo)
            return (cum + counts[i] * max(0.0, frac)) / total
        cum += counts[i]
    return cum / total


def _quantile_from_counts(counts, total, bounds, q: float) -> Optional[float]:
    """The one copy of the bucket-interpolation math, shared by per-series
    and family-aggregated (label-merged) quantiles."""
    if not 0.0 <= q <= 1.0:
        raise ValueError("quantile q must be in [0, 1]")
    if total == 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev = cum
        cum += c
        if cum >= target and c > 0:
            if i >= len(bounds):       # +Inf bucket
                return bounds[-1]
            lo = 0.0 if i == 0 else bounds[i - 1]
            hi = bounds[i]
            return lo + (hi - lo) * (target - prev) / c
    return bounds[-1]


class _Timer:
    """``with hist.time(): ...`` — observes the wall-time of the block.
    Skips the clock reads entirely when the registry is disabled."""

    __slots__ = ("_child", "_t0")

    def __init__(self, child):
        self._child = child
        self._t0 = None

    def __enter__(self):
        if self._child._family._registry.enabled:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            self._child.observe(time.perf_counter() - self._t0)
            self._t0 = None


def time_histogram(histogram) -> _Timer:
    """Context manager timing a block into ``histogram`` (a Histogram
    family without labels, or a labeled child)."""
    if isinstance(histogram, Histogram):
        histogram = histogram._default_child()
    return _Timer(histogram)


# ------------------------------------------------------------------ families
class _MetricFamily:
    kind = "untyped"
    _child_cls = None

    def __init__(self, name: str, documentation: str = "",
                 label_names: Sequence[str] = (), registry=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.documentation = documentation
        self.label_names = tuple(label_names)
        # standalone construction (registry=None) yields a free-floating
        # instrument: it honors the DEFAULT registry's enabled flag but is
        # not registered anywhere — use registry.counter()/gauge()/
        # histogram() to get exported series
        self._registry = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.label_names:
            self._children[()] = self._child_cls(self)

    def labels(self, *values, **kv):
        """Child for one label-value set. Keyword form is order-insensitive
        (``labels(a=1, b=2)`` and ``labels(b=2, a=1)`` are the same
        series); positional form follows the declared label order."""
        if values and kv:
            raise ValueError("pass label values positionally or by "
                             "keyword, not both")
        if kv:
            if set(kv) != set(self.label_names):
                raise ValueError(
                    f"labels {sorted(kv)} != declared "
                    f"{sorted(self.label_names)} for {self.name}")
            values = tuple(str(kv[ln]) for ln in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name} expects {len(self.label_names)} label "
                f"values, got {len(values)}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self._children[values] = self._child_cls(self)
        return child

    def _default_child(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} declares labels {self.label_names}; call "
                ".labels(...) first")
        return self._children[()]

    def sum_labels(self, **kv) -> float:
        """Aggregate ``value`` over every child whose labels match ``kv``
        — a SUBSET of the declared labels, unlike :meth:`labels` which
        demands the exact set. The partial-dimension read: e.g.
        ``jit_compiles_total.sum_labels(fn="serving_step")`` totals the
        fn across its ``source`` breakdown the way a family-level
        ``value`` totals everything. Counters and gauges only (a
        histogram child has no scalar ``value``)."""
        unknown = set(kv) - set(self.label_names)
        if unknown:
            raise ValueError(
                f"unknown labels {sorted(unknown)}; {self.name} declares "
                f"{sorted(self.label_names)}")
        want = {self.label_names.index(k): str(v) for k, v in kv.items()}
        total = 0.0
        for values, child in self._series():
            if all(values[i] == v for i, v in want.items()):
                total += child.value
        return total

    def _series(self):
        with self._lock:
            return list(self._children.items())

    def _children_snapshot(self):
        with self._lock:
            return list(self._children.values())

    def _reset(self):
        with self._lock:
            for child in self._children.values():
                if isinstance(child, _HistogramChild):
                    child._counts = [0] * len(child._counts)
                    child._sum = 0.0
                    child._count = 0
                else:
                    child._value = 0.0


class Counter(_MetricFamily):
    """Monotonically increasing count (requests served, tokens emitted,
    programs compiled). Convention: name ends in ``_total``.

    Family-level reads AGGREGATE: on a labeled family ``value`` sums every
    child series (the fleet total a ``router`` deployment wants when the
    same counter carries per-engine ``engine_id`` labels). Writes stay
    per-series — ``inc()`` on a labeled family raises, because an
    unattributed increment has no series to land in."""

    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        if self.label_names:
            return sum(c.value for c in self._children_snapshot())
        return self._default_child().value


class Gauge(_MetricFamily):
    """Point-in-time value that can go both ways (queue depth, page
    utilization, tokens/s). Like :class:`Counter`, family-level ``value``
    on a labeled family sums the children (pages used across a fleet of
    engines); ``set``/``inc``/``dec`` need ``.labels(...)`` first."""

    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        if self.label_names:
            return sum(c.value for c in self._children_snapshot())
        return self._default_child().value


class Histogram(_MetricFamily):
    """Distribution over fixed buckets (latencies). Default buckets are
    exponential (100 µs .. ~52 s, x2), giving an O(1) log-based bucket
    index; pass ``buckets=[...]`` for custom bounds (bisect lookup)."""

    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name, documentation="", label_names=(),
                 registry=None, buckets: Optional[Sequence[float]] = None):
        exponential = buckets is None
        if buckets is None:
            buckets = exponential_buckets(_DEFAULT_START, _DEFAULT_FACTOR,
                                          _DEFAULT_COUNT)
        buckets = [float(b) for b in buckets]
        if buckets and buckets[-1] == math.inf:
            buckets = buckets[:-1]  # +Inf bucket is implicit
        # validate AFTER the strip: buckets=[inf] alone must fail here,
        # not IndexError on the first observe
        if not buckets or any(b2 <= b1 for b1, b2
                              in zip(buckets, buckets[1:])):
            raise ValueError("buckets must contain at least one finite "
                             "bound, strictly increasing")
        self.buckets = buckets
        if exponential:
            self._log_lo = math.log(_DEFAULT_START)
            self._log_f = math.log(_DEFAULT_FACTOR)
        else:
            self._log_lo = None
            self._log_f = None
        super().__init__(name, documentation, label_names, registry)

    def _bucket_index(self, v: float) -> int:
        bounds = self.buckets
        if v <= bounds[0]:
            return 0
        if v > bounds[-1]:
            return len(bounds)
        if self._log_lo is not None:
            # O(1) for the exponential default: index from one log, then
            # nudge over float rounding at bucket edges
            i = int((math.log(v) - self._log_lo) / self._log_f)
            i = min(max(i, 0), len(bounds) - 1)
            while i > 0 and v <= bounds[i - 1]:
                i -= 1
            while v > bounds[i]:
                i += 1
            return i
        return bisect.bisect_left(bounds, v)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def time(self) -> _Timer:
        return _Timer(self._default_child())

    def _merged_counts(self):
        """Element-wise bucket merge across every child series (shared
        bounds, so the merge is exact) — family-level reads on a labeled
        histogram aggregate the fleet, same contract as Counter.value."""
        counts = [0] * (len(self.buckets) + 1)
        total = 0
        with self._lock:
            children = list(self._children.values())
            for c in children:
                for i, n in enumerate(c._counts):
                    counts[i] += n
                total += c._count
        return counts, total

    def quantile(self, q: float) -> Optional[float]:
        if self.label_names:
            counts, total = self._merged_counts()
            return _quantile_from_counts(counts, total, self.buckets, q)
        return self._default_child().quantile(q)

    def fraction_le(self, bound: float) -> Optional[float]:
        """Fraction of observations ``<= bound`` (family-level reads
        merge every child's buckets, same contract as :meth:`quantile`) —
        the registry-native SLO-attainment read a load generator
        scores tiers with."""
        if self.label_names:
            counts, total = self._merged_counts()
            return _fraction_from_counts(counts, total, self.buckets,
                                         bound)
        return self._default_child().fraction_le(bound)

    @property
    def count(self) -> int:
        if self.label_names:
            return self._merged_counts()[1]
        return self._default_child().count

    @property
    def sum(self) -> float:
        if self.label_names:
            with self._lock:
                return sum(c._sum for c in self._children.values())
        return self._default_child().sum


# ------------------------------------------------------------------ registry
class MetricsRegistry:
    """Process-wide instrument directory. ``counter()`` / ``gauge()`` /
    ``histogram()`` are get-or-create: re-declaring an existing name
    returns the existing family (so every engine/layer can declare its
    instruments without coordinating), but a *type* or *label-set*
    mismatch raises — two subsystems silently sharing one name with
    different meanings is the bug this catches."""

    def __init__(self, enabled: bool = True):
        self._metrics: Dict[str, _MetricFamily] = {}
        self._lock = threading.Lock()
        self.enabled = bool(enabled)

    # -- declaration ------------------------------------------------------
    def _get_or_create(self, cls, name, documentation, labels, **kw):
        fam = self._metrics.get(name)
        if fam is None:
            with self._lock:
                fam = self._metrics.get(name)
                if fam is None:
                    fam = cls(name, documentation, tuple(labels),
                              registry=self, **kw)
                    self._metrics[name] = fam
                    return fam
        if not isinstance(fam, cls):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"requested {cls.kind}")
        if tuple(labels) and tuple(labels) != fam.label_names:
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{fam.label_names}, requested {tuple(labels)}")
        return fam

    def counter(self, name: str, documentation: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, documentation, labels)

    def gauge(self, name: str, documentation: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, documentation, labels)

    def histogram(self, name: str, documentation: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, documentation, labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_MetricFamily]:
        return self._metrics.get(name)

    # -- lifecycle --------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        """Hot paths reduce to one flag check; instruments stay declared."""
        self.enabled = False

    def reset(self) -> None:
        """Zero every series (benchmarks isolate runs with this); the
        families and their label children stay registered."""
        with self._lock:
            fams = list(self._metrics.values())
        for fam in fams:
            fam._reset()

    # -- exporters --------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready view: every family, every labeled series, with
        p50/p95/p99 precomputed for histograms (what BENCH rows and
        ``tools/metrics_dump.py`` consume)."""
        out: dict = {}
        with self._lock:
            fams = sorted(self._metrics.values(), key=lambda f: f.name)
        for fam in fams:
            series = []
            for values, child in fam._series():
                entry: dict = {
                    "labels": dict(zip(fam.label_names, values))}
                if isinstance(child, _HistogramChild):
                    with fam._lock:
                        counts = list(child._counts)
                        s, n = child._sum, child._count
                    entry.update({
                        # "+Inf" as a string: the snapshot must stay
                        # strict JSON (json.dumps(inf) emits the
                        # non-standard Infinity token)
                        "buckets": [[b, c] for b, c
                                    in zip(fam.buckets + ["+Inf"],
                                           _cumulate(counts))],
                        "sum": s, "count": n,
                        "p50": child.quantile(0.5),
                        "p95": child.quantile(0.95),
                        "p99": child.quantile(0.99),
                    })
                else:
                    entry["value"] = child.value
                series.append(entry)
            out[fam.name] = {"type": fam.kind,
                             "help": fam.documentation,
                             "series": series}
        return out

    def expose_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4): HELP/TYPE
        headers, one sample line per series, histogram ``_bucket`` lines
        cumulative with the ``+Inf`` terminator."""
        lines: List[str] = []
        with self._lock:
            fams = sorted(self._metrics.values(), key=lambda f: f.name)
        for fam in fams:
            lines.append(f"# HELP {fam.name} "
                         f"{_escape_help(fam.documentation)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in fam._series():
                base = dict(zip(fam.label_names, values))
                if isinstance(child, _HistogramChild):
                    with fam._lock:
                        counts = list(child._counts)
                        s, n = child._sum, child._count
                    cum = _cumulate(counts)
                    for b, c in zip(fam.buckets + [math.inf], cum):
                        lines.append(_sample(fam.name + "_bucket",
                                             {**base, "le": _fmt(b)}, c))
                    lines.append(_sample(fam.name + "_sum", base, s))
                    lines.append(_sample(fam.name + "_count", base, n))
                else:
                    lines.append(_sample(fam.name, base, child.value))
        return "\n".join(lines) + "\n"


def _cumulate(counts: List[int]) -> List[int]:
    out, c = [], 0
    for v in counts:
        c += v
        out.append(c)
    return out


def _sample(name: str, labels: Dict[str, str], value) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label(v)}"'
                        for k, v in labels.items())
        return f"{name}{{{body}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


# ------------------------------------------------------------ default registry
_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every built-in instrument lands
    in (serving, jit, optimizer, profiler bridge)."""
    return _default_registry
