"""Trace replay against a Router fleet + registry-scored LoadReport.

Counterpart of ``paddle_tpu/loadgen/driver.py``, host code only.

:class:`LoadDriver` paces a :class:`~.trace.Trace` against
``router.step()``: each sweep advances the virtual clock by ``step_dt``
virtual seconds, submits every request whose arrival instant has come
due (bounded retries across sweeps on ``BackpressureError`` /
``NoHealthyEngineError`` — the 429/503 a real client would see — then
the request scores ``rejected``), steps the fleet once, ticks the
attached autoscaler, and collects finished outputs incrementally via
``router.take_outputs()``.

Streams are consumed through the engines' seq-numbered 4-arg callbacks;
each request's closure records its seq trail and terminal call, burns
host work per token when the trace flagged it a slow consumer, and
feeds the wall-clock TTFT/ITL observations into the per-tier
``paddle_tpu_loadgen_{ttft,itl}_seconds{tier=...}`` histograms.
**Exactly-once accounting** is checked structurally, not statistically:
every submitted request must produce exactly one terminal callback,
a contiguous ``0..n-1`` seq trail whose length matches both the
terminal seq and the delivered ``token_ids``, and exactly one entry in
the collected outputs — any violation lands verbatim in
``LoadReport.violations``.

Scoring reads the metrics registry (the contract: the report
is what the dashboards would say): per-tier SLO attainment via the
histograms' ``fraction_le``, prefix-hit ratio / spec acceptance / fresh
compiles from counter DELTAS snapshotted at run start (on a card a
"fresh compile" is a CUDA-graph capture of a bucket). The loadgen
histograms accumulate per registry like every other family — reset the
registry (or use a fresh one) to score runs in isolation.

Latency observations are wall-clock (``time.perf_counter``);
reproducibility covers the request stream and the completion accounting
(same seed → same trace, same outcomes), never the latencies
themselves.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import metrics
from ..serving import tracing
from ..serving.overload import AdmissionShedError
from ..serving.router import NoHealthyEngineError
from ..serving.scheduler import BackpressureError
from .trace import Trace, VirtualClock

__all__ = ["LoadDriver", "LoadReport", "TierReport"]

# outcomes a trace request can score (finish reasons + driver-side ones)
# — "shed" is driver-side (refused at admission by the overload
# controller, a terminal answer unlike the retried "rejected" 429),
# "expired" is the engine finish reason for queued deadline lapses
OUTCOMES = ("stop", "length", "timeout", "cancelled", "nan", "error",
            "unavailable", "rejected", "lost", "shed", "expired")


@dataclass
class TierReport:
    """Per-SLO-tier slice of a :class:`LoadReport`."""

    requests: int = 0
    ttft_slo_s: float = 0.0
    itl_slo_s: float = 0.0
    # fraction of observations within the tier's bound, from the
    # registry histograms' fraction_le (None: no observations)
    ttft_attainment: Optional[float] = None
    itl_attainment: Optional[float] = None
    ttft_p95_s: Optional[float] = None
    # mean seconds per attribution bucket (tracing.TTFT_BUCKETS) from
    # the always-on trace journal; buckets sum to the tier's mean
    # measured TTFT (None: tracing disabled or no first tokens)
    ttft_breakdown: Optional[Dict[str, float]] = None

    def to_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class LoadReport:
    """What the drill measured — the fleet-level bench record
    ``tools/bench_load.py`` serializes and chaos scenario 15 asserts
    on. ``violations`` MUST be empty for a healthy run."""

    seed: int = 0
    num_requests: int = 0
    submitted: int = 0
    wall_s: float = 0.0
    steps: int = 0
    goodput_tok_s: float = 0.0          # stop/length tokens per wall second
    goodput_tokens: int = 0
    total_tokens: int = 0               # every delivered token, any outcome
    outcomes: Dict[str, int] = field(default_factory=dict)
    unavailable_rate: float = 0.0
    timeout_rate: float = 0.0
    # overload outcomes: fractions of the trace shed at
    # admission / expired while queued — the price the overload
    # controller paid, reported next to the attainment it bought
    shed_rate: float = 0.0
    expired_rate: float = 0.0
    rejected: int = 0
    tiers: Dict[str, TierReport] = field(default_factory=dict)
    prefix_hit_ratio: Optional[float] = None   # delta hits/(hits+misses)
    spec_acceptance: Optional[float] = None    # delta accepted/drafted
    fresh_compiles: int = 0                    # delta fresh jit compiles
    engines_start: int = 0
    engines_peak: int = 0
    engines_final: int = 0
    scale_ups: int = 0
    scale_downs: int = 0
    # multi-tenancy: delivered-goodput tok/s per LoRA tenant
    # (key "" is the base-model share), and the fraction of constrained
    # requests whose delivered tokens VALIDATE against their grammar
    # (None: the trace ran no constrained requests)
    adapter_goodput: Dict[str, float] = field(default_factory=dict)
    constrained_validity: Optional[float] = None
    exactly_once: bool = True
    violations: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["tiers"] = {k: v.to_dict() for k, v in self.tiers.items()}
        return d


class _RequestRecord:
    """One trace request's stream trail, written by its callback."""

    __slots__ = ("trace_req", "rid", "t_submit", "t_first", "t_prev",
                 "seqs", "terminals", "attempts", "shed")

    def __init__(self, trace_req):
        self.trace_req = trace_req
        self.rid = None
        self.t_submit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_prev: Optional[float] = None
        self.seqs: List[int] = []
        self.terminals: List[tuple] = []   # (reason, seq)
        self.attempts = 0
        self.shed = False   # refused at admission by overload control


class LoadDriver:
    """Replay ``trace`` against ``router`` and score a
    :class:`LoadReport` (see module docstring)::

        report = LoadDriver(router, trace, autoscaler=scaler).run()

    ``step_dt`` is how many VIRTUAL seconds one ``router.step()`` sweep
    represents (default: ``2 / arrival_rate`` — about two arrivals per
    sweep at the base rate, so a burst visibly outruns the fleet);
    ``submit_retries`` bounds how many sweeps a 429/503-rejected
    request retries before scoring ``rejected``; ``settle_steps``
    bounds the post-drain idle phase that lets an attached autoscaler
    shrink the fleet back to ``min_engines``.

    ``overload`` is an optional
    :class:`~paddle_tpu.serving.overload.OverloadController` — ticked
    once per sweep exactly like the autoscaler. ``fault_schedule`` is
    an optional :class:`~.chaos.FaultSchedule`: its events fire as the
    virtual clock sweeps past their instants, so the same seed replays
    the same incident (chaos-in-the-loop; latency injections are
    disarmed when the run ends, success or raise)."""

    def __init__(self, router, trace: Trace,
                 model: Optional[str] = None,
                 autoscaler=None,
                 step_dt: Optional[float] = None,
                 submit_retries: int = 50,
                 max_steps: int = 20000,
                 settle_steps: int = 400,
                 clock: Optional[VirtualClock] = None,
                 tokenizer=None,
                 overload=None,
                 fault_schedule=None):
        self._router = router
        self._trace = trace
        self._model = model
        self._scaler = autoscaler
        self._overload = overload
        self._schedule = fault_schedule
        # grammar patterns in the trace are strings; compile each ONCE
        # against the tokenizer (default: the toy tokenizer over the
        # trace's vocab) and reuse — interning on the engine side then
        # dedups by (pattern, vocab, eos) too
        if tokenizer is None:
            from ..serving.grammar import toy_tokenizer
            tokenizer = toy_tokenizer(trace.config.vocab_size)
        self._tokenizer = tokenizer
        self._fsm_cache: Dict[str, object] = {}
        self._clock = clock or VirtualClock()
        self._step_dt = (float(step_dt) if step_dt is not None
                         else 2.0 / trace.config.arrival_rate)
        if self._step_dt <= 0:
            raise ValueError("step_dt must be > 0")
        self._retries = int(submit_retries)
        self._max_steps = int(max_steps)
        self._settle_steps = int(settle_steps)
        reg = metrics.get_registry()
        self._m_ttft = reg.histogram(
            "paddle_tpu_loadgen_ttft_seconds",
            "Client-observed time from submit to first streamed token, "
            "per SLO tier", labels=("tier",))
        self._m_itl = reg.histogram(
            "paddle_tpu_loadgen_itl_seconds",
            "Client-observed inter-token latency, per SLO tier",
            labels=("tier",))
        self._m_requests = reg.counter(
            "paddle_tpu_loadgen_requests_total",
            "Trace requests scored by the load driver, by SLO tier and "
            "outcome (finish reason, or \"rejected\"/\"lost\" driver-"
            "side outcomes)", labels=("tier", "outcome"))
        self._m_retries = reg.counter(
            "paddle_tpu_loadgen_submit_retries_total",
            "Submit attempts bounced by backpressure (429) or a fully "
            "gated fleet (503) and retried on a later sweep")
        self._m_breakdown = reg.histogram(
            "paddle_tpu_loadgen_ttft_breakdown_seconds",
            "Per-request TTFT attribution from the trace journal: "
            "seconds attributed to each named bucket "
            "(queue/compile/cold_prefill/warm_prefill/decode/migration/"
            "host_overhead), per SLO tier", labels=("tier", "bucket"))

    # ------------------------------------------------------------ callbacks
    def _make_cb(self, rec: _RequestRecord):
        """Per-request stream consumer: records the seq trail and
        terminal call, observes TTFT/ITL into the tier histograms, and
        burns host work when the trace flagged this consumer slow."""
        tier = rec.trace_req.tier
        slow = rec.trace_req.slow_consumer
        work = self._trace.config.slow_consumer_work
        ttft = self._m_ttft.labels(tier=tier)
        itl = self._m_itl.labels(tier=tier)

        def cb(rid, token, finished, seq):
            now = time.perf_counter()
            if finished:
                rec.terminals.append((finished, seq))
                return
            if not rec.seqs:
                rec.t_first = now
                ttft.observe(now - rec.t_submit)
            elif rec.t_prev is not None:
                itl.observe(now - rec.t_prev)
            rec.t_prev = now
            rec.seqs.append(seq)
            if slow:
                # a consumer that cannot keep up: bounded host work per
                # token (never a sleep — the run stays deterministic-fast)
                acc = 0
                for i in range(work):
                    acc += i & 7
        return cb

    # -------------------------------------------------------------- driving
    def run(self) -> LoadReport:
        # the ExitStack owns every fault injection the schedule arms:
        # whatever happens mid-run, the process-global fault registry
        # is clean when run() returns
        with contextlib.ExitStack() as stack:
            return self._run(stack)

    def _run(self, stack) -> LoadReport:
        router, trace = self._router, self._trace
        recs = [_RequestRecord(r) for r in trace.requests]
        pending: List[_RequestRecord] = []   # due, awaiting admission
        rejected: List[_RequestRecord] = []
        next_i = 0
        outputs: Dict[object, object] = {}
        dup_outputs: List[object] = []
        deltas = _CounterDeltas()
        engines_start = len(router.handles(self._model))
        engines_peak = engines_start
        steps = 0
        t0 = time.perf_counter()

        while (next_i < len(recs) or pending
               or router.has_work):
            if steps >= self._max_steps:
                break
            self._clock.advance(self._step_dt)
            now_v = self._clock.now()
            if self._schedule is not None:
                self._schedule.apply(router, self._model, now_v, stack)
            while (next_i < len(recs)
                   and recs[next_i].trace_req.arrival_s <= now_v):
                pending.append(recs[next_i])
                next_i += 1
            still_pending: List[_RequestRecord] = []
            for rec in pending:
                if not self._try_submit(rec):
                    if rec.attempts > self._retries:
                        rejected.append(rec)
                    else:
                        still_pending.append(rec)
            pending = still_pending
            router.step()
            steps += 1
            if self._scaler is not None:
                self._scaler.observe()
                engines_peak = max(engines_peak,
                                   len(router.handles(self._model)))
            if self._overload is not None:
                self._overload.observe()
            self._collect(router, outputs, dup_outputs)
        wall_s = time.perf_counter() - t0
        self._collect(router, outputs, dup_outputs)

        # settle: with the trace drained the signal goes cold — give an
        # attached autoscaler bounded idle sweeps to drain-then-remove
        # back to min_engines (scale-down is never instantaneous), and
        # an attached overload controller bounded sweeps to walk the
        # brownout ladder back to level 0 (de-escalation is paced by
        # cold_steps + cooldown, never instantaneous either)
        if self._scaler is not None or self._overload is not None:
            for _ in range(self._settle_steps):
                at_floor = (self._scaler is None
                            or (len(router.handles(self._model))
                                <= self._scaler.config.min_engines
                                and self._scaler._drain_target is None))
                restored = (self._overload is None
                            or self._overload.level == 0)
                if at_floor and restored and not router.has_work:
                    break
                if self._schedule is not None:
                    # keep virtual time flowing so timed revivals of
                    # killed engines still fire during settle
                    self._clock.advance(self._step_dt)
                    self._schedule.apply(router, self._model,
                                         self._clock.now(), stack)
                router.step()
                steps += 1
                if self._scaler is not None:
                    self._scaler.observe()
                if self._overload is not None:
                    self._overload.observe()
                self._collect(router, outputs, dup_outputs)

        return self._score(recs, rejected, outputs, dup_outputs, deltas,
                           wall_s, steps, engines_start, engines_peak)

    def _fsm(self, pattern: str):
        fsm = self._fsm_cache.get(pattern)
        if fsm is None:
            from ..serving.grammar import GrammarFSM
            fsm = GrammarFSM.compile(pattern, self._tokenizer)
            self._fsm_cache[pattern] = fsm
        return fsm

    def _try_submit(self, rec: _RequestRecord) -> bool:
        tr = rec.trace_req
        rec.attempts += 1
        rec.t_submit = time.perf_counter()
        kwargs = {}
        if tr.adapter_id is not None:
            kwargs["adapter_id"] = tr.adapter_id
        if tr.grammar is not None:
            kwargs["grammar"] = self._fsm(tr.grammar)
        try:
            rec.rid = self._router.submit(
                np.asarray(tr.prompt, np.int32), model=self._model,
                max_new_tokens=tr.max_new_tokens,
                temperature=tr.temperature, seed=tr.seed,
                deadline_s=tr.deadline_s, priority=tr.priority,
                stream_cb=self._make_cb(rec), **kwargs)
            return True
        except AdmissionShedError:
            # a shed is a TERMINAL answer (the controller predicted the
            # deadline is unmeetable, or the ladder is at
            # interactive-only) — scoring it, not retrying it, is the
            # honest-client behavior the retry_after_s contract implies
            rec.shed = True
            return True
        except (BackpressureError, NoHealthyEngineError):
            self._m_retries.inc()
            return False

    def _collect(self, router, outputs, dup_outputs) -> None:
        for rid, out in router.take_outputs().items():
            if rid in outputs:
                dup_outputs.append(rid)
            outputs[rid] = out

    # -------------------------------------------------------------- scoring
    def _score(self, recs, rejected, outputs, dup_outputs, deltas,
               wall_s, steps, engines_start, engines_peak) -> LoadReport:
        rep = LoadReport(seed=self._trace.config.seed,
                         num_requests=len(recs),
                         submitted=sum(1 for r in recs
                                       if r.rid is not None),
                         wall_s=wall_s,
                         steps=steps, engines_start=engines_start,
                         engines_peak=engines_peak,
                         engines_final=len(
                             self._router.handles(self._model)))
        rejected_set = set(id(r) for r in rejected)
        self._adp_tokens: Dict[str, int] = {}
        self._constrained = [0, 0]   # [validated, finished-constrained]
        tier_specs = {t.name: t for t in self._trace.config.tiers}
        for name, spec in tier_specs.items():
            rep.tiers[name] = TierReport(ttft_slo_s=spec.ttft_slo_s,
                                         itl_slo_s=spec.itl_slo_s)
        for rid in dup_outputs:
            rep.violations.append(f"req {rid!r}: duplicate output")

        for rec in recs:
            tier = rec.trace_req.tier
            rep.tiers[tier].requests += 1
            if id(rec) in rejected_set:
                outcome = "rejected"
                rep.rejected += 1
            elif rec.shed:
                outcome = "shed"
                # exactly-once extends to shed: a request the gate
                # refused must have NO engine-side life at all
                if rec.rid is not None or rec.seqs or rec.terminals:
                    rep.violations.append(
                        f"trace #{rec.trace_req.index}: shed at "
                        f"admission but has engine-side state "
                        f"(rid={rec.rid!r}, {len(rec.seqs)} tokens, "
                        f"{len(rec.terminals)} terminals)")
            elif rec.rid is None:
                # due but never admitted before the step cap — the run
                # was truncated, not the fleet's fault; score it lost
                # and flag the truncation
                outcome = "lost"
                rep.violations.append(
                    f"trace #{rec.trace_req.index}: never submitted "
                    f"(max_steps truncation)")
            else:
                outcome = self._score_one(rec, outputs, rep)
            rep.outcomes[outcome] = rep.outcomes.get(outcome, 0) + 1
            self._m_requests.labels(tier=tier, outcome=outcome).inc()

        n = len(recs)
        rep.unavailable_rate = rep.outcomes.get("unavailable", 0) / n
        rep.timeout_rate = rep.outcomes.get("timeout", 0) / n
        rep.shed_rate = rep.outcomes.get("shed", 0) / n
        rep.expired_rate = rep.outcomes.get("expired", 0) / n
        rep.goodput_tok_s = (rep.goodput_tokens / wall_s
                             if wall_s > 0 else 0.0)
        # TTFT attainment is EXACT — counted from the per-request
        # timestamps the driver holds, not read back through the
        # histogram (whose x2 exponential buckets interpolate: an SLO
        # bound inside a bucket would credit observations fractionally,
        # smearing a crisp count into a value that wobbles with bucket
        # geometry). ITL attainment stays a histogram read: thousands
        # of observations per tier make the interpolation error
        # negligible, and holding every gap would cost real memory.
        ttft_ok: Dict[str, int] = {}
        ttft_n: Dict[str, int] = {}
        for rec in recs:
            if rec.t_first is None:
                continue
            tier = rec.trace_req.tier
            ttft_n[tier] = ttft_n.get(tier, 0) + 1
            if (rec.t_first - rec.t_submit
                    <= rep.tiers[tier].ttft_slo_s):
                ttft_ok[tier] = ttft_ok.get(tier, 0) + 1
        for name, tr in rep.tiers.items():
            h_ttft = self._m_ttft.labels(tier=name)
            h_itl = self._m_itl.labels(tier=name)
            if ttft_n.get(name):
                tr.ttft_attainment = (ttft_ok.get(name, 0)
                                      / ttft_n[name])
            tr.itl_attainment = h_itl.fraction_le(tr.itl_slo_s)
            tr.ttft_p95_s = h_ttft.quantile(0.95)

        # TTFT attribution: decompose each first-token wait
        # into named buckets from the always-on trace journal. Per
        # request the buckets sum to (t_first - t_submit) exactly —
        # attribute_ttft pins the residual into host_overhead — so the
        # tier means below sum to the tier's mean measured TTFT.
        tracer = tracing.get_tracer()
        by_req: Dict[object, list] = {}
        for ev in tracer.events():
            by_req.setdefault(ev["req_id"], []).append(ev)
        bd_sums: Dict[str, Dict[str, float]] = {}
        bd_counts: Dict[str, int] = {}
        for rec in recs:
            if rec.rid is None or rec.t_first is None:
                continue
            evs = by_req.get(rec.rid)
            if not evs:
                continue
            bd = tracing.attribute_ttft(evs, rec.t_submit, rec.t_first)
            tier = rec.trace_req.tier
            sums = bd_sums.setdefault(
                tier, {b: 0.0 for b in tracing.TTFT_BUCKETS})
            for b, v in bd.items():
                sums[b] += v
                self._m_breakdown.labels(tier=tier, bucket=b).observe(v)
            bd_counts[tier] = bd_counts.get(tier, 0) + 1
        for name, n_tier in bd_counts.items():
            rep.tiers[name].ttft_breakdown = {
                b: bd_sums[name][b] / n_tier
                for b in tracing.TTFT_BUCKETS}
        tracer.flush_metrics()
        rep.prefix_hit_ratio = deltas.ratio(
            "paddle_tpu_serving_prefix_hits_total",
            "paddle_tpu_serving_prefix_misses_total")
        rep.spec_acceptance = deltas.ratio(
            "paddle_tpu_serving_spec_accepted_tokens_total",
            "paddle_tpu_serving_spec_drafted_tokens_total",
            of_total=True)
        rep.fresh_compiles = int(deltas.delta_labeled(
            "paddle_tpu_jit_compiles_total", source="fresh"))
        if self._scaler is not None:
            rep.scale_ups = sum(
                1 for d, _ in self._scaler.events if d == "scale-up")
            rep.scale_downs = sum(
                1 for d, _ in self._scaler.events if d == "scale-down")
        if wall_s > 0:
            rep.adapter_goodput = {
                k: v / wall_s for k, v in sorted(self._adp_tokens.items())}
        if self._constrained[1]:
            rep.constrained_validity = (self._constrained[0]
                                        / self._constrained[1])
        rep.exactly_once = not rep.violations
        return rep

    def _score_one(self, rec: _RequestRecord, outputs, rep) -> str:
        """Exactly-once structural checks for one submitted request;
        returns its outcome string."""
        tag = f"req {rec.rid!r} (trace #{rec.trace_req.index})"
        if len(rec.terminals) != 1:
            rep.violations.append(
                f"{tag}: {len(rec.terminals)} terminal stream calls "
                f"(want exactly 1): {rec.terminals}")
        if rec.seqs != list(range(len(rec.seqs))):
            rep.violations.append(
                f"{tag}: non-contiguous seq trail {rec.seqs[:12]}...")
        out = outputs.get(rec.rid)
        if out is None:
            rep.violations.append(f"{tag}: no output collected")
            return "lost"
        if rec.terminals:
            reason, term_seq = rec.terminals[0]
            if term_seq != len(rec.seqs):
                rep.violations.append(
                    f"{tag}: terminal seq {term_seq} != "
                    f"{len(rec.seqs)} streamed tokens")
            if reason != out.finish_reason:
                rep.violations.append(
                    f"{tag}: stream terminal {reason!r} != output "
                    f"finish_reason {out.finish_reason!r}")
        if len(out.token_ids) != len(rec.seqs):
            rep.violations.append(
                f"{tag}: output has {len(out.token_ids)} tokens, "
                f"stream delivered {len(rec.seqs)}")
        rep.total_tokens += len(out.token_ids)
        tr = rec.trace_req
        if out.finish_reason in ("stop", "length"):
            rep.goodput_tokens += len(out.token_ids)
            key = tr.adapter_id or ""
            self._adp_tokens[key] = (self._adp_tokens.get(key, 0)
                                     + len(out.token_ids))
            if tr.grammar is not None:
                # validity is re-derived from the DELIVERED tokens, not
                # trusted from the engine: the drill's acceptance gate.
                # A "stop" that fails to validate is an engine bug and a
                # violation; a "length" truncation mid-structure only
                # lowers the rate (the client asked for too few tokens).
                self._constrained[1] += 1
                if self._fsm(tr.grammar).validates(out.token_ids):
                    self._constrained[0] += 1
                elif out.finish_reason == "stop":
                    rep.violations.append(
                        f"{tag}: constrained output does not validate "
                        f"against {tr.grammar!r}")
        return out.finish_reason


class _CounterDeltas:
    """Snapshot of the scored process-global counters at construction
    (run start); reads back run-scoped deltas at scoring time — loadgen
    shares the registry with everything else in the process, so
    absolute values would score other traffic too."""

    _NAMES = ("paddle_tpu_serving_prefix_hits_total",
              "paddle_tpu_serving_prefix_misses_total",
              "paddle_tpu_serving_spec_accepted_tokens_total",
              "paddle_tpu_serving_spec_drafted_tokens_total")
    _LABELED = (("paddle_tpu_jit_compiles_total", {"source": "fresh"}),)

    def __init__(self):
        self._reg = metrics.get_registry()
        self._base = {n: self._value(n) for n in self._NAMES}
        self._base_labeled = {
            (n, tuple(sorted(kv.items()))): self._value_labeled(n, kv)
            for n, kv in self._LABELED}

    def _value(self, name: str) -> float:
        fam = self._reg.get(name)
        return float(fam.value) if fam is not None else 0.0

    def _value_labeled(self, name: str, labels: dict) -> float:
        fam = self._reg.get(name)
        if fam is None:
            return 0.0
        try:
            return float(fam.sum_labels(**labels))
        except Exception:
            return 0.0

    def delta(self, name: str) -> float:
        return self._value(name) - self._base.get(name, 0.0)

    def ratio(self, num_name: str, den_name: str,
              of_total: bool = False) -> Optional[float]:
        """num/(num+den) — or num/den when ``of_total`` (the denominator
        already includes the numerator, e.g. accepted/drafted). None
        when the denominator delta is zero (feature dark this run)."""
        num = self.delta(num_name)
        den = self.delta(den_name) if of_total \
            else self.delta(num_name) + self.delta(den_name)
        if den <= 0:
            return None
        return num / den

    def delta_labeled(self, name: str, **labels) -> float:
        key = (name, tuple(sorted(labels.items())))
        return (self._value_labeled(name, labels)
                - self._base_labeled.get(key, 0.0))
