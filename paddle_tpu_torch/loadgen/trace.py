"""Seeded, deterministic serving traces.

Counterpart of ``paddle_tpu/loadgen/trace.py``: the same
:class:`TraceConfig` gives the same trace in both packages.

A trace is the workload half of the load harness: a fixed list of
:class:`TraceRequest`\\ s with *virtual* arrival instants, generated as a
pure function of :class:`TraceConfig` (one ``np.random.default_rng(seed)``
drives every draw, in one fixed order) — the same config byte-reproduces
the same trace on any host, with no wall clock anywhere near
generation. The knobs mirror what production
LLM traffic actually looks like:

- **Zipf prompt sharing** — each request's prompt starts with one of
  ``num_prompt_families`` shared prefixes, the family drawn from a
  bounded Zipf law (:func:`zipf_pmf`); a hot system prompt dominates,
  exercising the radix prefix cache exactly like fleet traffic does.
- **Poisson + burst arrivals** — exponential inter-arrival gaps at
  ``arrival_rate`` requests per virtual second, with an optional window
  where the rate multiplies by ``burst_factor`` (the autoscaler drill).
- **Heavy-tail lengths** — prompt-suffix and output lengths are
  lognormal (capped), so a few hogs ride among many shorts.
- **SLO tiers** — every request lands in a :class:`TierSpec` (weighted
  draw): scheduler priority, optional deadline, and the TTFT/ITL bounds
  the driver scores attainment against.
- **Slow consumers** — a seeded fraction of requests is flagged
  ``slow_consumer``; the driver burns host work inside their stream
  callbacks, modeling a client that cannot keep up with its stream.

Virtual time is owned by :class:`VirtualClock` — the driver maps it onto
``router.step()`` sweeps, so a "60 second" trace replays in however long
the engines actually take, reproducibly and fast on CPU.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["TierSpec", "TraceConfig", "TraceRequest", "Trace",
           "VirtualClock", "generate_trace", "zipf_pmf", "DEFAULT_TIERS"]


class VirtualClock:
    """An injectable clock that only moves when told to: ``now()`` reads,
    ``advance(dt)`` ticks. Callable, so it drops into any ``clock=`` slot
    (e.g. ``faults.Deadline(seconds, clock=vclock)``) — tests and the
    load driver drive time deterministically instead of sleeping."""

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("virtual time cannot run backwards")
        self._now += float(dt)
        return self._now

    def __call__(self) -> float:
        return self._now

    def __repr__(self) -> str:
        return f"VirtualClock(t={self._now:.3f})"


@dataclass(frozen=True)
class TierSpec:
    """One SLO tier: the scheduler priority and deadline the request
    carries into the engine, and the TTFT/ITL bounds the driver scores
    attainment against (bounds are *scoring* knobs — missing one never
    cancels a request; only ``deadline_s`` does that, via the engine's
    own deadline machinery)."""

    name: str
    priority: int = 0            # lower = more urgent (scheduler order)
    weight: float = 1.0          # relative share of the request mix
    deadline_s: Optional[float] = None   # engine-enforced; None = never
    ttft_slo_s: float = 2.0
    itl_slo_s: float = 1.0


DEFAULT_TIERS: Tuple[TierSpec, ...] = (
    TierSpec("interactive", priority=0, weight=0.3, ttft_slo_s=1.0,
             itl_slo_s=0.5),
    TierSpec("standard", priority=1, weight=0.5, ttft_slo_s=2.0,
             itl_slo_s=1.0),
    TierSpec("batch", priority=2, weight=0.2, ttft_slo_s=10.0,
             itl_slo_s=5.0),
)


@dataclass(frozen=True)
class TraceConfig:
    """Everything :func:`generate_trace` draws from — the full knob set
    of the load harness."""

    seed: int = 0
    num_requests: int = 64
    vocab_size: int = 128
    # arrivals: Poisson at arrival_rate req/virtual-second; inside
    # [burst_start, burst_start + burst_duration) the rate multiplies
    arrival_rate: float = 8.0
    burst_start: Optional[float] = None
    burst_duration: float = 0.0
    burst_factor: float = 4.0
    # Zipf prompt sharing: family drawn ∝ 1/rank^zipf_a over
    # num_prompt_families shared prefixes of prefix_len tokens
    num_prompt_families: int = 8
    zipf_a: float = 1.2
    prefix_len: int = 8
    # heavy-tail lengths (lognormal, capped)
    suffix_len_mean: float = 6.0
    suffix_len_sigma: float = 0.6
    max_prompt_len: int = 32
    output_len_mean: float = 6.0
    output_len_sigma: float = 0.7
    max_output_len: int = 16
    temperature: float = 0.8
    # slow streaming consumers: seeded fraction of requests whose
    # stream callback burns slow_consumer_work host iterations per token
    slow_consumer_fraction: float = 0.0
    slow_consumer_work: int = 2000
    tiers: Tuple[TierSpec, ...] = DEFAULT_TIERS
    # multi-tenancy mixes. adapter_mix: weighted
    # (adapter_id, weight) pairs — None as an id means "no adapter"
    # (the base model share). schema_mix: weighted (regex, weight)
    # pairs of CONSTRAINT PATTERNS (strings, so the trace stays
    # JSON-serializable; the driver compiles each to a GrammarFSM
    # against its tokenizer) — None as a pattern means unconstrained.
    # Both default None = feature off: NO extra rng draws happen, so
    # traces without them byte-reproduce unchanged.
    adapter_mix: Optional[Tuple[Tuple[Optional[str], float], ...]] = None
    schema_mix: Optional[Tuple[Tuple[Optional[str], float], ...]] = None

    def __post_init__(self):
        if self.num_requests < 1:
            raise ValueError("num_requests must be >= 1")
        if self.arrival_rate <= 0:
            raise ValueError("arrival_rate must be > 0")
        if self.num_prompt_families < 1:
            raise ValueError("num_prompt_families must be >= 1")
        if not self.tiers:
            raise ValueError("at least one TierSpec is required")
        if self.prefix_len >= self.max_prompt_len:
            raise ValueError("prefix_len must leave room for a suffix "
                             "(prefix_len < max_prompt_len)")
        if not 0.0 <= self.slow_consumer_fraction <= 1.0:
            raise ValueError("slow_consumer_fraction must be in [0, 1]")
        for knob in ("adapter_mix", "schema_mix"):
            mix = getattr(self, knob)
            if mix is None:
                continue
            if not mix:
                raise ValueError(f"{knob} must be None (off) or a "
                                 "non-empty weighted tuple")
            for entry, w in mix:
                if entry is not None and not isinstance(entry, str):
                    raise ValueError(
                        f"{knob} entries must be str or None, got "
                        f"{entry!r}")
                if w <= 0:
                    raise ValueError(f"{knob} weights must be > 0")


@dataclass(frozen=True)
class TraceRequest:
    """One generated request: arrival instant in virtual seconds plus
    everything the driver forwards to ``router.submit`` and everything
    the scorer needs (tier SLOs, slow-consumer flag). ``prompt`` is a
    plain int tuple so the trace is hashable/serializable as-is."""

    index: int
    arrival_s: float
    prompt: Tuple[int, ...]
    family: int
    max_new_tokens: int
    temperature: float
    seed: int
    tier: str
    priority: int
    deadline_s: Optional[float]
    ttft_slo_s: float
    itl_slo_s: float
    slow_consumer: bool
    # multi-tenancy: the LoRA tenant and the constraint
    # PATTERN (a regex string — the driver compiles it). Defaults keep
    # asdict()/to_jsonl() append-only vs traces without them.
    adapter_id: Optional[str] = None
    grammar: Optional[str] = None


@dataclass
class Trace:
    """The generated request stream (sorted by arrival) + its config."""

    config: TraceConfig
    requests: List[TraceRequest] = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        """Last arrival instant in virtual seconds (0.0 when empty)."""
        return self.requests[-1].arrival_s if self.requests else 0.0

    def tier_counts(self) -> dict:
        out: dict = {}
        for r in self.requests:
            out[r.tier] = out.get(r.tier, 0) + 1
        return out

    def to_jsonl(self) -> str:
        """Canonical serialization — one JSON object per request, sorted
        keys, fixed float formatting via ``repr`` round-trip. Two traces
        are THE SAME trace iff these bytes match (the reproducibility
        fingerprint tests/test_loadgen.py pins)."""
        return "\n".join(
            json.dumps(asdict(r), sort_keys=True) for r in self.requests)


def zipf_pmf(n: int, a: float) -> np.ndarray:
    """Bounded Zipf law over ranks ``1..n``: ``p(k) ∝ k**-a``,
    normalized. The closed form the share-ratio tests compare against —
    and the exact distribution :func:`generate_trace` draws families
    from (one source of truth)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -float(a)
    return p / p.sum()


def _arrival_times(cfg: TraceConfig, rng: np.random.Generator) -> list:
    """Sequential Poisson arrivals with a rate-multiplied burst window:
    each gap is exponential at the rate in force at the PREVIOUS arrival
    instant (a piecewise-homogeneous process — inside the window the
    process is Poisson at ``rate * burst_factor``, which is what the
    closed-form interarrival tests check per segment)."""
    t = 0.0
    out = []
    for _ in range(cfg.num_requests):
        rate = cfg.arrival_rate
        if (cfg.burst_start is not None
                and cfg.burst_start <= t
                < cfg.burst_start + cfg.burst_duration):
            rate *= cfg.burst_factor
        t += float(rng.exponential(1.0 / rate))
        out.append(t)
    return out


def _heavy_tail_len(rng: np.random.Generator, mean: float, sigma: float,
                    cap: int) -> int:
    """Lognormal with the given *linear-scale* mean, clamped to
    ``[1, cap]`` — a handful of hogs among many shorts."""
    v = rng.lognormal(np.log(max(mean, 1.0)), sigma)
    return int(min(max(round(v), 1), cap))


def generate_trace(config: TraceConfig) -> Trace:
    """Generate the trace: a pure function of ``config`` (every random
    draw comes from one ``default_rng(config.seed)`` in one fixed
    order), so equal configs yield byte-identical ``to_jsonl()``."""
    cfg = config
    rng = np.random.default_rng(cfg.seed)

    # family prefixes up front, in family order, so prompt content never
    # depends on which request happened to draw a family first
    prefixes = [tuple(int(x) for x in
                      rng.integers(1, cfg.vocab_size, (cfg.prefix_len,)))
                for _ in range(cfg.num_prompt_families)]
    fam_p = zipf_pmf(cfg.num_prompt_families, cfg.zipf_a)
    tier_w = np.asarray([t.weight for t in cfg.tiers], np.float64)
    tier_p = tier_w / tier_w.sum()
    arrivals = _arrival_times(cfg, rng)

    reqs: List[TraceRequest] = []
    for i, t_arr in enumerate(arrivals):
        fam = int(rng.choice(cfg.num_prompt_families, p=fam_p))
        suffix_cap = cfg.max_prompt_len - cfg.prefix_len
        n_suffix = _heavy_tail_len(rng, cfg.suffix_len_mean,
                                   cfg.suffix_len_sigma, suffix_cap)
        suffix = tuple(int(x) for x in
                       rng.integers(1, cfg.vocab_size, (n_suffix,)))
        n_out = _heavy_tail_len(rng, cfg.output_len_mean,
                                cfg.output_len_sigma, cfg.max_output_len)
        tier = cfg.tiers[int(rng.choice(len(cfg.tiers), p=tier_p))]
        req_seed = int(rng.integers(0, 2**31 - 1))
        slow = bool(rng.random() < cfg.slow_consumer_fraction)
        # tenancy draws are GATED on the knob being set: an off knob
        # consumes no rng state, so configs without it byte-reproduce
        adapter = None
        if cfg.adapter_mix is not None:
            aw = np.asarray([w for _, w in cfg.adapter_mix], np.float64)
            adapter = cfg.adapter_mix[
                int(rng.choice(len(cfg.adapter_mix), p=aw / aw.sum()))][0]
        pattern = None
        if cfg.schema_mix is not None:
            sw = np.asarray([w for _, w in cfg.schema_mix], np.float64)
            pattern = cfg.schema_mix[
                int(rng.choice(len(cfg.schema_mix), p=sw / sw.sum()))][0]
        reqs.append(TraceRequest(
            index=i, arrival_s=float(t_arr),
            prompt=prefixes[fam] + suffix, family=fam,
            max_new_tokens=n_out, temperature=cfg.temperature,
            seed=req_seed, tier=tier.name, priority=tier.priority,
            deadline_s=tier.deadline_s, ttft_slo_s=tier.ttft_slo_s,
            itl_slo_s=tier.itl_slo_s, slow_consumer=slow,
            adapter_id=adapter, grammar=pattern))
    return Trace(config=cfg, requests=reqs)
