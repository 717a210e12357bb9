"""Per-request tracing and the always-on flight recorder.

Counterpart of ``paddle_tpu/serving/tracing.py`` (its own copy): the
engine journals the lifecycle of every request into one process-wide
ring, so the time of a slow request can be split into queue wait,
chunked prefill, compile (here: the capture of a bucket's CUDA graph)
and decode, instead of read off an aggregate histogram.

- **Bounded ring.** :class:`RequestTracer` preallocates ``capacity``
  slots and overwrites the oldest event when full; the overwrite count
  reaches ``paddle_tpu_trace_dropped_events_total`` lazily.
- **Exactly-once keys.** Every event is keyed ``(req_id, seq)`` with a
  per-request monotone ``seq`` kept by the process-wide tracer, so a
  duplicated or missing event is detectable (:func:`validate_events`).
- **Injectable monotonic clock**, ``time.perf_counter`` by default, the
  clock the engine stamps arrivals with, which lets
  :func:`attribute_ttft` partition a measured TTFT exactly.
- **Low overhead.** Disabled tracing is one flag check; enabled,
  ``emit`` writes a preallocated slot in place: no metric, no lock.
- **Flight recorder.** :meth:`RequestTracer.dump_flight` writes the last
  ``window_s`` seconds of timeline as JSON (under the fault point
  ``tracing.dump``).

The engine's events keep the JAX engine's names (:data:`EVENTS`), so a
per-request event sequence of one engine can be held against the
other's.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Callable, Dict, List, Optional

from .. import faults, metrics

__all__ = [
    "EVENTS", "RequestTracer", "TTFT_BUCKETS", "attribute_ttft",
    "get_tracer", "set_tracer", "validate_events",
]

faults.declare_point(
    "tracing.dump", "top of RequestTracer.dump_flight, before the ring "
    "snapshot and the post-mortem file write — a raise simulates a full "
    "disk / unwritable flight dir; callers (router crash containment, "
    "/healthz transitions) must treat a failed dump as diagnostics "
    "lost, never as a serving failure")

# The event-name catalog, the JAX package's: ``req.*`` events key on the
# request id; ``step.*`` events are engine-scoped (their req_id is the
# engine_id string). The port's engine emits a subset (the router's and
# the WAL's events belong to pieces not ported yet).
EVENTS: Dict[str, str] = {
    "req.enqueue": "request entered an engine queue (arg: prompt tokens)",
    "req.dispatch": "router placed the request (label: engine_id)",
    "req.admit": "parked in a slot (arg: prefix-matched tokens; "
                 "label: engine_id)",
    "req.prefix_hit": "radix prefix-cache hit at admission (arg: "
                      "matched tokens; only emitted when > 0)",
    "req.chunk_planned": "plan_chunks granted this slot a prompt chunk "
                         "(arg: chunk tokens)",
    "req.drafts": "plan_drafts granted speculative draft rows, post "
                  "grammar pre-filter (arg: draft tokens)",
    "req.compile": "a fresh token-grid bucket compiled under this "
                   "request (arg: build+step seconds)",
    "req.chunk": "prompt chunk landed (arg: chunk tokens)",
    "req.spec_accept": "draft burst verified (arg: accepted drafts)",
    "req.spec_reject": "draft burst rolled back via pool.truncate "
                       "(arg: rejected drafts)",
    "req.grammar_mask": "constrained token landed, DFA advanced "
                        "(arg: new FSM state)",
    "req.token": "stream chunk emitted (arg: stream seq)",
    "req.retire": "terminal (label: finish_reason)",
    "req.export": "in-flight journal exported off a dying engine "
                  "(arg: journal length; label: engine_id)",
    "req.adopt": "journal adopted by a sibling engine (arg: journal "
                 "length; label: engine_id)",
    "req.requeue": "waiting request moved to a sibling (label: target "
                   "engine_id)",
    "req.recover": "request re-admitted from the WAL after a process "
                   "restart (arg: journaled tokens; label: adoptive "
                   "engine_id)",
    "req.migrate": "in-flight request migrated to a sibling (label: "
                   "target engine_id)",
    "req.shed": "refused at admission by the overload controller "
                "(arg: predicted wait s; label: cause)",
    "req.preempt": "batch-tier decode slot journaled and requeued by "
                   "the brownout ladder (arg: journal length; label: "
                   "engine_id)",
    "req.expire": "deadline lapsed while still queued — retired "
                  "\"expired\", pages never allocated (label: "
                  "engine_id)",
    "step.tokens": "one engine step (req_id: engine_id; arg: tokens "
                   "landed this step)",
    "brownout.level": "brownout ladder transition (req_id: model_id; "
                      "arg: new level; label: level name)",
}

# TTFT attribution buckets: per-request bucket values always sum exactly
# to the measured TTFT; the residual (clock tails, submit overhead,
# un-journaled gaps from a wrapped ring) is pinned into host_overhead
# rather than dropped.
TTFT_BUCKETS = ("queue", "compile", "cold_prefill", "warm_prefill",
                "decode", "migration", "host_overhead")

_MIGRATION_EVENTS = frozenset(
    ("req.export", "req.adopt", "req.requeue", "req.migrate"))
_DECODE_EVENTS = frozenset(("req.token", "req.grammar_mask",
                            "req.spec_accept", "req.spec_reject"))
_QUEUE_EVENTS = frozenset(("req.admit", "req.prefix_hit"))

_REASON_SAFE_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


class RequestTracer:
    """Always-on bounded event journal keyed ``(req_id, seq)``.

    One process-wide instance (:func:`get_tracer`) serves the whole
    fleet: every engine and the router emit into the same ring, which is
    what makes a migrated request's timeline contiguous — its seq
    counter lives here, not on any engine.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True,
                 flight_dir: Optional[str] = None,
                 window_s: float = 30.0):
        cap = max(int(capacity), 16)
        self._cap = cap
        # preallocated mutable slots [t, req_id, seq, name, arg, label]
        # — emit() writes fields in place, so a full ring never grows
        self._ring: List[list] = [[0.0, None, 0, "", 0.0, ""]
                                  for _ in range(cap)]
        self._head = 0          # next slot to write
        self._count = 0         # filled slots (== cap once wrapped)
        self._seq: Dict[object, int] = {}
        self._dropped = 0       # local; flushed lazily to the counter
        self._dumps = 0
        self.enabled = bool(enabled)
        self._clock = clock
        self.window_s = float(window_s)
        self.flight_dir = flight_dir

    # ------------------------------------------------------------- hot path
    def emit(self, name: str, req_id, arg: float = 0.0, label: str = "",
             t: Optional[float] = None) -> None:
        """Journal one event. Disabled = this flag check; enabled = a
        dict get/set (the per-request seq) plus six in-place slot
        writes. Never raises, never locks, never touches a metric."""
        if not self.enabled:
            return
        if t is None:
            t = self._clock()
        seq = self._seq.get(req_id, 0)
        self._seq[req_id] = seq + 1
        i = self._head
        if self._count < self._cap:
            self._count += 1
        else:
            self._dropped += 1          # overwrote the oldest event
        slot = self._ring[i]
        slot[0] = t
        slot[1] = req_id
        slot[2] = seq
        slot[3] = name
        slot[4] = arg
        slot[5] = label
        self._head = 0 if i + 1 == self._cap else i + 1

    # ------------------------------------------------------------ snapshots
    def events(self) -> List[dict]:
        """Chronological snapshot of the ring as event dicts — the read
        side (attribution, dumps, trace_dump) allocates; the write side
        never does."""
        if self._count < self._cap:
            raw = self._ring[:self._count]
        else:
            raw = self._ring[self._head:] + self._ring[:self._head]
        return [{"t": s[0], "req_id": s[1], "seq": s[2], "name": s[3],
                 "arg": s[4], "label": s[5]} for s in raw]

    def events_for(self, req_id) -> List[dict]:
        """This request's timeline in seq order — contiguous across any
        number of migration hops (one global seq stream per req_id)."""
        out = [e for e in self.events() if e["req_id"] == req_id]
        out.sort(key=lambda e: e["seq"])
        return out

    @property
    def dropped(self) -> int:
        """Events overwritten before any export (local, pre-flush)."""
        return self._dropped

    def reset(self) -> None:
        """Forget everything (benchmark isolation). The ring stays
        allocated; seq counters restart at 0 for every req_id."""
        self._head = 0
        self._count = 0
        self._seq.clear()
        self._dropped = 0

    # -------------------------------------------------------------- metrics
    def flush_metrics(self) -> None:
        """Move the locally-accumulated drop count into the registry —
        called from dump/score/export paths, NEVER per event, so the
        step path stays metric-free."""
        reg = metrics.get_registry()
        dropped = reg.counter(
            "paddle_tpu_trace_dropped_events_total",
            "Trace ring events overwritten before any export read them")
        if self._dropped:
            dropped.inc(self._dropped)
            self._dropped = 0

    # ------------------------------------------------------ flight recorder
    def dump_flight(self, reason: str, path: Optional[str] = None,
                    window_s: Optional[float] = None,
                    now: Optional[float] = None) -> str:
        """Write the last ``window_s`` seconds of fleet timeline to disk
        as JSON (``events`` chronological + ``requests`` grouped per
        req_id in seq order) and return the file path. Callers on the
        serving path guard this — a failed dump loses diagnostics, not
        requests (the ``tracing.dump`` fault point drills it)."""
        faults.point("tracing.dump")
        if now is None:
            now = self._clock()
        win = self.window_s if window_s is None else float(window_s)
        evs = [e for e in self.events() if e["t"] >= now - win]
        requests: Dict[str, List[dict]] = {}
        for e in evs:
            requests.setdefault(str(e["req_id"]), []).append(e)
        for timeline in requests.values():
            timeline.sort(key=lambda e: e["seq"])
        payload = {"reason": str(reason), "t_dump": now, "window_s": win,
                   "dropped_events": self._dropped,
                   "events": evs, "requests": requests}
        if path is None:
            d = (self.flight_dir
                 or os.environ.get("PADDLE_TPU_FLIGHT_DIR")
                 or os.path.join(tempfile.gettempdir(),
                                 "paddle_tpu_flight"))
            os.makedirs(d, exist_ok=True)
            self._dumps += 1
            safe = _REASON_SAFE_RE.sub("-", str(reason)) or "dump"
            path = os.path.join(
                d, f"flight-{os.getpid()}-{self._dumps:03d}-{safe}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
        reg = metrics.get_registry()
        reg.counter("paddle_tpu_trace_recorder_dumps_total",
                    "Flight-recorder dumps by trigger",
                    labels=("reason",)).labels(reason=str(reason)).inc()
        self.flush_metrics()
        return path


def validate_events(events: List[dict]) -> List[str]:
    """Exactly-once audit of one request's timeline: every ``(req_id,
    seq)`` unique, seqs contiguous from the smallest captured one (a
    wrapped ring legitimately loses the OLDEST prefix, never punches a
    hole). Returns human-readable problems; [] is the pass."""
    problems: List[str] = []
    by_req: Dict[object, List[int]] = {}
    for e in events:
        by_req.setdefault(e["req_id"], []).append(int(e["seq"]))
    for rid, seqs in sorted(by_req.items(), key=lambda kv: str(kv[0])):
        seqs.sort()
        dupes = sorted({s for i, s in enumerate(seqs)
                        if i and seqs[i - 1] == s})
        if dupes:
            problems.append(f"req {rid}: duplicate seq(s) {dupes}")
        want = list(range(seqs[0], seqs[0] + len(seqs)))
        if not dupes and seqs != want:
            missing = sorted(set(want) - set(seqs))[:8]
            problems.append(f"req {rid}: missing seq(s) {missing}")
    return problems


def attribute_ttft(events: List[dict], t_submit: float,
                   t_first: float) -> Dict[str, float]:
    """Decompose one request's measured TTFT into :data:`TTFT_BUCKETS`.

    Partition ``(t_submit, t_first]`` at the request's trace events and
    charge each gap to the bucket of the event that ENDS it: the wait
    that ended in admission was queue time, the wait that ended in a
    chunk landing was prefill (warm when a prefix-cache hit covered part
    of the prompt, cold otherwise), the wait that ended in a fresh-
    bucket compile was compile, a migration-hop event charges its gap to
    migration. Whatever the events don't cover — submit overhead, the
    tail after the last event, timelines truncated by ring wrap — lands
    in ``host_overhead`` as the exact residual, so::

        sum(attribute_ttft(...).values()) == t_first - t_submit

    holds to float precision.
    """
    out = {b: 0.0 for b in TTFT_BUCKETS}
    measured = t_first - t_submit
    window = [e for e in events if t_submit < e["t"] <= t_first]
    window.sort(key=lambda e: e["seq"])
    warm = any(e["name"] == "req.prefix_hit" for e in window)
    prev = t_submit
    classified = 0.0
    for e in window:
        gap = e["t"] - prev
        prev = e["t"]
        if gap <= 0.0:
            continue
        name = e["name"]
        if name in _QUEUE_EVENTS:
            bucket = "queue"
        elif name == "req.compile":
            bucket = "compile"
        elif name == "req.chunk":
            bucket = "warm_prefill" if warm else "cold_prefill"
        elif name in _DECODE_EVENTS:
            bucket = "decode"
        elif name in _MIGRATION_EVENTS:
            bucket = "migration"
        else:
            # enqueue/dispatch/plan decisions: host bookkeeping
            bucket = "host_overhead"
        out[bucket] += gap
        classified += gap
    out["host_overhead"] += measured - classified
    return out


# --------------------------------------------------------- default tracer
_default_tracer: Optional[RequestTracer] = None


def get_tracer() -> RequestTracer:
    """The process-wide tracer every engine shares, created on first use
    from the env knobs: ``PADDLE_TPU_TRACE=0`` disables,
    ``PADDLE_TPU_TRACE_CAPACITY`` sizes the ring, ``PADDLE_TPU_FLIGHT_DIR``
    / ``PADDLE_TPU_FLIGHT_WINDOW_S`` steer the flight recorder."""
    global _default_tracer
    if _default_tracer is None:
        _default_tracer = RequestTracer(
            capacity=int(os.environ.get("PADDLE_TPU_TRACE_CAPACITY",
                                        "65536") or 65536),
            enabled=os.environ.get("PADDLE_TPU_TRACE", "1") != "0",
            flight_dir=os.environ.get("PADDLE_TPU_FLIGHT_DIR"),
            window_s=float(os.environ.get("PADDLE_TPU_FLIGHT_WINDOW_S",
                                          "30") or 30.0))
    return _default_tracer


def set_tracer(tracer: Optional[RequestTracer]) -> \
        Optional[RequestTracer]:
    """Swap the process-wide tracer (tests inject a virtual clock or a
    tiny ring); returns the previous one. ``None`` resets to lazy env
    construction."""
    global _default_tracer
    old = _default_tracer
    _default_tracer = tracer
    return old
