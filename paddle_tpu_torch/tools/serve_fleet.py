"""The serving control plane's chaos drills, on port engines at full width.

    python -m paddle_tpu_torch.tools.serve_fleet [--drills a,b] [--with-gpt]

Counterpart of the JAX package's ``tools/chaos_serve.py`` scenarios 7 and
9-20 (names as in its ``SCENARIOS``), each asserting what its JAX
counterpart asserts, over routers of the port's engines: Llama-0.76B at
full width on a card, every engine capturing its own CUDA graph per
token-grid bucket, migration and recovery re-prefilling journaled tokens
through the adoptive engine's buckets between replays. Prompts are the
JAX drills' lengths times ``Fleet.scale`` (16 on a card, so a 4-token
page becomes a 16-token one), over the model's vocabulary. A stream that
must equal an uninterrupted run is held token for token against a lone
engine of the same model run eagerly (its kernels are the graphed
step's).

7. ``router-failover-requeue-once``: a NaN-poisoned and degraded engine;
   its queue moves to the sibling once; a dark fleet retires the rest
   ``"unavailable"``.
9. ``router-least-loaded-dispatch``: two hogs on one engine; least-loaded
   dispatch beats round-robin on the queue waits (p95 and mean), read
   from the request tracer's enqueue and admit times.
10. ``kill-engine-mid-decode``, 11. ``prefix-cache-failover-migration``,
    12. ``kill-engine-mid-chunked-prefill``, 14.
    ``kill-engine-mid-spec-burst``, 16.
    ``kill-engine-mid-constrained-adapter-stream``, 17.
    ``flight-recorder-on-crash``, 18. ``kill-engine-with-offloaded-pages``:
    the busiest engine dies at a scheduled step (``router.engine_step``);
    its work migrates; every stream equals the uninterrupted one, its
    chunks exactly-once; only committed tokens are journaled (14); the
    sibling's prefix cache covers the resumed prompt (11, 12); FSM states
    ride the journal (16); the flight recorder dumps the hop (17); a
    parked int8 stream's host pages drain on the dead engine and the
    sibling re-serves both through its own park/unpark (18).
13. ``thread-fuzz-control-plane``: driver, ``/metrics`` scraper and
    ``health()`` prober threads race under ``faults.LockSanitizer``. It
    keeps every racer of the JAX drill but its rolling reloads
    (``Router.reload`` waits for the checkpoint slice). Only the driver
    thread launches device work; the others read host state.
15. ``autoscale-under-burst``: a Poisson burst scales a one-engine fleet
    up and back to one, every request exactly-once. The JAX drill asserts
    zero fresh compiles, which its persistent compile cache gives it. A
    CUDA graph cannot move to another engine's memory pool, so here the
    contract is: no ``nvcc`` run after the warm phase, each new engine
    captures only its own bucket (at most one: ``min_step_tokens`` pins
    the grid; none if it served nothing), the fresh-compile counter moves
    by exactly those captures, and their seconds are printed.
19. ``brownout-under-burst``: a tiered 16x burst on a capped fleet under a
    step-latency storm and an engine kill, the overload controller armed:
    the ladder climbs to preemption and back to 0, doomed work is shed,
    the interactive tier keeps its TTFT.
20. ``kill-serving-process-mid-decode``: ``loadgen.restart``'s drill on a
    WAL-armed fleet of child processes, SIGKILLed mid-decode (holding its
    CUDA context) and recovered on one engine fewer: streams bit-identical
    with seqs exactly-once. The JAX drill asserts zero fresh compiles
    during recovery; here the recovering child runs no ``nvcc`` (it loads
    the kernels the parent built), captures only its own engine's buckets,
    and prints their seconds.

Plus ``multi-model-completion-api``: ``CompletionAPI`` routes by
``model`` between a three-engine Llama fleet and a GPT engine
(``Fleet.gpt``) on one card, each choice equal to the lone engine of its
model.

A failed check raises :class:`DrillFailed`. Each drill returns a record
with its seconds, migrations, captures and ``nvcc`` runs.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import statistics
import tempfile
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import bench, faults, loadgen, metrics
from ..device import default_device
from ..models import LlamaConfig, LlamaForCausalLM
from ..ops import _build
from ..serving import (CompletionAPI, GrammarFSM, OverloadConfig,
                       OverloadController, RetryBudget, Router,
                       ServingEngine, random_adapter, toy_tokenizer, tracing)

__all__ = ["DrillFailed", "Fleet", "DRILLS", "run_drills", "main"]


class DrillFailed(AssertionError):
    """A fleet drill's check failed."""


def _check(cond, what: str) -> None:
    if not cond:
        raise DrillFailed(what)


def _counter(name: str, **labels) -> float:
    fam = metrics.get_registry().get(name)
    if fam is None:
        return 0.0
    if labels and set(labels) != set(fam.label_names):
        return fam.sum_labels(**labels)
    return (fam.labels(**labels) if labels else fam).value


@dataclass
class Fleet:
    """What the drills serve: ``model`` (a Llama) on ``device``, pages of
    ``page_size`` in ``kv_dtype``; prompt lengths are the JAX drills'
    times ``scale``; ``gpt`` serves the multi-model drill. ``made``
    holds the engines the running drill built (``run_drills`` sums their
    captures and lets them go after each drill)."""

    model: object
    device: torch.device
    kv_dtype: object = torch.bfloat16
    page_size: int = 16
    scale: int = 16
    gpt: Optional[object] = None
    restart_size: str = "llama_076b"
    fuzz_iters: int = 200
    made: List[ServingEngine] = field(default_factory=list)

    @property
    def vocab(self) -> int:
        return int(self.model.config.vocab_size)

    def kw(self, **over) -> dict:
        kw = dict(page_size=self.page_size, kv_dtype=self.kv_dtype,
                  device=self.device,
                  max_model_len=min(2048, int(
                      self.model.config.max_position_embeddings)))
        kw.update(over)
        return kw

    def engine(self, model=None, **over) -> ServingEngine:
        e = ServingEngine(self.model if model is None else model,
                          **self.kw(**over))
        self.made.append(e)
        return e

    def reference(self, model=None, **over) -> ServingEngine:
        """A lone engine stepped eagerly: the uninterrupted oracle."""
        return self.engine(model, cuda_graph=False, **over)

    def router(self, model_id="m", replicas=2, model=None, router_kw=None,
               **over) -> Router:
        r = Router(**(router_kw or {}))
        r.add_model(model_id, self.model if model is None else model,
                    replicas=replicas, **self.kw(**over))
        return r

    def adopt(self, router: Router) -> Router:
        """Count the router's engines (and any it spawns later) in
        ``made`` (idempotent)."""
        for e in router.engines():
            if all(e is not m for m in self.made):
                self.made.append(e)
        return router

    def prompt(self, n: int, seed: int) -> np.ndarray:
        """``n`` of the JAX drills' tokens, scaled; past a page edge when
        scaled, so a prompt's last page is its own (unshared) one, as the
        JAX drills' are at pages of 4."""
        rng = np.random.RandomState(seed)
        size = n * self.scale + (3 if self.scale > 1 else 0)
        return rng.randint(0, self.vocab, (size,)).astype(np.int32)

    def prompts(self):
        """The JAX drills' P5, P9, P3, P4, scaled."""
        return [self.prompt(n, 700 + n) for n in (5, 9, 3, 4)]


def _trip(engine) -> None:
    """One over-threshold step reported to the watchdog (the JAX drills'
    stand-in for a stalled step on one chosen engine)."""
    engine.watchdog.end_step(engine.watchdog.stall_threshold_s + 1.0)


def _collector(chunks, i):
    return lambda rid, tok, fin, seq: chunks[i].append((seq, tok))


def _check_streams(outs, rids, refs, chunks, reasons=None) -> None:
    for i, (rid, ref) in enumerate(zip(rids, refs)):
        want = "length" if reasons is None else reasons[i]
        _check(outs[rid].finish_reason == want,
               f"request {i} finished {outs[rid].finish_reason}, not {want}")
        _check(list(outs[rid].token_ids) == ref,
               f"request {i} diverged from the uninterrupted run: "
               f"{list(outs[rid].token_ids)} vs {ref}")
        toks = [c for c in chunks[i] if c[1] is not None]
        _check([s for s, _ in toks] == list(range(len(ref))),
               f"request {i} stream chunks duplicated or missing")
        _check([t for _, t in toks] == ref,
               f"request {i} streamed tokens != final token_ids")
        _check(chunks[i][-1] == (len(ref), None),
               f"request {i} missing terminal chunk")


def _refs(fleet, specs, model=None, **kw):
    ref = fleet.reference(model, max_batch_slots=2, **kw)
    ids = [ref.add_request(p, max_new_tokens=n, temperature=t, seed=s, **x)
           for p, n, t, s, x in specs]
    outs = ref.run()
    refs = [list(outs[r].token_ids) for r in ids]
    _check(any(len(set(t)) > 1 for t in refs),
           "reference run is not actually sampling")
    return refs, outs, ids


def _kill(router, what="engine killed") -> None:
    with faults.inject("router.engine_step", raise_=RuntimeError(what),
                       times=1, seed=0):
        router.step()
    _check(router.states()["m/0"] == "down", "crashed engine not gated down")


# ─────────────────────────────── the drills ───────────────────────────────


def drill_router_failover(fleet: Fleet) -> dict:
    """Scenario 7."""
    P5, P9, P3, P4 = fleet.prompts()
    r = fleet.adopt(fleet.router(replicas=2, max_batch_slots=1,
                                 watchdog_recovery_steps=999))
    e0, e1 = r.engine("m/0"), r.engine("m/1")
    victim = e0.add_request(P9, max_new_tokens=8)
    e0.step()
    queued = [e0.add_request(P3, max_new_tokens=3),
              e0.add_request(P4, max_new_tokens=3)]
    moved0 = _counter("paddle_tpu_router_requeued_total")
    un0 = _counter("paddle_tpu_router_unplaceable_total")
    e0.pool.poison_seq(victim)
    _trip(e0)
    outs = r.run()
    _check(outs[victim].finish_reason == "nan", "victim not quarantined")
    _check([outs[q].finish_reason for q in queued] == ["length"] * 2,
           "requeued work did not complete on the sibling")
    _check(len(outs) == 3, "duplicate or dropped outputs")
    _check(_counter("paddle_tpu_router_requeued_total") == moved0 + 2,
           "requeue counter != exactly 2")
    _check(e0.pool.used_pages == 0 and e1.pool.used_pages == 0,
           "pages leaked")
    _check(r.states() == {"m/0": "degraded", "m/1": "healthy"},
           "gate states wrong")
    b1 = e1.add_request(P9, max_new_tokens=12)
    e1.step()
    q2 = e1.add_request(P3, max_new_tokens=2)
    _trip(e1)
    outs2 = r.run()
    _check(outs2[q2].finish_reason == "unavailable",
           "expected finish_reason=unavailable with no healthy engine")
    _check(outs2[b1].finish_reason == "length", "in-flight request lost")
    _check(_counter("paddle_tpu_router_unplaceable_total") == un0 + 1,
           "unplaceable counter != exactly 1")
    return {"requeued": 2, "unavailable": 1}


def drill_least_loaded(fleet: Fleet) -> dict:
    """Scenario 9, its queue waits from the request tracer."""
    P5, P9, P3, P4 = fleet.prompts()

    def drive(policy):
        # engines read the process tracer when they are built
        old = tracing.set_tracer(tracing.RequestTracer(capacity=1 << 14))
        try:
            r = fleet.adopt(fleet.router(replicas=2, max_batch_slots=1))
            # warm: every bucket the measured run steps is captured first,
            # so its waits are scheduling alone. The second pass is the
            # measured prompts' prefix hit (only the tail prefilled), a
            # bucket of its own.
            for eid in ("m/0", "m/1"):
                for _ in range(2):
                    r.engine(eid).add_request(P3, max_new_tokens=2)
                    r.engine(eid).add_request(P4, max_new_tokens=2)
                    r.engine(eid).run()
            e0 = r.engine("m/0")
            for _ in range(2):  # the skew: two 28-token hogs on m/0
                e0.add_request(P3, max_new_tokens=28)
            shorts = []
            for i in range(8):
                if policy == "round-robin":
                    shorts.append(r.engine(f"m/{i % 2}").add_request(
                        P4, max_new_tokens=2))
                else:
                    shorts.append(r.submit(P4, model="m", max_new_tokens=2))
            outs = r.run()
            events = tracing.get_tracer().events()
        finally:
            tracing.set_tracer(old)
        _check(len(outs) == 10 and all(o.finish_reason == "length"
                                       for o in outs.values()),
               f"{policy}: workload did not drain cleanly")
        enq = {e["req_id"]: e["t"] for e in events
               if e["name"] == "req.enqueue"}
        adm = {e["req_id"]: e["t"] for e in events if e["name"] == "req.admit"}
        waits = sorted(adm[k] - enq[k] for k in outs)
        return float(np.quantile(waits, 0.95)), statistics.fmean(waits)

    p95_rr, mean_rr = drive("round-robin")
    p95_ll, mean_ll = drive("least-loaded")
    _check(p95_ll < p95_rr,
           f"least-loaded p95 {p95_ll:.4f}s !< round-robin {p95_rr:.4f}s")
    _check(mean_ll < 0.9 * mean_rr,
           f"least-loaded mean {mean_ll:.4f}s !< 0.9 x round-robin "
           f"{mean_rr:.4f}s")
    return {"p95_wait_s": {"round_robin": p95_rr, "least_loaded": p95_ll},
            "mean_wait_s": {"round_robin": mean_rr, "least_loaded": mean_ll}}


def _kill_counts(before: dict) -> dict:
    return {k: _counter(f"paddle_tpu_router_{k}_total") - v
            for k, v in before.items()}


def _before():
    return {k: _counter(f"paddle_tpu_router_{k}_total")
            for k in ("migrated", "requeued")}


def drill_kill_mid_decode(fleet: Fleet) -> dict:
    """Scenario 10."""
    P5, P9, P3, _P4 = fleet.prompts()
    specs = [(P5, 10, 0.9, 21, {}), (P9, 9, 0.7, 22, {}),
             (P3, 8, 1.1, 23, {})]
    refs, _o, _i = _refs(fleet, specs)
    r = fleet.adopt(fleet.router(replicas=2, max_batch_slots=2))
    e0 = r.engine("m/0")
    chunks = {i: [] for i in range(3)}
    rids = [e0.add_request(p, max_new_tokens=n, temperature=t, seed=s,
                           stream_cb=_collector(chunks, i))
            for i, (p, n, t, s, _x) in enumerate(specs)]
    crash0 = _counter("paddle_tpu_router_engine_crash_total",
                      engine_id="m/0", model_id="m")
    before = _before()
    for _ in range(3):
        r.step()
    _kill(r, "engine killed mid-decode")
    outs = r.run()
    moved = _kill_counts(before)
    _check(_counter("paddle_tpu_router_engine_crash_total", engine_id="m/0",
                    model_id="m") == crash0 + 1, "crash counter != 1")
    _check(moved == {"migrated": 2, "requeued": 1},
           f"moves {moved} != 2 migrated + 1 requeued")
    _check_streams(outs, rids, refs, chunks)
    _check(r._requeued == set(), "move-once marks leaked")
    _check(all(e.pool.used_pages == 0 for e in r.engines("m")),
           "pages leaked")
    return moved


def _warm_prefix(r, prefix):
    for eid in ("m/0", "m/1"):
        e = r.engine(eid)
        e.add_request(np.concatenate([prefix, [1]]), max_new_tokens=1)
        e.run()


def drill_prefix_cache_failover(fleet: Fleet) -> dict:
    """Scenario 11."""
    rng = np.random.RandomState(17)
    prefix = rng.randint(0, fleet.vocab, (24 * fleet.scale,))
    specs = [(np.concatenate([prefix, rng.randint(0, fleet.vocab,
                                                  (k * fleet.scale,))]),
              n, t, s, {})
             for k, (n, t, s) in zip((3, 5, 2), ((10, 0.9, 31),
                                                 (9, 0.7, 32),
                                                 (8, 1.1, 33)))]
    refs, _o, _i = _refs(fleet, specs, prefix_cache=False)
    r = fleet.adopt(fleet.router(replicas=2, max_batch_slots=2))
    _warm_prefix(r, prefix)
    e0, e1 = r.engine("m/0"), r.engine("m/1")
    chunks = {i: [] for i in range(3)}
    rids = [e0.add_request(p, max_new_tokens=n, temperature=t, seed=s,
                           stream_cb=_collector(chunks, i))
            for i, (p, n, t, s, _x) in enumerate(specs)]
    saved0 = _counter("paddle_tpu_serving_prefill_tokens_saved_total",
                      engine_id="m/1", model_id="m")
    before = _before()
    for _ in range(3):
        r.step()
    _kill(r)
    outs = r.run()
    moved = _kill_counts(before)
    saved = _counter("paddle_tpu_serving_prefill_tokens_saved_total",
                     engine_id="m/1", model_id="m") - saved0
    _check(moved["migrated"] == 2, f"moves {moved}")
    _check(saved >= 3 * prefix.size,
           f"adoptive engine saved only {saved} prefill tokens")
    _check_streams(outs, rids, refs, chunks)
    _check(r._requeued == set() and e1.pool.used_pages == 0,
           "marks or pages leaked")
    return dict(moved, prefill_tokens_saved=saved)


def drill_kill_mid_chunked_prefill(fleet: Fleet) -> dict:
    """Scenario 12."""
    P5, *_rest = fleet.prompts()
    rng = np.random.RandomState(23)
    prefix = rng.randint(0, fleet.vocab, (24 * fleet.scale,))
    long_prompt = np.concatenate(
        [prefix, rng.randint(0, fleet.vocab, (20 * fleet.scale,))])
    specs = [(P5, 10, 0.9, 41, {}), (long_prompt, 6, 0.8, 42, {})]
    refs, _o, _i = _refs(fleet, specs, prefix_cache=False)
    r = fleet.adopt(fleet.router(replicas=2, max_batch_slots=2,
                                 token_budget=8 * fleet.scale))
    _warm_prefix(r, prefix)
    e0, e1 = r.engine("m/0"), r.engine("m/1")
    chunks = {i: [] for i in range(2)}
    dec = e0.add_request(P5, max_new_tokens=10, temperature=0.9, seed=41,
                         stream_cb=_collector(chunks, 0))
    r.step()
    r.step()
    lng = e0.add_request(long_prompt, max_new_tokens=6, temperature=0.8,
                         seed=42, stream_cb=_collector(chunks, 1))
    r.step()
    st = next(s for s in e0.slots if s is not None and s.req.req_id == lng)
    _check(st.prefilling and st.pos > prefix.size and not st.gen,
           f"expected the long request mid-prefill (pos={st.pos})")
    boundary = st.pos
    saved0 = _counter("paddle_tpu_serving_prefill_tokens_saved_total",
                      engine_id="m/1", model_id="m")
    before = _before()
    _kill(r, "engine killed between chunks")
    outs = r.run()
    moved = _kill_counts(before)
    saved = _counter("paddle_tpu_serving_prefill_tokens_saved_total",
                     engine_id="m/1", model_id="m") - saved0
    _check(moved["migrated"] == 2, f"moves {moved}")
    _check(saved >= prefix.size, f"sibling saved only {saved} tokens")
    _check_streams(outs, [dec, lng], refs, chunks)
    _check(r._requeued == set() and e1.pool.used_pages == 0,
           "marks or pages leaked")
    return dict(moved, boundary=boundary, prefill_tokens_saved=saved)


def drill_thread_fuzz(fleet: Fleet) -> dict:
    """Scenario 13 without its reload racers."""
    iters = int(fleet.fuzz_iters)
    P5, P9, P3, P4 = fleet.prompts()
    san = faults.LockSanitizer(
        order=("router", "engine", "scheduler", "pool"),
        leaves=("metrics.registry", "metrics.server.probe",
                "watchdog/0", "watchdog/1"))
    registry = metrics.get_registry()
    orig_reg_lock = None
    try:
        r = fleet.adopt(fleet.router(replicas=2, max_batch_slots=1))
        san.attach(r, "_lock", "router")
        orig_reg_lock = san.attach(registry, "_lock", "metrics.registry")
        for i, eng in enumerate(r.engines("m")):
            san.attach(eng.watchdog, "_lock", f"watchdog/{i}")
        barrier = threading.Barrier(3)
        errors, live, prompts = [], [], (P5, P9, P3, P4)
        counts = {"drive": 0, "scrape": 0, "probe": 0}

        def drive(i, rng):
            if i % 5 == 0:
                live.append(r.submit(prompts[int(rng.randint(4))],
                                     model="m", max_new_tokens=2))
            r.step()

        def scrape(i, rng):
            path = ("/metrics", "/metrics.json",
                    "/healthz?engine=m/0")[i % 3]
            try:
                with urllib.request.urlopen(srv.url + path,
                                            timeout=10) as resp:
                    _check(resp.status == 200, f"{path}: {resp.status}")
            except urllib.error.HTTPError as e:
                _check(path.startswith("/healthz") and e.code == 503,
                       f"{path}: HTTP {e.code}")

        def probe(i, rng):
            h = r.health()
            _check(h.get("status") in ("ok", "degraded"),
                   f"health() shape: {h}")
            r.states()

        def worker(key, fn, idx):
            rng = np.random.RandomState(997 + idx)
            try:
                for i in range(iters):
                    barrier.wait(timeout=60)
                    time.sleep(float(rng.uniform(0.0, 5e-4)))
                    fn(i, rng)
                    counts[key] += 1
            except threading.BrokenBarrierError:
                pass
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append((key, e))
                barrier.abort()

        with metrics.MetricsServer(health_cb=r.health, port=0) as srv:
            san.attach(srv, "_probe_lock", "metrics.server.probe")
            threads = [threading.Thread(target=worker, args=args,
                                        name=f"fuzz-{args[0]}")
                       for args in (("drive", drive, 1),
                                    ("scrape", scrape, 2),
                                    ("probe", probe, 3))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            _check(not any(t.is_alive() for t in threads),
                   "fuzz thread wedged")
        _check(not errors, f"fuzz thread failures: {errors}")
        _check(all(c == iters for c in counts.values()),
               f"threads did not complete: {counts}")
        outs = r.run()
        _check(sorted(outs) == sorted(live),
               "requests dropped or duplicated under fuzz")
        _check(all(outs[k].finish_reason == "length" for k in live),
               "a fuzzed request did not complete normally")
        _check(all(e.pool.used_pages == 0 for e in r.engines("m")),
               "pages leaked under fuzz")
        san.assert_clean()
        return {"iterations": iters, "requests": len(live)}
    finally:
        if orig_reg_lock is not None:
            registry._lock = orig_reg_lock


class SpecOracle:
    """Drafts each listed prompt's known continuation (every burst
    accepted) and an always-rejected token for anything else."""

    def __init__(self, table, reject_token: int):
        self.table = [(np.asarray(p).tolist(), [int(t) for t in ref])
                      for p, ref in table]
        self.reject = int(reject_token)

    def propose(self, ids, k=None):
        seq = np.asarray(ids).tolist()
        for p, ref in self.table:
            done = len(seq) - len(p)
            if 0 <= done and seq[:len(p)] == p and seq[len(p):] == ref[:done]:
                return np.asarray(ref[done:done + (k or 1)], np.int32)
        return np.full(k or 1, self.reject, np.int32)


def drill_kill_mid_spec_burst(fleet: Fleet) -> dict:
    """Scenario 14."""
    P5, P9, P3, _P4 = fleet.prompts()
    specs = [(P5, 10, 0.9, 21, {}), (P9, 9, 0.7, 22, {}),
             (P3, 8, 1.1, 23, {})]
    refs, _o, _i = _refs(fleet, specs)
    drafter = SpecOracle([(P5, refs[0]), (P9, refs[1])], fleet.vocab - 1)
    r = fleet.adopt(fleet.router(replicas=2, max_batch_slots=2, spec_k=3,
                                 drafter=drafter))
    e0 = r.engine("m/0")
    chunks = {i: [] for i in range(3)}
    rids = [e0.add_request(p, max_new_tokens=n, temperature=t, seed=s,
                           stream_cb=_collector(chunks, i))
            for i, (p, n, t, s, _x) in enumerate(specs)]
    d0 = _counter("paddle_tpu_serving_spec_drafted_tokens_total")
    a0 = _counter("paddle_tpu_serving_spec_accepted_tokens_total")
    before = _before()
    for _ in range(2):
        r.step()
    _check(_counter("paddle_tpu_serving_spec_accepted_tokens_total") > a0,
           "no accepted burst landed before the kill")
    _kill(r, "engine killed mid-spec-burst")
    for i, ref in enumerate(refs):
        got = [t for _, t in chunks[i] if t is not None]
        _check(got == ref[:len(got)],
               f"request {i} streamed a non-committed token by the kill")
    outs = r.run()
    moved = _kill_counts(before)
    _check(moved == {"migrated": 2, "requeued": 1}, f"moves {moved}")
    _check_streams(outs, rids, refs, chunks)
    drafted = _counter("paddle_tpu_serving_spec_drafted_tokens_total") - d0
    accepted = _counter("paddle_tpu_serving_spec_accepted_tokens_total") - a0
    _check(drafted > accepted, "the garbage drafts were never rejected")
    _check(r._requeued == set() and all(
        e.pool.used_pages == 0 for e in r.engines("m")),
        "marks or pages leaked")
    return dict(moved, drafted=drafted, accepted=accepted)


def drill_autoscale(fleet: Fleet) -> dict:
    """Scenario 15, with the port's compile contract."""
    s = fleet.scale
    bucket = 32 * s
    r = fleet.adopt(fleet.router(
        replicas=1, num_pages=128, max_batch_slots=4, max_model_len=64 * s,
        token_budget=bucket, min_step_tokens=bucket, max_queue=128))
    P5 = fleet.prompts()[0]
    r.submit(P5, max_new_tokens=2)
    r.run()
    warm = set(r.engines("m"))
    nvcc0 = _build.nvcc_runs
    cfg = loadgen.TraceConfig(
        seed=15, num_requests=32, vocab_size=fleet.vocab, arrival_rate=8.0,
        burst_start=0.2, burst_duration=1.5, burst_factor=8.0,
        num_prompt_families=4, prefix_len=6 * s, max_prompt_len=24 * s,
        suffix_len_mean=6.0 * s, max_output_len=6,
        slow_consumer_fraction=0.05)
    trace = loadgen.generate_trace(cfg)
    spawned: List[ServingEngine] = []
    orig_add = r.add_engine

    def add_engine(*a, **k):
        eid = orig_add(*a, **k)
        spawned.append(r.engine(eid))
        fleet.adopt(r)
        return eid

    r.add_engine = add_engine
    scaler = loadgen.QueueDepthAutoscaler(r, config=loadgen.AutoscalerConfig(
        min_engines=1, max_engines=3, scale_up_depth=2.0,
        scale_down_depth=0.25, hot_steps=2, cold_steps=6, cooldown_steps=6))
    rep = loadgen.LoadDriver(r, trace, autoscaler=scaler).run()
    _check(rep.exactly_once, f"accounting violated: {rep.violations[:3]}")
    _check(rep.engines_peak >= 2, "the burst never scaled the fleet")
    _check(rep.engines_final == 1, f"fleet ended at {rep.engines_final}")
    _check(rep.scale_ups >= 1 and rep.scale_ups == rep.scale_downs,
           f"scale events ups={rep.scale_ups} downs={rep.scale_downs}")
    bad = {k: v for k, v in rep.outcomes.items()
           if k not in ("stop", "length", "unavailable")}
    _check(not bad and sum(rep.outcomes.values()) == cfg.num_requests,
           f"outcomes {rep.outcomes}")
    new_caps = sum(e.compile_counts()["step"] for e in spawned)
    _check(_build.nvcc_runs == nvcc0, "a kernel was built after the warm "
           "phase")
    _check(all(e.compile_counts()["step"] == 1 for e in warm)
           and all(e._grid_buckets_seen <= {bucket} for e in spawned),
           "an engine met a bucket beyond its pinned one")
    _check(rep.fresh_compiles == new_caps <= len(spawned),
           f"fresh compiles {rep.fresh_compiles} != the captures of the "
           f"{len(spawned)} new engines ({new_caps}), at most one each")
    _check(all(e.pool.used_pages == 0 for e in r.engines("m"))
           and r._requeued == set(), "pages or marks leaked")
    return {"scale": [rep.engines_start, rep.engines_peak,
                      rep.engines_final],
            "scale_ups": rep.scale_ups, "outcomes": rep.outcomes,
            "new_engine_captures": new_caps,
            "capture_s": [e.capture_seconds() for e in spawned],
            "nvcc_runs_after_warm": _build.nvcc_runs - nvcc0,
            "goodput_tok_s": rep.goodput_tok_s}


def drill_kill_constrained_adapter(fleet: Fleet) -> dict:
    """Scenario 16."""
    P5, P9, P3, _P4 = fleet.prompts()
    tok = toy_tokenizer(fleet.vocab)
    fsms = [GrammarFSM.compile(p, tok)
            for p in ("[ab]{1,4}", "[abc]{2,12}", "[ab]{1,6}")]
    specs = [(P5, 10, 0.9, 31, dict(adapter_id="acme", grammar=fsms[0])),
             (P9, 8, 0.7, 32, dict(adapter_id="acme", grammar=fsms[1])),
             (P3, 6, 1.1, 33, dict(adapter_id="acme", grammar=fsms[2]))]
    ref = fleet.reference(max_batch_slots=2)
    ref.register_adapter("acme", random_adapter(ref.adapters, seed=16))
    ref_ids = [ref.add_request(p, max_new_tokens=n, temperature=t, seed=s,
                               **x) for p, n, t, s, x in specs]
    ref_outs = ref.run()
    refs = [list(ref_outs[i].token_ids) for i in ref_ids]
    _check(all(g.validates(t) for g, t in zip(fsms, refs)),
           "oracle produced a grammar-invalid stream")
    _check(ref_outs[ref_ids[0]].finish_reason == "stop",
           "request 0 never exercised the FSM-driven stop")
    r = fleet.adopt(fleet.router(replicas=2, max_batch_slots=2))
    res = r.register_adapter("acme", random_adapter(
        r.engine("m/0").adapters, seed=16), model="m")
    _check([e["result"] for e in res["engines"]] == ["ok", "ok"],
           f"adapter canary: {res}")
    e0 = r.engine("m/0")
    chunks = {i: [] for i in range(3)}
    rids = [e0.add_request(p, max_new_tokens=n, temperature=t, seed=s,
                           stream_cb=_collector(chunks, i), **x)
            for i, (p, n, t, s, x) in enumerate(specs)]
    valid0 = _counter("paddle_tpu_serving_grammar_completions_total",
                      result="valid")
    before = _before()
    for _ in range(2):
        r.step()
    _kill(r, "engine killed mid-constrained-stream")
    for i, ref_t in enumerate(refs):
        got = [t for _, t in chunks[i] if t is not None]
        _check(got == ref_t[:len(got)], f"request {i} diverged by the kill")
        if i < 2:
            _check(got and len(got) < len(ref_t),
                   f"request {i} not mid-structure at the kill")
    outs = r.run()
    moved = _kill_counts(before)
    _check(moved == {"migrated": 2, "requeued": 1}, f"moves {moved}")
    _check_streams(outs, rids, refs, chunks,
                   [ref_outs[i].finish_reason for i in ref_ids])
    _check(all(f.validates(outs[x].token_ids) for f, x in zip(fsms, rids)),
           "a completion is grammar-invalid after migration")
    _check(_counter("paddle_tpu_serving_grammar_completions_total",
                    result="valid") - valid0 == 3, "valid completions != 3")
    _check(all(len(e._grammar_segments) == 0 for e in r.engines("m")),
           "grammar segments leaked")
    _check(r._requeued == set() and all(
        e.pool.used_pages == 0 for e in r.engines("m")),
        "marks or pages leaked")
    return moved


def drill_flight_recorder(fleet: Fleet) -> dict:
    """Scenario 17."""
    P5, P9, P3, _P4 = fleet.prompts()
    specs = [(P5, 10, 0.9, 21, {}), (P9, 9, 0.7, 22, {}),
             (P3, 8, 1.1, 23, {})]
    refs, _o, _i = _refs(fleet, specs)
    flight_dir = tempfile.mkdtemp(prefix="serve_fleet_flight_")
    old = None
    try:
        old = tracing.set_tracer(tracing.RequestTracer(
            capacity=1 << 15, flight_dir=flight_dir, window_s=120.0))
        tracer = tracing.get_tracer()
        dumps0 = _counter("paddle_tpu_trace_recorder_dumps_total",
                          reason="crash")
        r = fleet.adopt(fleet.router(replicas=2, max_batch_slots=2))
        e0 = r.engine("m/0")
        rids = [e0.add_request(p, max_new_tokens=n, temperature=t, seed=s)
                for p, n, t, s, _x in specs]
        for _ in range(3):
            r.step()
        _kill(r)
        files = sorted(os.listdir(flight_dir))
        _check(len(files) == 1 and "crash" in files[0],
               f"expected one crash dump, found {files}")
        with open(os.path.join(flight_dir, files[0])) as f:
            dump = json.load(f)
        _check(dump["reason"] == "crash", "dump reason")
        _check(_counter("paddle_tpu_trace_recorder_dumps_total",
                        reason="crash") == dumps0 + 1, "dumps counter")
        for i, rid in enumerate(rids):
            tl = dump["requests"].get(str(rid))
            _check(tl, f"request {i} missing from the dump")
            names = [e["name"] for e in tl]
            hop = {"req.adopt", "req.requeue"} & set(names)
            _check("req.enqueue" in names and hop,
                   f"request {i} dump lacks its history or hop: {names}")
            _check(tracing.validate_events(tl) == [],
                   f"request {i} seqs not exactly-once across the hop")
            hopper = next(e for e in tl if e["name"] in hop)
            _check(hopper["label"] == "m/1", "hop landed elsewhere")
        outs = r.run()
        for i, (rid, ref) in enumerate(zip(rids, refs)):
            _check(list(outs[rid].token_ids) == ref,
                   f"request {i} diverged from the uninterrupted run")
        _check(tracing.validate_events(tracer.events()) == [],
               "live journal lost exactly-once")
        _check(tracer.dropped == 0, "ring wrapped mid-drill")
        _check(r._requeued == set() and all(
            e.pool.used_pages == 0 for e in r.engines("m")),
            "marks or pages leaked")
        return {"dump_events": len(dump["events"])}
    finally:
        tracing.set_tracer(old)
        shutil.rmtree(flight_dir, ignore_errors=True)


def drill_kill_offloaded(fleet: Fleet) -> dict:
    """Scenario 18: int8 pages, a page-starved pool, a parked stream."""
    P5, P9, P3, _P4 = fleet.prompts()
    specs = [(P9, 10, 0.9, 51, dict(priority=5)),
             (np.concatenate([P5, P3]), 4, 0.7, 52, dict(priority=0))]
    refs, _o, _i = _refs(fleet, [(p, n, t, s, {})
                                 for p, n, t, s, _x in specs],
                         kv_dtype="int8")
    ps = fleet.page_size
    need = [-(-(p.size + n) // ps) for p, n, *_r in specs]
    r = fleet.adopt(fleet.router(replicas=2, max_batch_slots=3,
                                 num_pages=sum(need), kv_dtype="int8",
                                 host_offload=True))
    e0, e1 = r.engine("m/0"), r.engine("m/1")
    chunks = {i: [] for i in range(2)}
    off0 = _counter("paddle_tpu_serving_kv_offload_pages_total",
                    engine_id="m/0", model_id="m")
    before = _before()
    (p0, n0, t0, s0, x0), (p1, n1, t1, s1, x1) = specs
    lo = e0.add_request(p0, max_new_tokens=n0, temperature=t0, seed=s0,
                        stream_cb=_collector(chunks, 0), **x0)
    r.step()
    r.step()
    hi = e0.add_request(p1, max_new_tokens=n1, temperature=t1, seed=s1,
                        stream_cb=_collector(chunks, 1), **x1)
    r.step()
    _check(e0.pool.offloaded_pages(lo) > 0, "pressure never parked the "
           "low-priority stream")
    _check(_counter("paddle_tpu_serving_kv_offload_pages_total",
                    engine_id="m/0", model_id="m") > off0,
           "offload counter never moved")
    _kill(r, "engine killed while parked")
    _check(e0.pool.offloaded_pages() == 0 and e0.pool.used_pages == 0,
           "dead engine leaked host or device pages")
    outs = r.run()
    moved = _kill_counts(before)
    _check(moved["migrated"] == 2, f"moves {moved}")
    _check_streams(outs, [lo, hi], refs, chunks)
    _check(e1.pool.used_pages == 0 and e1.pool.offloaded_pages() == 0,
           "adoptive engine leaked pages")
    _check(_counter("paddle_tpu_serving_kv_prefetch_late_total",
                    engine_id="m/1", model_id="m") == 0,
           "a late prefetch on the sibling")
    c = e1.compile_counts()
    _check(c["step"] == c["step_buckets"] and r._requeued == set(),
           "recompile or leaked marks")
    return dict(moved, parks_on_sibling=e1.stats["parks"])


def drill_brownout(fleet: Fleet) -> dict:
    """Scenario 19, the storm scaled to the card's step time."""
    s = fleet.scale
    r = fleet.adopt(fleet.router(
        replicas=2, router_kw=dict(retry_budget=RetryBudget(
            capacity=16.0, refill_per_step=1.0)),
        num_pages=128, max_batch_slots=8, max_model_len=64 * s,
        token_budget=32 * s, min_step_tokens=32 * s, max_queue=128))
    P4 = fleet.prompts()[3]
    for h in r.handles("m"):
        h.engine.add_request(P4, max_new_tokens=2)
        h.engine.run()
    tiers = (
        loadgen.TierSpec("interactive", priority=0, weight=0.15,
                         ttft_slo_s=1.5, itl_slo_s=0.5),
        loadgen.TierSpec("standard", priority=1, weight=0.5185,
                         deadline_s=6.0, ttft_slo_s=2.0, itl_slo_s=1.0),
        loadgen.TierSpec("batch", priority=2, weight=0.3315,
                         ttft_slo_s=10.0, itl_slo_s=5.0))
    cfg = loadgen.TraceConfig(
        seed=0, num_requests=64, vocab_size=fleet.vocab, arrival_rate=8.0,
        burst_start=0.3, burst_duration=1.5, burst_factor=16.0,
        num_prompt_families=6, prefix_len=8 * s, max_prompt_len=28 * s,
        suffix_len_mean=6.0 * s, output_len_mean=24.0,
        output_len_sigma=0.5, max_output_len=32,
        slow_consumer_fraction=0.05, tiers=tiers)
    trace = loadgen.generate_trace(cfg)
    schedule = loadgen.FaultSchedule([
        loadgen.FaultEvent(t_s=0.1, kind="latency", delay_s=0.05,
                           steps=150),
        loadgen.FaultEvent(t_s=0.6, kind="kill", engine_index=0,
                           down_s=0.6)])
    ctl = OverloadController(r, config=OverloadConfig(
        hot_backlog_s=0.12, cold_backlog_s=0.08, hot_steps=1, cold_steps=6,
        cooldown_steps=3, batch_chunk_cap=4 * s))
    pre0 = _counter("paddle_tpu_serving_requests_total", event="preempted")
    rep = loadgen.LoadDriver(r, trace, overload=ctl,
                             fault_schedule=schedule, step_dt=0.02).run()
    _check(rep.exactly_once, f"accounting violated: {rep.violations[:3]}")
    peak = max([lv for _, lv in ctl.events], default=0)
    _check(peak >= 3, f"ladder never reached preemption (peak={peak})")
    _check(ctl.level == 0, f"ladder did not walk back down ({ctl.level})")
    _check(rep.outcomes.get("shed", 0) > 0, "the gate never shed")
    preempted = _counter("paddle_tpu_serving_requests_total",
                         event="preempted") - pre0
    _check(preempted > 0, "no batch-tier slot was preempted")
    bad = {k: v for k, v in rep.outcomes.items()
           if k not in ("stop", "length", "shed", "expired", "timeout",
                        "unavailable")}
    _check(not bad and sum(rep.outcomes.values()) == cfg.num_requests,
           f"outcomes {rep.outcomes}")
    inter = rep.tiers["interactive"].ttft_attainment
    _check(inter is not None and inter >= 0.75,
           f"interactive TTFT attainment {inter} in the storm")
    _check(all(e.pool.used_pages == 0 for e in r.engines("m"))
           and r._requeued == set(), "pages or marks leaked")
    for e in r.engines("m"):
        c = e.compile_counts()
        _check(c["step"] == c["step_buckets"], "a brownout action "
               "added a program")
    return {"ladder_peak": peak, "transitions": len(ctl.events),
            "outcomes": dict(sorted(rep.outcomes.items())),
            "preempted": preempted, "interactive_ttft_attainment": inter}


def drill_kill_serving_process(fleet: Fleet) -> dict:
    """Scenario 20 through ``loadgen.restart`` (child processes)."""
    from ..loadgen import restart

    workdir = tempfile.mkdtemp(prefix="serve_fleet_wal_")
    try:
        ref_model = restart.build_model(fleet.device, fleet.restart_size)
        res = restart.run_restart_drill(
            workdir, replicas_before=2, replicas_after=1, num_requests=6,
            kill_after_chunks=24 if fleet.restart_size != "tiny" else 8,
            device=str(fleet.device.type), size=fleet.restart_size,
            timeout_s=600.0, reference_model=ref_model)
        del ref_model
        ref = restart.streams_by_index(res["ref_chunks"])
        full = restart.streams_by_index(res["pre_chunks"]
                                        + res["post_chunks"])
        _check(res["killed_after"] < len(res["ref_chunks"]),
               "SIGKILL landed after the workload drained")
        _check(set(full) == set(ref), "stream set diverged")
        for idx, chunks in sorted(ref.items()):
            _check(full[idx] == chunks,
                   f"stream {idx} not bit-identical across the kill")
            _check([sq for _, _, sq in full[idx]] == list(range(len(chunks))),
                   f"stream {idx} seqs not exactly-once")
        timing = res["timing"]
        resumed = timing.get("outcomes", {}).get("resumed", 0)
        _check(resumed >= 1, f"nothing resumed: {timing.get('outcomes')}")
        # the port's compile contract for a restarted process
        _check(timing["nvcc_runs"] == 0, "the recovering process ran nvcc")
        _check(timing["fresh_compiles"] == timing["captures"] > 0,
               "captures beyond the recovering engine's own buckets")
        _check(res["rto_s"] is not None, "no recovered token observed")
        ref_timing = json.load(open(os.path.join(workdir, "ref",
                                                 "timing.json")))
        return {"streams": len(ref), "killed_after": res["killed_after"],
                "resumed": resumed, "rto_s": res["rto_s"],
                "recover_s": timing["recover_s"],
                "recover_captures": timing["captures"],
                "recover_capture_s": timing["capture_s"],
                "recover_nvcc_runs": timing["nvcc_runs"],
                "wal_fsyncs_per_step": (ref_timing["fsyncs"]
                                        / max(ref_timing["steps"], 1)),
                "wal_fsync_ms_per_step": (1e3 * ref_timing["fsync_s"]
                                          / max(ref_timing["steps"], 1)),
                "child_counts": {k: v for k, v in res["counts"].items()
                                 if v is not None}}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def drill_multi_model(fleet: Fleet) -> dict:
    """``CompletionAPI`` routing by ``model`` between a three-engine Llama
    fleet and a GPT engine; each choice equals a lone engine of its
    model."""
    _check(fleet.gpt is not None, "the multi-model drill needs Fleet.gpt")
    P5, P9, P3, P4 = fleet.prompts()
    r = Router()
    r.add_model("llama", fleet.model, replicas=3, **fleet.kw(
        max_batch_slots=2))
    gkw = fleet.kw(max_batch_slots=2)
    gkw["max_model_len"] = min(2048, fleet.gpt.config.max_position_embeddings)
    r.add_model("gpt", fleet.gpt, replicas=1, **gkw)
    fleet.adopt(r)
    api = CompletionAPI(r)
    chunks: List[dict] = []
    got = {}
    for model, prompts in (("llama", [P5, P9]), ("gpt", [P3, P4])):
        resp = api.create_completion(prompts, max_tokens=8, temperature=0.8,
                                     seed=4, model=model,
                                     stream_cb=chunks.append)
        _check(resp["model"] == model, f"response model {resp['model']}")
        got[model] = [c["token_ids"] for c in resp["choices"]]
    for model, m, prompts in (("llama", fleet.model, [P5, P9]),
                              ("gpt", fleet.gpt, [P3, P4])):
        ref = fleet.reference(m, max_batch_slots=2,
                              max_model_len=gkw["max_model_len"])
        ids = [ref.add_request(p, max_new_tokens=8, temperature=0.8,
                               seed=4 + i) for i, p in enumerate(prompts)]
        outs = ref.run()
        _check(got[model] == [list(outs[i].token_ids) for i in ids],
               f"{model} choices differ from a lone {model} engine")
    _check(len(chunks) == 4 * 9, f"{len(chunks)} stream chunks")
    try:
        api.create_completion(P3, model="nope")
        _check(False, "an unknown model was served")
    except ValueError as e:
        _check("nope" in str(e), "unknown-model error names it")
    return {"models": sorted(r.models), "engines": sorted(r.states())}


DRILLS: Dict[str, Callable[[Fleet], dict]] = {
    "router-failover-requeue-once": drill_router_failover,
    "router-least-loaded-dispatch": drill_least_loaded,
    "kill-engine-mid-decode": drill_kill_mid_decode,
    "prefix-cache-failover-migration": drill_prefix_cache_failover,
    "kill-engine-mid-chunked-prefill": drill_kill_mid_chunked_prefill,
    "thread-fuzz-control-plane": drill_thread_fuzz,
    "kill-engine-mid-spec-burst": drill_kill_mid_spec_burst,
    "autoscale-under-burst": drill_autoscale,
    "kill-engine-mid-constrained-adapter-stream":
        drill_kill_constrained_adapter,
    "flight-recorder-on-crash": drill_flight_recorder,
    "kill-engine-with-offloaded-pages": drill_kill_offloaded,
    "brownout-under-burst": drill_brownout,
    "kill-serving-process-mid-decode": drill_kill_serving_process,
    "multi-model-completion-api": drill_multi_model,
}


def run_drills(fleet: Fleet, names=None,
               log: Callable[[str], None] = print) -> Dict[str, dict]:
    """Run ``names`` (default: every drill) on ``fleet`` in order; log and
    return one record a drill: its result, seconds, router migrations,
    the captures of the engines it built and ``nvcc`` runs. Raises on the
    first failure."""
    records = {}
    for name in (names or list(DRILLS)):
        faults.reset()
        n0 = len(fleet.made)
        nvcc0 = _build.nvcc_runs
        mig0 = _counter("paddle_tpu_router_migrated_total")
        t0 = time.perf_counter()
        try:
            rec = DRILLS[name](fleet)
        finally:
            faults.reset()
        if fleet.device.type == "cuda":
            torch.cuda.synchronize()
        new = fleet.made[n0:]
        rec = dict(rec, seconds=time.perf_counter() - t0,
                   migrations=_counter("paddle_tpu_router_migrated_total")
                   - mig0,
                   engines=len(new),
                   captures=sum(e.compile_counts()["step"] for e in new
                                if e._graphed),
                   capture_s=sum(sum(e.capture_seconds().values())
                                 for e in new),
                   nvcc_runs=_build.nvcc_runs - nvcc0)
        del fleet.made[n0:], new
        gc.collect()  # the drill's engines and their graphs go now
        records[name] = rec
        log(f"fleet {name}: " + json.dumps(rec, default=str))
    return records


def llama_076b_config() -> LlamaConfig:
    return LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=12,
                       num_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--drills", default=None,
                    help="comma-separated drill names (default: all but "
                    "the multi-model one, which needs a GPT)")
    ap.add_argument("--with-gpt", action="store_true",
                    help="build GPT-3 1.3B for the multi-model drill")
    args = ap.parse_args(argv)
    dev = default_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaForCausalLM(llama_076b_config(), device=dev,
                             dtype=torch.bfloat16, seed=0)
    gpt = None
    names = args.drills.split(",") if args.drills else [
        n for n in DRILLS if n != "multi-model-completion-api"]
    if args.with_gpt:
        from ..models import GPTForCausalLM, gpt3_1_3b
        gpt = GPTForCausalLM(gpt3_1_3b(hidden_dropout_prob=0.0,
                                       attention_dropout_prob=0.0),
                             device=dev, dtype=torch.bfloat16, seed=0)
        names = args.drills.split(",") if args.drills else list(DRILLS)
    fleet = Fleet(model, dev, gpt=gpt)
    run_drills(fleet, names)
    print(json.dumps({"device": bench.card_label(dev),
                      "peak_memory_gib":
                          torch.cuda.max_memory_allocated() / 2**30}))


if __name__ == "__main__":
    main()
