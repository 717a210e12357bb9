"""The serving engine's chaos drills, at full width, through the captured step.

    python -m paddle_tpu_torch.tools.serve_chaos

Counterpart of the JAX package's ``tools/chaos_serve.py`` scenarios 1-6,
on the port's engine (the router's scenarios wait for the router). Each
drill asserts what its JAX counterpart asserts, and more that only a
card can show: a fault writes the pool in place, so the page tensors
keep their addresses and the graphs captured before a poison are the
ones replayed after it.

1. :func:`drill_nan_quarantine`: eight requests served fault-free, then
   again with one sequence's KV poisoned (``poison_seq`` at
   ``serving.decode_step``, after two decode steps). The victim retires
   ``"nan"``; its seven mates' streams equal the fault-free ones; every
   page scrubbed reads zero the moment it is zeroed, the victim's pages
   among them; the prefix nodes the victim's prompt created miss
   afterwards while a mate's prompt hits; no page stays used. On bf16
   or int8 pages (poisoned scale rows), and with one mate on a LoRA
   adapter and one under a grammar.
2. :func:`drill_prefill_nan`: every parameter of a model filled with NaN
   in place: its request retires ``"nan"`` with no token streamed and no
   page held.
3. :func:`drill_kv_alloc`: one ``serving.kv_alloc`` exhaustion
   mid-decode: the victim retires ``"error"``, its mate and a queued
   request drain, no page leaks.
4. :func:`drill_compile_retry`: one transient ``serving.compile_step``
   raise: one retry counted, each bucket captured once.
5. :func:`drill_deadlines_cancel`: a queued request past its deadline
   retires ``"expired"``, a decoding one ``"timeout"``; cancel queued,
   decoding, and from a four-argument stream callback (``seq`` 0, 1, 2,
   then the count).
6. :func:`drill_backpressure_watchdog`: a delayed step trips the
   watchdog (``health()`` degraded) and two healthy steps recover it;
   ``max_queue=1`` refuses with ``retry_after_s > 0``.

A failed check raises :class:`DrillFailed`. Prints one JSON line a
drill and a summary of the registry's counts over the run.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import bench, faults, metrics
from ..models import LlamaConfig, LlamaForCausalLM
from ..serving import (BackpressureError, GrammarFSM, ServingEngine,
                       random_adapter, toy_tokenizer)
from .serve_tenancy import EOS, SCHEMA

__all__ = ["DrillFailed", "chaos_engine", "drill_nan_quarantine",
           "drill_prefill_nan", "drill_kv_alloc", "drill_compile_retry",
           "drill_deadlines_cancel", "drill_backpressure_watchdog",
           "registry_counts", "run_drills"]

NEW_TOKENS = 32
VICTIM = 3           # the poisoned request of the NaN drill
POISON_AFTER = 2     # decode steps before the poison
REASONS = ("timeout", "expired", "cancelled", "nan", "error")
_REASON_FAMILIES = {
    "timeout": "paddle_tpu_serving_request_timeouts_total",
    "expired": "paddle_tpu_serving_expired_total",
    "cancelled": "paddle_tpu_serving_cancellations_total",
    "nan": "paddle_tpu_serving_nan_quarantines_total",
    "error": "paddle_tpu_serving_request_errors_total"}


class DrillFailed(AssertionError):
    """A chaos drill's check failed."""


def _check(cond, what: str) -> None:
    if not cond:
        raise DrillFailed(what)


def _count(name: str, engine=None, **labels) -> float:
    fam = metrics.get_registry().get(name)
    if fam is None:
        return 0.0
    if engine is not None:
        labels.update(engine_id=engine.engine_id, model_id=engine.model_id)
    if not labels:
        return fam.value
    if set(labels) != set(fam.label_names):
        return fam.sum_labels(**labels)
    return fam.labels(**labels).value


def chaos_engine(model, made: Optional[list] = None, **kw) -> ServingEngine:
    """The drills' engine: 8 slots, bf16 pages of 16, budget 1024, the
    prefix cache on, graphed on a card; ``kw`` adds to or overrides
    these. ``made`` collects the engines built."""
    args = dict(page_size=16, max_batch_slots=8, max_model_len=2048,
                token_budget=1024, kv_dtype=torch.bfloat16,
                prefix_cache=True)
    args.update(kw)
    engine = ServingEngine(model, **args)
    if made is not None:
        made.append(engine)
    return engine


def _page_ptrs(pool) -> List[int]:
    return [t.data_ptr() for _n, ts in pool._page_tensors() for t in ts]


def _submit(engine, reqs, prefix_cache: bool) -> list:
    return [engine.add_request(
        r["prompt"], max_new_tokens=r["max_new"],
        temperature=r["temperature"], eos_token_id=EOS, seed=r["seed"],
        prefix_cache=prefix_cache, adapter_id=r["adapter_id"],
        grammar=r["grammar"]) for r in reqs]


def drill_nan_quarantine(model, *, kv_dtype=None, tenancy: bool = False,
                         engine_kw: Optional[dict] = None,
                         made: Optional[list] = None,
                         new_tokens: int = NEW_TOKENS) -> dict:
    """Drill 1 on one engine: the traffic fault-free (each request out of
    the prefix cache, so it caches nothing and the second pass runs the
    same steps on the same graphs), then with the victim poisoned.
    ``kv_dtype`` (e.g. ``"int8"``) overrides the engine's page dtype."""
    kw = dict(engine_kw or {})
    if kv_dtype is not None:
        kw["kv_dtype"] = kv_dtype
    engine = chaos_engine(model, made, **kw)
    pool = engine.pool
    vocab = model.config.vocab_size
    rng = np.random.default_rng(17)
    # eight prompts of 64-128 tokens: all prefill in the first step
    reqs = [dict(prompt=rng.integers(0, vocab, int(n)), max_new=new_tokens,
                 temperature=0.8 if i in (2, 5) else 0.0, seed=500 + i,
                 adapter_id=None, grammar=None)
            for i, n in enumerate(rng.integers(64, 129, 8))]
    if tenancy:
        engine.register_adapter("a1",
                                random_adapter(engine.adapters, seed=11))
        reqs[1]["adapter_id"] = "a1"
        reqs[6]["grammar"] = GrammarFSM.compile(
            SCHEMA, toy_tokenizer(vocab, eos_token_id=EOS))
    ref_ids = _submit(engine, reqs, prefix_cache=False)
    ref = engine.run()
    ref_streams = [ref[r].token_ids for r in ref_ids]
    counts0 = engine.compile_counts()
    graphs = {T: p.graph for T, p in engine._programs.items()}
    ptrs = _page_ptrs(pool)
    nan0 = _count("paddle_tpu_serving_nan_quarantines_total", engine)

    scrubs: List[tuple] = []
    scrub = pool._scrub

    def checked_scrub(pages):
        # every page the quarantine zeroes reads zero on the device the
        # moment it is zeroed (NaN counts as nonzero)
        scrub(pages)
        idx = torch.tensor(pages, dtype=torch.int64, device=pool.device)
        nonzero = sum(int(torch.count_nonzero(t.index_select(0, idx)))
                      for _n, ts in pool._page_tensors() for t in ts)
        scrubs.append((list(pages), nonzero))

    pool._scrub = checked_scrub
    rids = _submit(engine, reqs, prefix_cache=True)
    victim = rids[VICTIM]
    poisoned = {}

    def poison():
        poisoned["pages"] = pool.block_table(victim)
        poisoned["slots"] = pool.poison_seq(victim)

    try:
        with faults.inject("serving.decode_step", call=poison, times=1,
                           after=POISON_AFTER) as spec:
            outs = engine.run()
        # take every free page: the victim's dirty ones are scrubbed
        probe = ("chaos-probe",)
        pool.allocate(probe, len(pool._free) * pool.page_size)
        pool.free(probe)
    finally:
        pool._scrub = scrub
    streams = [outs[r].token_ids for r in rids]
    mates = [i for i in range(len(reqs)) if i != VICTIM]
    _check(spec.fired == 1 and poisoned.get("slots", 0) > 0,
           f"poison fired {spec.fired} times on {poisoned}")
    v = outs[victim]
    _check(v.finish_reason == "nan" and v.n_gen <= POISON_AFTER + 1,
           f"victim {v.finish_reason} after {v.n_gen} tokens")
    _check(all(torch.equal(torch.tensor(streams[i]),
                           torch.tensor(ref_streams[i])) for i in mates),
           "a mate's stream differs from the fault-free run's")
    _check(_count("paddle_tpu_serving_nan_quarantines_total", engine)
           - nan0 == 1, "quarantine counter")
    scrubbed = {p for pages, _n in scrubs for p in pages}
    _check(scrubs and all(n == 0 for _p, n in scrubs),
           f"a scrubbed page reads nonzero: {scrubs}")
    _check(set(poisoned["pages"]) <= scrubbed,
           f"victim pages {poisoned['pages']} not all scrubbed "
           f"({sorted(scrubbed)})")
    _check(_page_ptrs(pool) == ptrs, "a page tensor was rebound")
    _check(engine.compile_counts() == counts0
           and all(engine._programs[T].graph is g for T, g in graphs.items()),
           "a step program was rebuilt or recaptured across the poison")
    _check(pool.used_pages == 0, f"{pool.used_pages} pages still used")
    # the victim's prompt misses (its nodes were evicted), a mate's hits
    hits0 = _count("paddle_tpu_serving_prefix_hits_total", engine)
    miss0 = _count("paddle_tpu_serving_prefix_misses_total", engine)
    engine.add_request(reqs[VICTIM]["prompt"], max_new_tokens=2)
    engine.run()
    missed = _count("paddle_tpu_serving_prefix_misses_total", engine) - miss0
    engine.add_request(reqs[0]["prompt"], max_new_tokens=2)
    engine.run()
    hit = _count("paddle_tpu_serving_prefix_hits_total", engine) - hits0
    _check(missed == 1 and hit == 1,
           f"after the quarantine: victim prompt misses {missed}, mate "
           f"prompt hits {hit}")
    engine.prefix_cache.clear()
    _check(pool.used_pages == 0 and len(pool._free) == pool.usable_pages,
           "pages missing after the cache was cleared")
    return {"kv_dtype": str(pool.dtype).replace("torch.", ""),
            "tenancy": tenancy, "victim_tokens": v.n_gen,
            "slots_poisoned": poisoned["slots"],
            "pages_scrubbed": len(scrubbed), "scrubs": len(scrubs),
            "mates_equal": len(mates), "compile_counts": counts0,
            "graphs_kept": len(graphs)}


def drill_prefill_nan(model, engine_kw: Optional[dict] = None,
                      made: Optional[list] = None) -> dict:
    """Drill 2: ``model``'s every parameter filled with NaN in place
    (``fill_`` under ``no_grad``; the parameters keep their storage)."""
    params = list(model.parameters())
    ptrs = [p.data_ptr() for p in params]
    with torch.no_grad():
        for p in params:
            p.fill_(float("nan"))
    _check([p.data_ptr() for p in params] == ptrs, "a parameter was rebound")
    engine = chaos_engine(model, made, max_batch_slots=1,
                          **(engine_kw or {}))
    calls = []
    rid = engine.add_request(
        np.arange(1, 101), max_new_tokens=4,
        stream_cb=lambda r, tok, done, seq: calls.append((tok, done, seq)))
    out = engine.run()[rid]
    _check(out.finish_reason == "nan" and out.n_gen == 0,
           f"{out.finish_reason} after {out.n_gen} tokens")
    _check(calls == [(None, "nan", 0)], f"stream callback calls {calls}")
    _check(engine.pool.used_pages == 0, "pages held")
    return {"finish_reason": out.finish_reason, "n_gen": out.n_gen,
            "stream_calls": len(calls)}


def drill_kv_alloc(model, engine_kw: Optional[dict] = None,
                   made: Optional[list] = None) -> dict:
    """Drill 3: the victim's 64-token prompt fills four pages exactly, so
    its first decode takes a page, where the armed fault lands; the
    mate's (50 tokens) does not."""
    engine = chaos_engine(model, made, max_batch_slots=2,
                          **(engine_kw or {}))
    vocab = model.config.vocab_size
    rng = np.random.default_rng(23)
    new = 8
    victim = engine.add_request(rng.integers(0, vocab, 64),
                                max_new_tokens=new)
    mate = engine.add_request(rng.integers(0, vocab, 50), max_new_tokens=new)
    queued = engine.add_request(rng.integers(0, vocab, 40),
                                max_new_tokens=new)
    engine.step()
    err0 = _count("paddle_tpu_serving_request_errors_total", engine)
    with faults.inject("serving.kv_alloc", raise_=faults.ResourceExhausted,
                       times=1) as spec:
        outs = engine.run()
    _check(spec.fired == 1, "the fault did not fire")
    v = outs[victim]
    _check(v.finish_reason == "error" and "ResourceExhausted" in v.error,
           f"victim {v.finish_reason} {v.error}")
    _check(outs[mate].n_gen == new and outs[queued].n_gen == new,
           "a batch-mate or the queued request did not drain")
    _check(engine.pool.used_pages == 0, "pages leaked")
    _check(_count("paddle_tpu_serving_request_errors_total", engine) - err0
           == 1, "error counter")
    return {"victim": v.finish_reason, "victim_tokens": v.n_gen,
            "mate": outs[mate].finish_reason,
            "queued": outs[queued].finish_reason}


def drill_compile_retry(model, engine_kw: Optional[dict] = None,
                        made: Optional[list] = None) -> dict:
    """Drill 4: the first bucket's construction raises once; the retry
    builds it, and every bucket is captured once."""
    engine = chaos_engine(model, made, max_batch_slots=1,
                          **(engine_kw or {}))
    retries0 = _count("paddle_tpu_faults_retries_total")
    rid = engine.add_request(np.arange(1, 101), max_new_tokens=8)
    with faults.inject("serving.compile_step",
                       raise_=RuntimeError("transient build failure"),
                       times=1) as spec:
        out = engine.run()[rid]
    counts = engine.compile_counts()
    retries = _count("paddle_tpu_faults_retries_total") - retries0
    _check(spec.fired == 1 and retries == 1,
           f"fired {spec.fired}, retries {retries}")
    _check(out.n_gen == 8, f"{out.finish_reason} after {out.n_gen} tokens")
    _check(counts["step"] == counts["step_buckets"], f"{counts}")
    if engine._graphed:
        _check(len(engine.capture_seconds()) == counts["step"],
               f"{len(engine.capture_seconds())} captures for {counts}")
    return {"retries": retries, "compile_counts": counts}


def drill_deadlines_cancel(model, engine_kw: Optional[dict] = None,
                           made: Optional[list] = None) -> dict:
    """Drill 5 on a one-slot engine."""
    engine = chaos_engine(model, made, max_batch_slots=1,
                          **(engine_kw or {}))
    before = {r: _count(_REASON_FAMILIES[r], engine) for r in REASONS}
    live = engine.add_request(np.arange(1, 65), max_new_tokens=16)
    dead = engine.add_request(np.arange(1, 41), max_new_tokens=16,
                              deadline_s=0.0)
    engine.step()
    engine.slots[0].req.deadline = faults.Deadline(-1.0)
    outs = engine.run()
    _check(outs[dead].finish_reason == "expired" and outs[dead].n_gen == 0,
           f"queued past its deadline: {outs[dead].finish_reason}")
    _check(outs[live].finish_reason == "timeout"
           and 1 <= outs[live].n_gen < 16,
           f"decoding past its deadline: {outs[live].finish_reason} "
           f"after {outs[live].n_gen}")
    running = engine.add_request(np.arange(1, 65), max_new_tokens=16)
    waiting = engine.add_request(np.arange(1, 41), max_new_tokens=16)
    engine.step()
    _check(engine.cancel(waiting) and engine.scheduler.queue_depth == 0,
           "cancel while queued")
    engine.step()
    _check(engine.cancel(running) and engine.pool.used_pages == 0
           and engine.slots[0] is None, "cancel while decoding")
    _check(not engine.cancel(running), "a second cancel succeeded")
    calls = []

    def cb(rid, tok, done, seq):
        calls.append((tok, done, seq))
        if seq == 2 and not done:
            engine.cancel(rid)

    reentrant = engine.add_request(np.arange(1, 65), max_new_tokens=16,
                                   stream_cb=cb)
    outs.update(engine.run())
    r = outs[reentrant]
    _check(r.finish_reason == "cancelled" and r.n_gen == 3
           and [c[2] for c in calls] == [0, 1, 2, 3]
           and calls[-1][:2] == (None, "cancelled"),
           f"reentrant cancel: {r.finish_reason} {r.n_gen} {calls}")
    _check(outs[waiting].n_gen == 0 and outs[running].n_gen >= 1,
           "cancelled outputs")
    delta = {k: _count(_REASON_FAMILIES[k], engine) - before[k]
             for k in REASONS}
    _check(delta == {"timeout": 1, "expired": 1, "cancelled": 3, "nan": 0,
                     "error": 0}, f"reason counters {delta}")
    _check(engine.pool.used_pages == 0, "pages leaked")
    return {"reasons": delta, "timeout_tokens": outs[live].n_gen,
            "reentrant_seqs": [c[2] for c in calls]}


def drill_backpressure_watchdog(model, stall_s: float = 0.25,
                                engine_kw: Optional[dict] = None,
                                made: Optional[list] = None) -> dict:
    """Drill 6: the watchdog on empty steps (so no capture's time counts),
    then a full one-deep queue."""
    engine = chaos_engine(model, made, max_batch_slots=1, max_queue=1,
                          watchdog_stall_s=stall_s, watchdog_recovery_steps=2,
                          **(engine_kw or {}))
    trips0 = _count("paddle_tpu_serving_watchdog_trips_total", engine)
    with faults.inject("serving.step", delay_s=2 * stall_s, times=1):
        engine.step()
    tripped = engine.health()["status"]
    engine.step()
    engine.step()
    recovered = engine.health()["status"]
    trips = _count("paddle_tpu_serving_watchdog_trips_total", engine) - trips0
    _check((tripped, recovered, trips) == ("degraded", "ok", 1),
           f"watchdog {tripped} -> {recovered}, {trips} trips")
    ok = engine.add_request(np.arange(1, 41), max_new_tokens=4)
    try:
        engine.add_request(np.arange(1, 41), max_new_tokens=4)
        raise DrillFailed("a full queue accepted a request")
    except BackpressureError as e:
        hint, depth = e.retry_after_s, e.queue_depth
    _check(hint > 0 and depth == 1, f"retry_after_s {hint}, depth {depth}")
    out = engine.run()[ok]
    _check(out.n_gen == 4, "the queued request did not finish")
    return {"watchdog": [tripped, recovered], "trips": trips,
            "retry_after_s": hint}


def registry_counts(engines) -> dict:
    """The registry's serving counts summed over ``engines``: TTFT and
    ITL observations, the compiles of ``serving_step`` beside the
    engines' buckets, and the reason counters."""
    def hist(name):
        fam = metrics.get_registry().get(name)
        return sum(fam.labels(engine_id=e.engine_id,
                              model_id=e.model_id).count for e in engines)

    return {
        "ttft_count": hist("paddle_tpu_serving_ttft_seconds"),
        "itl_count": hist("paddle_tpu_serving_inter_token_seconds"),
        "buckets": sum(e.compile_counts()["step_buckets"] for e in engines),
        "reasons": {r: sum(_count(_REASON_FAMILIES[r], e) for e in engines)
                    for r in REASONS}}


def run_drills(model, nan_model, log: Callable[[str], None] = print,
               engine_kw: Optional[dict] = None,
               made: Optional[list] = None) -> Dict[str, dict]:
    """Every drill on ``model`` (``nan_model`` is filled with NaN by
    drill 2); logs one JSON line a drill and returns the records, with
    ``"metrics"``: :func:`registry_counts` of the drills' engines and the
    ``serving_step`` compiles they added. ``made`` collects the engines
    built."""
    kw = dict(engine_kw=engine_kw, made=[] if made is None else made)
    jit = metrics.get_registry().get("paddle_tpu_jit_compiles_total")
    jit0 = jit.sum_labels(fn="serving_step") if jit is not None else 0.0
    records = {}
    for name, fn in (
            ("nan_quarantine", lambda: drill_nan_quarantine(model, **kw)),
            ("nan_quarantine_int8",
             lambda: drill_nan_quarantine(model, kv_dtype="int8", **kw)),
            ("nan_quarantine_tenancy",
             lambda: drill_nan_quarantine(model, tenancy=True, **kw)),
            ("prefill_nan", lambda: drill_prefill_nan(nan_model, **kw)),
            ("kv_alloc", lambda: drill_kv_alloc(model, **kw)),
            ("compile_retry", lambda: drill_compile_retry(model, **kw)),
            ("deadlines_cancel", lambda: drill_deadlines_cancel(model, **kw)),
            ("backpressure_watchdog",
             lambda: drill_backpressure_watchdog(model, **kw))):
        t0 = time.perf_counter()
        rec = fn()
        rec["seconds"] = time.perf_counter() - t0
        records[name] = rec
        log(f"chaos {name}: " + json.dumps(rec))
    made = kw["made"]
    jit = metrics.get_registry().get("paddle_tpu_jit_compiles_total")
    counts = registry_counts(made)
    counts["compiles_serving_step"] = jit.sum_labels(fn="serving_step") - jit0
    _check(counts["compiles_serving_step"] == counts["buckets"]
           == sum(e.compile_counts()["step"] for e in made),
           f"compiles {counts}")
    records["metrics"] = counts
    log("chaos metrics: " + json.dumps(counts))
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=12,
                      num_heads=16, num_key_value_heads=16,
                      max_position_embeddings=2048)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    cfg2 = LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=2,
                       num_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048)
    nan_model = LlamaForCausalLM(cfg2, device="cuda", dtype=torch.bfloat16,
                                 seed=1)
    run_drills(model, nan_model)
    print(json.dumps({"device": bench.card_label(torch.device("cuda"))}))


if __name__ == "__main__":
    main()
