"""Crash containment and in-flight migration: the port's router against
the JAX package's.

The kill drills of the JAX chaos tool (scenarios 10, 12, 14 and 18) run
through both routers on the same weights and traffic
(``torch_router_common.py``): all traffic lands on ``m/0`` of a
two-engine fleet and ``m/0`` dies at a scheduled step through the
``router.engine_step`` fault point, mid-decode, between the prompt
chunks of a long request (which resumes through ``m/1``'s cached
prefix), mid speculative burst (only committed tokens reach a stream or
a journal), and with a parked int8 stream on the host page tier. The
records must be equal between the packages (streams, chunks, counters,
states, pages, marks), and every stream must equal the lone-engine
reference with its chunks exactly-once.
"""
import numpy as np
import pytest
from torch_router_common import (P3, P5, P9, _both, _chunk_cb, _streams,
                                 make_sides, no_leaked_faults)
from torch_router_common import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def sides():
    return make_sides()


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield from no_leaked_faults()


# ───────────────────────── crash containment, migration ─────────────────────


def _kill_drill(s, specs, build, before_kill, engine_kw, drafter=None):
    """The kill drill of scenarios 10-18: a lone-engine reference, then
    all traffic on m/0 of a two-engine fleet, m/0 killed at a scheduled
    step through ``router.engine_step``. Returns everything the two
    packages must agree on."""
    ref = s.engine(**{k: v for k, v in engine_kw.items()
                      if k not in ("host_offload", "num_pages",
                                   "max_batch_slots")},
                   max_batch_slots=2)
    ref_ids = [ref.add_request(p, max_new_tokens=n, temperature=t, seed=sd,
                               **extra)
               for p, n, t, sd, extra in specs]
    ref_outs = ref.run()
    refs = [list(ref_outs[x].token_ids) for x in ref_ids]
    r = s.router()
    kw = dict(engine_kw)
    if drafter is not None:
        kw["drafter"] = drafter(specs, refs)
    s.add(r, "m", replicas=2, **kw)
    build(r)
    e0, e1 = r.engine("m/0"), r.engine("m/1")
    chunks = {i: [] for i in range(len(specs))}
    c0 = {n: s.counter(n) for n in (
        "paddle_tpu_router_migrated_total",
        "paddle_tpu_router_requeued_total")}
    saved0 = s.counter("paddle_tpu_serving_prefill_tokens_saved_total",
                       engine_id="m/1", model_id="m")
    rids = before_kill(r, e0, specs, chunks)
    with s.faults.inject("router.engine_step",
                         raise_=RuntimeError("engine killed"), times=1,
                         seed=0):
        r.step()
    at_kill = {i: [c for c in ch] for i, ch in chunks.items()}
    outs = r.run()
    return {
        "refs": refs, "streams": _streams(outs, rids), "chunks": chunks,
        "at_kill": {i: len(c) for i, c in at_kill.items()},
        "states": r.states(),
        "counters": {n: s.counter(n) - v for n, v in c0.items()},
        "saved_on_m1": s.counter(
            "paddle_tpu_serving_prefill_tokens_saved_total",
            engine_id="m/1", model_id="m") - saved0,
        "pages": (e0.pool.used_pages, e1.pool.used_pages),
        "marks": sorted(r._requeued),
        "step_compiles_ok": all(
            e.compile_counts()["step"] == e.compile_counts()["step_buckets"]
            for e in (e0, e1))}


def _submit_on(e0, specs, chunks):
    return [e0.add_request(p, max_new_tokens=n, temperature=t, seed=sd,
                           stream_cb=_chunk_cb(chunks, i), **extra)
            for i, (p, n, t, sd, extra) in enumerate(specs)]


def _exactly_once(rec):
    for i, ref in enumerate(rec["refs"]):
        reason, toks = rec["streams"][i]
        assert toks == ref, i
        got = [c for c in rec["chunks"][i] if c[1] is not None]
        assert [c[0] for c in got] == list(range(len(ref)))
        assert rec["chunks"][i][-1] == (len(ref), None, reason)


KILL_SPECS = [(P5, 10, 0.9, 21, {}), (P9, 9, 0.7, 22, {}),
              (P3, 8, 1.1, 23, {})]


def _drill_kill_mid_decode(s):
    def before(r, e0, specs, chunks):
        rids = _submit_on(e0, specs, chunks)
        for _ in range(3):
            r.step()
        return rids
    return _kill_drill(s, KILL_SPECS, lambda r: None, before,
                       dict(page_size=4, max_batch_slots=2))


def test_kill_mid_decode_migrates_token_identically(sides):
    rec = _both(sides, _drill_kill_mid_decode)
    _exactly_once(rec)
    assert rec["counters"] == {"paddle_tpu_router_migrated_total": 2,
                               "paddle_tpu_router_requeued_total": 1}
    assert rec["states"]["m/0"] == "down" and rec["pages"] == (0, 0)


def _drill_kill_mid_chunk(s):
    """Scenario 12: killed between the prompt chunks of a long request;
    it resumes on m/1 through m/1's cached prefix."""
    rng = np.random.RandomState(23)
    prefix = rng.randint(0, 128, (24,))
    long_prompt = np.concatenate([prefix, rng.randint(0, 128, (20,))])
    specs = [(P5, 10, 0.9, 41, {}), (long_prompt, 6, 0.8, 42, {})]

    def build(r):
        for eid in ("m/0", "m/1"):
            e = r.engine(eid)
            e.add_request(np.concatenate([prefix, [1]]), max_new_tokens=1)
            e.run()

    def before(r, e0, specs_, chunks):
        dec = e0.add_request(P5, max_new_tokens=10, temperature=0.9,
                             seed=41, stream_cb=_chunk_cb(chunks, 0))
        r.step()
        r.step()
        lng = e0.add_request(long_prompt, max_new_tokens=6,
                             temperature=0.8, seed=42,
                             stream_cb=_chunk_cb(chunks, 1))
        r.step()
        st = next(x for x in e0.slots if x is not None
                  and x.req.req_id == lng)
        assert st.prefilling and st.pos > 24 and not st.gen
        return [dec, lng]
    return _kill_drill(s, specs, build, before,
                       dict(page_size=4, max_batch_slots=2, token_budget=8))


def test_kill_between_prompt_chunks(sides):
    rec = _both(sides, _drill_kill_mid_chunk)
    _exactly_once(rec)
    assert rec["counters"]["paddle_tpu_router_migrated_total"] == 2
    assert rec["saved_on_m1"] >= 24


class _SpecOracle:
    """Drafts the known continuation for the first two prompts (every
    burst accepted) and garbage for the third (every draft rolled
    back)."""

    def __init__(self, specs, refs):
        self.table = [(np.asarray(p).tolist(), [int(t) for t in ref])
                      for (p, *_r), ref in list(zip(specs, refs))[:2]]

    def propose(self, ids, k=None):
        seq = np.asarray(ids).tolist()
        for p, ref in self.table:
            done = len(seq) - len(p)
            if 0 <= done and seq[:len(p)] == p and seq[len(p):] == ref[:done]:
                return np.asarray(ref[done:done + (k or 1)], np.int32)
        return np.full(k or 1, 127, np.int32)


def _drill_kill_mid_spec(s):
    def before(r, e0, specs, chunks):
        rids = _submit_on(e0, specs, chunks)
        for _ in range(2):
            r.step()
        return rids
    rec = _kill_drill(s, KILL_SPECS, lambda r: None, before,
                      dict(page_size=4, max_batch_slots=2, spec_k=3),
                      drafter=_SpecOracle)
    rec["accepted"] = s.counter(
        "paddle_tpu_serving_spec_accepted_tokens_total") > 0
    return rec


def test_kill_mid_speculative_burst(sides):
    rec = _both(sides, _drill_kill_mid_spec)
    _exactly_once(rec)
    for i, ref in enumerate(rec["refs"]):
        # only committed tokens reached a stream by the kill
        got = [t for _s, t, _f in rec["chunks"][i][:rec["at_kill"][i]]
               if t is not None]
        assert got == ref[:len(got)]


def _drill_kill_parked(s):
    """Scenario 18: int8 pages, a page-starved pool, the low-priority
    stream parked on the host tier when m/0 dies."""
    specs = [(P9, 10, 0.9, 51, dict(priority=5)),
             (np.concatenate([P5, P3]), 4, 0.7, 52, dict(priority=0))]

    def before(r, e0, specs_, chunks):
        (p0, n0, t0, s0, x0), (p1, n1, t1, s1, x1) = specs_
        lo = e0.add_request(p0, max_new_tokens=n0, temperature=t0, seed=s0,
                            stream_cb=_chunk_cb(chunks, 0), **x0)
        r.step()
        r.step()
        hi = e0.add_request(p1, max_new_tokens=n1, temperature=t1, seed=s1,
                            stream_cb=_chunk_cb(chunks, 1), **x1)
        r.step()
        assert e0.pool.offloaded_pages(lo) > 0
        return [lo, hi]
    rec = _kill_drill(s, specs, lambda r: None, before,
                      dict(page_size=4, num_pages=8, max_batch_slots=3,
                           kv_dtype="int8", host_offload=True))
    return rec


def test_kill_with_a_parked_stream(sides):
    rec = _both(sides, _drill_kill_parked)
    _exactly_once(rec)
    assert rec["pages"] == (0, 0) and rec["step_compiles_ok"]


