"""paddle_tpu_torch.serving.router (and api) against the JAX package's.

Every drill runs twice on the same traffic: once through the JAX
package's ``Router`` over JAX engines, once through the port's over port
engines on the CPU, with the same weights (``tests/test_router.py``'s
tiny Llama, and a tiny GPT for the multi-model drill, carried by
``load_reference_state_dict``; ``torch_router_common.py``). The outcomes
must be equal: dispatch placements, gate states, health views, finish
reasons, token streams, stream chunks ``(seq, token, finished)``,
counter deltas (each read from its package's own registry), used pages
and move-once marks. Streams compare exactly: a request's stream is a
pure function of (prompt, seed, temperature) in both packages, across
requeue and migration.

Here: least-loaded dispatch with round-robin ties, routing errors,
requeue-once on a degraded engine and ``"unavailable"`` when the fleet
is dark, ``mark_down`` of an engine whose methods raise, the health
views, the adapter hot-load with its canary, runtime topology, and the
completion API routing by model between a Llama fleet and a GPT engine.
``Router.reload`` refuses a directory with no committed step (its twin
is ``test_torch_router_reload.py``). Crash containment and
migration are ``test_torch_router_migration.py``'s.
"""
import numpy as np
import pytest
from torch_router_common import (P3, P4, P5, P9, _both, _streams, _trip,
                                 make_sides, no_leaked_faults)
from torch_router_common import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def sides():
    return make_sides()


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield from no_leaked_faults()


# ─────────────────────────────── dispatch ────────────────────────────────


def _drill_dispatch(s):
    """Ties rotate, load steers away; every placement by engine id."""
    r = s.router()
    s.add(r, "m", replicas=3, page_size=4, max_batch_slots=2)
    placed = []
    for p, n in ((P5, 2), (P9, 20), (P3, 2), (P4, 9), (P5, 3), (P9, 1),
                 (P3, 12), (P4, 2)):
        h = r.select("m")
        placed.append(h.engine_id)
        r.submit(p, model="m", max_new_tokens=n)
    r.step()
    for h in r.handles("m"):
        # the step-time EWMA is wall time: pin it, so placement reads the
        # queued and live work alone
        h.engine._avg_step_s = 0.05
    for p in (P5, P3):
        placed.append(r.select("m").engine_id)
        r.submit(p, model="m", max_new_tokens=4)
    d0 = {e: s.counter("paddle_tpu_router_dispatch_total", engine_id=e,
                       model_id="m") for e in ("m/0", "m/1", "m/2")}
    outs = r.run()
    return placed, sorted((o.finish_reason, o.n_gen) for o in outs.values()), \
        {k: v > 0 for k, v in d0.items()}


def test_dispatch_order_matches(sides):
    placed, _outs, _d = _both(sides, _drill_dispatch)
    assert len(set(placed)) == 3


def _drill_routing_errors(s):
    r = s.router()
    s.add(r, "a", page_size=4, max_batch_slots=1)
    s.add(r, "b", which="gpt", page_size=4, max_batch_slots=1)
    errs = []
    for call in (lambda: r.select(), lambda: r.select("zzz")):
        try:
            call()
        except ValueError as e:
            errs.append(str(e))
    r.drain("a/0")
    try:
        r.select("a")
    except s.serving.NoHealthyEngineError as e:
        errs.append(type(e).__name__)
    return errs


def test_routing_errors_match(sides):
    errs = _both(sides, _drill_routing_errors)
    assert len(errs) == 3 and "zzz" in errs[1]


# ─────────────────────────── requeue and failover ──────────────────────────


def _drill_failover(s):
    """Scenario 7: NaN-poisoned and degraded m/0; its waiting work
    requeues once; with the fleet dark, waiting work is unavailable."""
    r = s.router()
    s.add(r, "m", replicas=2, page_size=4, max_batch_slots=1,
          watchdog_recovery_steps=999)
    e0, e1 = r.engine("m/0"), r.engine("m/1")
    victim = e0.add_request(P9, max_new_tokens=8)
    e0.step()
    queued = [e0.add_request(P3, max_new_tokens=3),
              e0.add_request(P4, max_new_tokens=3)]
    moved0 = s.counter("paddle_tpu_router_requeued_total")
    un0 = s.counter("paddle_tpu_router_unplaceable_total")
    e0.pool.poison_seq(victim)
    _trip(e0)
    outs = r.run()
    rec = [_streams(outs, [victim] + queued), len(outs),
           s.counter("paddle_tpu_router_requeued_total") - moved0,
           (e0.pool.used_pages, e1.pool.used_pages), r.states()]
    b1 = e1.add_request(P9, max_new_tokens=12)
    e1.step()
    q2 = e1.add_request(P3, max_new_tokens=2)
    _trip(e1)
    outs2 = r.run()
    rec += [_streams(outs2, [q2, b1]),
            s.counter("paddle_tpu_router_unplaceable_total") - un0,
            r.health(), r.health(engine="m/1")["status"], sorted(r._requeued)]
    return rec


def test_failover_requeue_once_matches(sides):
    rec = _both(sides, _drill_failover)
    assert rec[0][0][0] == "nan" and rec[2] == 2
    assert rec[5][0] == ("unavailable", []) and rec[6] == 1


def _drill_moved_once(s):
    r = s.router()
    s.add(r, "m", replicas=3, page_size=4, max_batch_slots=1,
          watchdog_recovery_steps=999)
    for h in r.handles("m"):     # every slot busy: a moved q waits
        h.engine.add_request(P9, max_new_tokens=6)
        h.engine.step()
    for h in r.handles("m"):
        h.engine._avg_step_s = 0.05  # placement reads work, not wall time
    e0 = r.engine("m/0")
    q = e0.add_request(P3, max_new_tokens=2)
    _trip(e0)
    r.step()                     # q moves to a sibling
    holder = next(h.engine_id for h in r.handles("m")
                  if any(w.req_id == q for w in h.engine.scheduler.waiting)
                  or any(st is not None and st.req.req_id == q
                         for st in h.engine.slots))
    _trip(r.engine(holder))
    outs = r.run()
    return holder, outs[q].finish_reason, outs[q].n_gen, r.states()


def test_moved_request_never_moves_twice(sides):
    rec = _both(sides, _drill_moved_once)
    assert rec[1] == "unavailable"


def _drill_mark_down_broken(s):
    """An engine whose methods raise is still markable down; its
    readable work is scraped and placed."""
    r = s.router()
    s.add(r, "m", replicas=2, page_size=4, max_batch_slots=1)
    e0 = r.engine("m/0")
    a = e0.add_request(P5, max_new_tokens=5, seed=3, temperature=0.8)
    e0.step()
    b = e0.add_request(P3, max_new_tokens=3)

    def boom(*_a, **_k):
        raise RuntimeError("broken method")
    e0.export_inflight = boom
    e0.steal_queued = boom
    r.mark_down("m/0")
    outs = r.run()
    return _streams(outs, [a, b]), r.states(), r.health(engine="m/0")


def test_mark_down_on_a_broken_engine(sides):
    rec = _both(sides, _drill_mark_down_broken)
    assert [x[0] for x in rec[0]] == ["length", "length"]


# ────────────────────────── health, topology, adapters ──────────────────────


def _drill_health(s):
    r = s.router()
    s.add(r, "a", replicas=2, page_size=4, max_batch_slots=1,
          watchdog_recovery_steps=2)
    s.add(r, "g", which="gpt", page_size=4, max_batch_slots=1)
    views = [r.health()]
    r.drain("a/0")
    views.append(r.health())
    _trip(r.engine("a/1"))
    views.append(r.health())
    views.append(r.health(engine="a/1"))
    views.append(r.health(engine="nope"))
    r.undrain("a/0")
    r.mark_down("g/0")
    views.append(r.health())
    r.undrain("g/0")
    for _ in range(3):
        r.engine("a/1").add_request(P3, max_new_tokens=1)
        r.step()
    r.run()
    views.append(r.health())
    views.append(r.states())
    return views


def test_health_views_match(sides):
    views = _both(sides, _drill_health)
    assert views[0]["status"] == "ok" and views[5]["status"] == "degraded"


def _drill_topology(s):
    r = s.router()
    s.add(r, "m", replicas=1, page_size=4, max_batch_slots=1)
    new = r.add_engine("m")
    errs = []
    for call in (lambda: r.remove_engine(new),):
        try:
            call()
        except ValueError as e:
            errs.append(str(e).split(" — ")[0])
    r.submit(P5, model="m", max_new_tokens=3)
    r.submit(P9, model="m", max_new_tokens=3)
    r.drain(new)
    outs = r.run()
    r.remove_engine(new)
    again = r.add_engine("m")
    return new, again, errs, sorted(o.n_gen for o in outs.values()), \
        sorted(r.states())


def test_topology_matches(sides):
    rec = _both(sides, _drill_topology)
    assert rec[:2] == ("m/1", "m/2")


def _drill_adapters(s):
    r = s.router()
    s.add(r, "m", replicas=2, page_size=4, max_batch_slots=2)
    w = s.serving.random_adapter(r.engine("m/0").adapters, seed=3, scale=0.2)
    good = r.register_adapter("acme", w, model="m")
    bad_w = {k: (np.full_like(a, np.nan), b) for k, (a, b) in w.items()}
    bad = r.register_adapter("bad", bad_w, model="m")
    holders = [h.engine_id for h in r.handles("m")
               if h.engine.adapters.holds("bad")]
    rid = r.submit(P9, model="m", max_new_tokens=6, adapter_id="acme",
                   temperature=0.8, seed=5)
    r.step()
    try:
        r.unregister_adapter("acme", model="m")
        in_use = None
    except ValueError as e:
        in_use = "in use" in str(e)
    outs = r.run()
    r.unregister_adapter("acme", model="m")
    return (good, bad, holders, in_use, _streams(outs, [rid]),
            s.counter("paddle_tpu_serving_adapter_loads_total",
                      result="error") > 0)


def test_adapter_hot_load_and_canary(sides):
    rec = _both(sides, _drill_adapters)
    assert [e["result"] for e in rec[1]["engines"]] == ["error", "error"]
    assert rec[2] == [] and rec[3] is True


def _drill_api(s):
    """One router, a two-engine Llama fleet and a GPT engine:
    ``CompletionAPI`` routes by ``model``."""
    r = s.router()
    s.add(r, "llama", replicas=2, page_size=4, max_batch_slots=2)
    s.add(r, "gpt", which="gpt", page_size=4, max_batch_slots=2)
    api = s.serving.CompletionAPI(r)
    chunks = []
    out = []
    for model, prompt in (("llama", [P5, P9]), ("gpt", [P3, P4]),
                          ("gpt", P9)):
        resp = api.create_completion(
            prompt, max_tokens=5, temperature=0.8, seed=4, model=model,
            stream_cb=chunks.append)
        out.append((resp["model"], resp["object"], resp["usage"],
                    [(c["index"], c["token_ids"], c["finish_reason"])
                     for c in resp["choices"]]))
    try:
        api.create_completion(P3, model="nope")
    except ValueError as e:
        out.append("nope" in str(e))
    return out, [(c["model"], c["choices"][0]["seq"],
                  c["choices"][0]["token_id"]) for c in chunks]


def test_completion_api_routes_by_model(sides):
    out, chunks = _both(sides, _drill_api)
    assert out[0][0] == "llama" and out[1][0] == "gpt" and out[-1] is True
    assert len(chunks) == 5 * 5 + 5


def test_reload_is_not_ported(sides, tmp_path):
    """``Router.reload`` is ported now (``test_torch_router_reload.py``
    holds it to the JAX router); without a committed checkpoint it
    raises, in reload and in ``recover(ckpt_dir=)``, and the fleet stays
    healthy."""
    from paddle_tpu_torch.checkpoint import CheckpointNotFoundError

    r = sides[1].router()
    sides[1].add(r, "m", page_size=4, max_batch_slots=1)
    with pytest.raises(CheckpointNotFoundError):
        r.reload(str(tmp_path))
    with pytest.raises(CheckpointNotFoundError):
        r.recover(wal_dir=str(tmp_path / "w"), ckpt_dir=str(tmp_path))
    assert r.states() == {"m/0": "healthy"}


