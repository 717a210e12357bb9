"""The serving control plane: one front door over a fleet of engines.

Counterpart of ``paddle_tpu/serving/router.py`` over the port's
:class:`~.engine.ServingEngine` (Llama or GPT, each engine stepping its
own captured programs). Host code only; it drives engines between their
steps and never inside one.

- **Least-loaded dispatch**: admission picks the healthy engine with the
  least ``load_score()``; exact ties rotate round-robin. Every placement
  moves ``paddle_tpu_router_dispatch_total{engine_id,model_id}``.
- **Health gates**: each engine is ``healthy``, ``degraded`` (derived
  from its watchdog at every :meth:`Router.step`), ``draining`` or
  ``down``. A gated engine takes no admissions and keeps stepping its
  in-flight work; its queue moves to healthy siblings exactly once, and
  what cannot move retires ``"unavailable"``.
- **Crash containment and in-flight migration**: an exception out of one
  engine's ``step()`` marks that engine down and everything it held
  moves: the queue requeues, live requests migrate by their token
  journals (``export_inflight``) to a sibling, which re-prefills prompt
  + journal through its own bucketed programs and streams on token for
  token from the journaled seq. :meth:`Router.mark_down` takes the same
  path.
- **Durability** (``wal_dir=``): admissions, committed tokens and
  retirements are journaled in a :class:`~.wal.RequestWAL`, one fsync a
  :meth:`Router.step` (group commit), and stream chunks reach clients
  only after that commit; :meth:`Router.recover` on a fresh router
  re-admits every unfinished request after a process death.
- **Multi-model tenancy**: ``{model_id: [engines]}``; :meth:`select` and
  :meth:`submit` route by model id, and an unknown id raises naming the
  served ones. :meth:`add_engine` and :meth:`remove_engine` are the
  autoscaler's primitives.
- **Adapters**: :meth:`Router.register_adapter` hot-loads a LoRA adapter
  on every engine of a model under traffic, each proven by a one-token
  canary through it; a failed canary rolls that engine's install back.

Not ported: the rolling weight reload. :meth:`Router.reload` raises
``NotImplementedError`` until the port has its checkpoint manager.

Threading: dispatch, step and run belong to one driver thread, the one
that launches every engine's device work (in torch the current CUDA
stream is per thread). :meth:`health` and :meth:`states` read host state
only and are safe from a scrape thread (``MetricsServer(
health_cb=router.health)`` serves ``/healthz``, 503 only when some
served model has no healthy engine, and ``/healthz?engine=<id>``).

State machine::

    healthy --watchdog trip--> degraded --recovery steps--> healthy
    healthy --drain()--> draining --undrain()--> healthy
    any --mark_down()/step crash--> down --undrain()--> healthy
"""
from __future__ import annotations

import signal as _signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import faults, metrics
from . import tracing
from .engine import ServingEngine
from .grammar import GrammarFSM, toy_tokenizer
from .scheduler import Request, RequestOutput
from .wal import RequestWAL, WalRequest

__all__ = ["Router", "EngineHandle", "NoHealthyEngineError",
           "HEALTHY", "DEGRADED", "DRAINING", "DOWN"]

HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
DOWN = "down"

# numeric encoding for the per-engine state gauge: alerts key on > 0
# (any engine out of rotation)
_STATE_CODE = {HEALTHY: 0.0, DEGRADED: 1.0, DRAINING: 2.0, DOWN: 3.0}

faults.declare_point(
    "router.engine_step", "wrapping ONE engine's step() inside "
    "router.step() — a raise here simulates that engine dying mid-decode; "
    "the router must contain it (mark down, migrate its in-flight work) "
    "and never let it escape the fleet loop")


class NoHealthyEngineError(RuntimeError):
    """Every engine serving the requested model is out of rotation
    (degraded/draining/down) — the 503 analogue of BackpressureError's
    429. The fleet is known-unable to admit right now; retry after the
    watchdog recovers or the drain/reload finishes."""


class EngineHandle:
    """One engine's seat in the router: identity, gate state, and the
    weight version it serves."""

    __slots__ = ("engine", "engine_id", "model_id", "state", "weights_step",
                 "last_error")

    def __init__(self, engine: ServingEngine, engine_id: str,
                 model_id: str):
        self.engine = engine
        self.engine_id = engine_id
        self.model_id = model_id
        self.state = HEALTHY
        self.weights_step: Optional[int] = None  # last reload's ckpt step
        self.last_error: Optional[str] = None    # repr of a step() crash


class Router:
    """Control plane over a fleet of engines (see module docstring).

    ::

        router = Router()
        router.add_model("llama", model, replicas=2, page_size=16)
        rid = router.submit(prompt_ids, model="llama", max_new_tokens=32)
        outputs = router.run()               # least-loaded, health-gated

    ``add_model`` accepts one model (its weights shared by every replica:
    the serving step only reads them, and each engine owns its KV pool,
    adapter store and step programs) or a sequence of model instances,
    one per replica."""

    def __init__(self, retry_budget=None, wal_dir: Optional[str] = None,
                 wal_segment_bytes: int = 1 << 20):
        """``retry_budget`` (an :class:`~.overload.RetryBudget`) gates
        failover requeue/migration placements per model so an incident
        storm can't amplify load — each placement spends one token,
        :meth:`step` refills, and a dry bucket retires the request
        ``"unavailable"`` immediately (fail fast, never a retry loop).
        None (the default) keeps retries unmetered.

        ``wal_dir`` opts the router into DURABILITY (serving/wal.py):
        every :meth:`submit` journals
        an admission record, every step's committed tokens journal as a
        progress record, and retirement is journaled — group-committed
        with ONE fsync per :meth:`step`. Stream chunks are released to
        client callbacks only AFTER the commit barrier (commit-then-
        emit), so a client can never have seen a token the log could
        lose; after a process death, :meth:`recover` on a fresh router
        pointed at the same directory re-admits every unfinished
        request and the streams complete bit-identical, chunks
        exactly-once. None (the default) keeps the old purely
        in-memory behavior."""
        self._retry_budget = retry_budget
        self._wal = (None if wal_dir is None else
                     RequestWAL(wal_dir, segment_bytes=wal_segment_bytes))
        self._wal_ids: Dict[object, int] = {}    # req_id -> live wal_id
        self._wal_cursor: Dict[int, int] = {}    # wal_id -> committed toks
        self._wal_alias: Dict[int, int] = {}     # superseded -> successor
        self._client_cbs: Dict[int, Callable] = {}
        self._chunk_buf: List[tuple] = []        # awaiting the commit
        self._stream_hist: Dict[int, List[tuple]] = {}
        self._models: Dict[str, List[EngineHandle]] = {}
        self._handles: Dict[str, EngineHandle] = {}
        self._rr: Dict[str, int] = {}          # per-model tie-break cursor
        # per-model construction spec (shared model ref + engine kwargs)
        # so add_engine() can stamp out identical replicas at runtime,
        # and a monotone id cursor so engine ids are NEVER reused across
        # a remove/add cycle (metrics label children and journals keyed
        # by engine_id must stay unambiguous)
        self._specs: Dict[str, tuple] = {}
        self._next_idx: Dict[str, int] = {}
        self._lock = threading.Lock()  # rr cursors and state flips
        self._requeued: set = set()            # req_ids moved once already
        self._stash: Dict[object, RequestOutput] = {}
        # fleet tracer + flight recorder (tracing.py): dispatch/requeue/
        # migrate land in the same journal the engines write, and the
        # recorder auto-dumps on crash containment and on the aggregate
        # /healthz ok→degraded transition
        self._trace = tracing.get_tracer()
        self._last_health_ok = True
        reg = metrics.get_registry()
        self._m_dispatch = reg.counter(
            "paddle_tpu_router_dispatch_total",
            "Requests placed on an engine by the router's least-loaded "
            "dispatch", labels=("engine_id", "model_id"))
        self._m_requeued = reg.counter(
            "paddle_tpu_router_requeued_total",
            "Waiting requests moved off a non-healthy engine onto a "
            "healthy sibling (each request moves at most once)")
        self._m_unplaceable = reg.counter(
            "paddle_tpu_router_unplaceable_total",
            "Requests (waiting or in-flight) the router could not place "
            "on a sibling (no healthy engine / bounded queue full / "
            "already moved once) — retired with "
            "finish_reason=\"unavailable\"")
        self._m_migrated = reg.counter(
            "paddle_tpu_router_migrated_total",
            "IN-FLIGHT requests moved off a dead engine onto a healthy "
            "sibling via their token journals (each request moves at "
            "most once; the continued stream is token-identical)")
        self._m_crash = reg.counter(
            "paddle_tpu_router_engine_crash_total",
            "Exceptions escaping one engine's step() that the router "
            "contained by marking the engine down and migrating its work",
            labels=("engine_id", "model_id"))
        self._m_adapter_loads = reg.counter(
            "paddle_tpu_serving_adapter_loads_total",
            "Fleet-wide LoRA adapter hot-loads via "
            "Router.register_adapter, by per-engine result (a canary "
            "failure rolls that engine's install back)",
            labels=("result",))
        for r in ("ok", "error"):
            self._m_adapter_loads.labels(result=r)
        self._m_state = reg.gauge(
            "paddle_tpu_router_engine_state",
            "Router gate state per engine: 0 healthy, 1 degraded, "
            "2 draining, 3 down", labels=("engine_id", "model_id"))
        self._m_budget_exhausted = reg.counter(
            "paddle_tpu_router_retry_budget_exhausted_total",
            "Failover placements refused because the model's retry "
            "budget was dry (the request retired \"unavailable\" "
            "instead of joining a requeue/migration storm)",
            labels=("model_id",))
        self._m_recovered = reg.counter(
            "paddle_tpu_wal_recovered_requests_total",
            "Requests Router.recover() replayed out of the WAL after a "
            "process restart, by outcome: resumed (re-admitted via the "
            "journaled re-prefill path), completed (journal already "
            "terminal — only the retire record was torn away), expired "
            "(deadline lapsed across the death), failed (no engine "
            "could adopt it)", labels=("outcome",))
        for oc in ("resumed", "completed", "expired", "failed"):
            self._m_recovered.labels(outcome=oc)

    # ------------------------------------------------------------- topology
    def add_model(self, model_id: str, model, replicas: int = 1,
                  **engine_kwargs) -> List[str]:
        """Register ``replicas`` engines serving ``model`` under
        ``model_id``; returns the assigned engine ids
        (``"<model_id>/<n>"`` — stable, unlike the process-wide default).
        ``model`` may be a sequence of model instances (one per replica,
        ``replicas`` then defaults to its length). ``engine_kwargs`` go to
        every :class:`~.engine.ServingEngine` (``device=`` among them:
        ``cuda`` unless the caller asks for the CPU)."""
        model_id = str(model_id)
        if model_id in self._models:
            raise ValueError(
                f"model id {model_id!r} already registered "
                f"({len(self._models[model_id])} engines); model ids are "
                f"immutable — pick a new id for a new fleet")
        if isinstance(model, (list, tuple)):
            models = list(model)
            if not models:
                raise ValueError("empty model sequence")
            replicas = len(models)
        else:
            models = [model] * int(replicas)
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        handles = []
        for i, m in enumerate(models):
            eid = f"{model_id}/{i}"
            eng = ServingEngine(m, engine_id=eid, model_id=model_id,
                                **engine_kwargs)
            handles.append(EngineHandle(eng, eid, model_id))
        with self._lock:
            self._models[model_id] = handles
            for h in handles:
                self._handles[h.engine_id] = h
                self._set_state_gauge(h)
            self._rr.setdefault(model_id, 0)
            self._specs[model_id] = (models[0], dict(engine_kwargs))
            self._next_idx[model_id] = len(models)
        return [h.engine_id for h in handles]

    def add_engine(self, model_id: Optional[str] = None, model=None,
                   **engine_overrides) -> str:
        """Spawn ONE more engine for an already-registered model at
        runtime — the autoscaler's scale-up primitive. The new replica
        reuses the ``add_model`` construction spec (the shared model and
        the original ``engine_kwargs``); ``model=`` / keyword overrides
        replace pieces of the spec. It builds its own KV pool and step
        programs: on a card it captures a CUDA graph for each bucket it
        meets (a graph belongs to its engine's memory pool and its
        process), while the CUDA kernels it launches were built once per
        process. The
        engine id is ``"<model_id>/<n>"`` with a monotone ``n`` that is
        never reused after :meth:`remove_engine`, and the replica
        enters rotation ``healthy`` immediately."""
        mid = self._resolve_model(model_id)
        base_model, kwargs = self._specs[mid]
        kwargs = dict(kwargs)
        kwargs.update(engine_overrides)
        with self._lock:
            idx = self._next_idx[mid]
            self._next_idx[mid] = idx + 1
        eid = f"{mid}/{idx}"
        eng = ServingEngine(base_model if model is None else model,
                            engine_id=eid, model_id=mid, **kwargs)
        h = EngineHandle(eng, eid, mid)
        with self._lock:
            self._models[mid].append(h)
            self._handles[eid] = h
        self._set_state_gauge(h)
        return eid

    def remove_engine(self, engine_id: str) -> None:
        """Retire one engine from the fleet — the autoscaler's
        scale-down primitive, and deliberately the UNFORGIVING half of
        drain-then-remove: the engine must already be gated out of
        admission (``draining``/``down``, via :meth:`drain` or
        :meth:`mark_down`) and must hold no work (its in-flight
        requests finished locally while draining; a downed engine was
        evacuated), and it must not be the model's last engine. Any
        violation raises instead of dropping requests — callers that
        want best-effort shedding have ``mark_down`` + migration for
        that. The engine's state gauge lands on the ``down`` code (its
        label child outlives the handle; 3 reads as "out of rotation"
        on dashboards)."""
        h = self._require(engine_id)
        if h.state == HEALTHY:
            raise ValueError(
                f"engine {h.engine_id!r} is still healthy (admitting) — "
                f"drain({h.engine_id!r}) first, step until its work "
                f"finishes, then remove")
        if self._safe_has_work(h):
            raise ValueError(
                f"engine {h.engine_id!r} still has queued or in-flight "
                f"work — keep stepping the fleet until it drains")
        # scoop outputs the engine finished but nobody collected yet:
        # after the handle is gone take_outputs() can't reach them, and
        # exactly-once handout must survive any remove/collect ordering
        try:
            self._stash.update(h.engine.take_outputs())
        except Exception:
            pass
        with self._lock:
            if len(self._models[h.model_id]) <= 1:
                raise ValueError(
                    f"engine {h.engine_id!r} is the last engine of model "
                    f"{h.model_id!r} — a served model must keep at least "
                    f"one replica (use drain() to just gate it out)")
            self._models[h.model_id].remove(h)
            del self._handles[h.engine_id]
            h.state = DOWN
        self._set_state_gauge(h)

    @property
    def models(self) -> List[str]:
        return sorted(self._models)

    def engines(self, model: Optional[str] = None) -> List[ServingEngine]:
        """Engines of one model (router order) or the whole fleet."""
        if model is not None:
            return [h.engine for h in self._model_handles(model)]
        return [h.engine for h in self._handles.values()]

    def engine(self, engine_id: str) -> ServingEngine:
        return self._require(engine_id).engine

    def handles(self, model: Optional[str] = None) -> List[EngineHandle]:
        """Snapshot of one model's (or the whole fleet's) handles —
        (engine, id, state) triples for controllers that read topology
        without mutating it (the loadgen autoscaler's signal scan)."""
        if model is not None:
            mid = self._resolve_model(model)
            with self._lock:
                return list(self._models[mid])
        with self._lock:
            return list(self._handles.values())

    def states(self) -> Dict[str, str]:
        """{engine_id: state} snapshot of the whole fleet (safe from any
        thread: iterates a copy taken under the topology lock)."""
        with self._lock:
            handles = list(self._handles.values())
        return {h.engine_id: h.state for h in handles}

    def __len__(self) -> int:
        return len(self._handles)

    def _model_handles(self, model) -> List[EngineHandle]:
        mid = self._resolve_model(model)
        return self._models[mid]

    def _resolve_model(self, model) -> str:
        if model is None:
            if len(self._models) == 1:
                return next(iter(self._models))
            raise ValueError(
                f"model= is required when the router serves "
                f"{len(self._models)} models (serving: {self.models}); "
                f"pass one of them")
        mid = str(model)
        if mid not in self._models:
            # 4xx-style actionable rejection, same contract as
            # engine.check_request: name what was asked AND what exists
            raise ValueError(
                f"unknown model id {mid!r} (serving: {self.models}); "
                f"register it with router.add_model({mid!r}, model) or "
                f"request a served model")
        return mid

    def _set_state_gauge(self, h: EngineHandle) -> None:
        self._m_state.labels(engine_id=h.engine_id,
                             model_id=h.model_id).set(_STATE_CODE[h.state])

    # ------------------------------------------------------------- dispatch
    def select(self, model: Optional[str] = None,
               adapter_id: Optional[str] = None) -> EngineHandle:
        """Least-loaded healthy engine for ``model`` (the single served
        model when omitted): minimum ``engine.load_score()``; exact ties
        rotate round-robin. ``adapter_id`` narrows tenancy to
        ``(model_id, adapter_id)``: only engines whose AdapterStore
        holds the adapter are candidates (every engine holds ``None``).
        Raises ValueError for an unknown model and
        :class:`NoHealthyEngineError` when every engine of the model is
        gated out (or none holds the adapter)."""
        mid = self._resolve_model(model)
        cands = [h for h in self._models[mid] if h.state == HEALTHY]
        if adapter_id is not None:
            holders = [h for h in cands
                       if h.engine.adapters.holds(adapter_id)]
            if cands and not holders:
                raise NoHealthyEngineError(
                    f"no healthy engine for model {mid!r} holds adapter "
                    f"{adapter_id!r}; register_adapter() hot-loads it "
                    f"fleet-wide")
            cands = holders
        if not cands:
            states = {h.engine_id: h.state for h in self._models[mid]}
            raise NoHealthyEngineError(
                f"no healthy engine for model {mid!r} (states: {states}); "
                f"retry after recovery, or undrain()/reload a replica")
        scores = [h.engine.load_score() for h in cands]
        best = min(scores)
        tied = [h for h, s in zip(cands, scores) if s == best]
        with self._lock:
            pick = tied[self._rr[mid] % len(tied)]
            # modular, not unbounded (the same fix EnginePool.next got):
            # the cursor only breaks ties, so any stable modulus works
            self._rr[mid] = (self._rr[mid] + 1) % len(self._models[mid])
        return pick

    def submit(self, prompt, model: Optional[str] = None,
               **request_kwargs):
        """Route one request: least-loaded placement + dispatch counter.
        Returns the engine's ``req_id``; raises like
        ``ServingEngine.add_request`` (plus the routing errors of
        :meth:`select`). A request carrying ``adapter_id=`` routes only
        to engines holding that adapter. Drive the fleet with
        :meth:`run`."""
        h = self.select(model, adapter_id=request_kwargs.get("adapter_id"))
        if self._wal is not None:
            rid = self._submit_durable(h, prompt, request_kwargs)
        else:
            rid = h.engine.add_request(prompt, **request_kwargs)
        self._m_dispatch.labels(engine_id=h.engine_id,
                                model_id=h.model_id).inc()
        self._trace.emit("req.dispatch", rid, label=h.engine_id)
        return rid

    def _submit_durable(self, h: EngineHandle, prompt,
                        request_kwargs: dict):
        """WAL-armed admission: swap the client's ``stream_cb`` for the
        router's buffering wrapper (chunks release only after the next
        group commit — commit-then-emit) and journal the admission
        record. The record is framed AFTER ``add_request`` accepts (a
        backpressure-rejected request must not leave a forever-pending
        admit in the log) and becomes durable at the next
        :meth:`step`'s fsync — the group-commit window. The journaled
        fields come from the ACCEPTED Request object itself
        (``Request.wal_admission``), so engine-side defaulting and seed
        canonicalization can never drift from what recovery rebuilds."""
        wid = self._wal.new_id()
        kwargs = dict(request_kwargs)
        client_cb = kwargs.pop("stream_cb", None)
        kwargs["stream_cb"] = self._durable_cb(wid)
        rid = h.engine.add_request(prompt, **kwargs)
        req = next(r for r in h.engine.scheduler.waiting
                   if r.req_id == rid)
        self._wal.append("admit",
                         **req.wal_admission(wid, model=h.model_id))
        self._wal_ids[rid] = wid
        self._wal_cursor[wid] = 0
        if client_cb is not None:
            self._client_cbs[wid] = client_cb
        return rid

    def wal_id_of(self, req_id) -> Optional[int]:
        """The durable id journaled for a live request this process
        admitted (or recovered) — ``Request.req_id`` is a plain process-
        local counter and collides across restarts, so the WAL id is
        what a client must hold to :meth:`attach_stream` after a crash.
        None when the request is unknown or the router runs WAL-off."""
        return self._wal_ids.get(req_id)

    def _count_dispatch(self, h: EngineHandle) -> None:
        """Dispatch-accounting hook for front doors (CompletionAPI) that
        enqueue on a selected handle themselves."""
        self._m_dispatch.labels(engine_id=h.engine_id,
                                model_id=h.model_id).inc()

    # ----------------------------------------------------------- health gate
    def _refresh_health(self) -> None:
        """Derive degraded/healthy from each engine's watchdog and
        auto-drain the queue of anything that just left rotation. Manual
        states (draining/down) are sticky — only undrain()/reload flip
        them back. A health probe that RAISES (or returns garbage) is
        worse than degraded: contained like a step crash, so a broken
        engine can never kill the fleet loop through its own probe."""
        for h in list(self._handles.values()):
            if h.state in (DRAINING, DOWN):
                continue
            try:
                ok = h.engine.health()["status"] == "ok"
            except Exception as e:
                self._contain(h, e)
                continue
            if h.state == HEALTHY and not ok:
                with self._lock:
                    h.state = DEGRADED
                self._set_state_gauge(h)
                self._requeue_waiting(h)
            elif h.state == DEGRADED and ok:
                with self._lock:
                    h.state = HEALTHY
                self._set_state_gauge(h)

    def _requeue_waiting(self, h: EngineHandle) -> None:
        """Move ``h``'s WAITING requests onto healthy siblings, each
        exactly once; whatever cannot move retires
        ``finish_reason="unavailable"`` on ``h`` (delivered through the
        normal output path). In-flight slots stay: they finish on ``h``
        (still stepping while degraded/draining) or migrate when ``h``
        goes down (:meth:`_migrate_inflight`). If ``steal_queued``
        itself raises, the queue is scraped by hand — a broken METHOD
        must not silently drop requests whose state is readable."""
        try:
            stolen = h.engine.steal_queued()
        except Exception:
            stolen = self._scrape_queued(h)
        self._place_elsewhere(h, stolen, self._m_requeued)

    def _migrate_inflight(self, h: EngineHandle) -> None:
        """Move ``h``'s IN-FLIGHT requests onto healthy siblings via
        their token journals (``engine.export_inflight``), each exactly
        once under the same ``_requeued`` move-once discipline as
        waiting-requeue: the adoptive engine re-prefills prompt +
        journal and continues the stream token-identically, resuming
        emission at the journaled seq. Unplaceable requests retire
        ``"unavailable"`` delivering the tokens generated so far. If
        ``export_inflight`` itself raises, the journals are scraped by
        hand (they are plain host state)."""
        try:
            journals = h.engine.export_inflight()
        except Exception:
            journals = self._scrape_inflight(h)
        self._place_elsewhere(h, journals, self._m_migrated)

    def _scrape_inflight(self, h: EngineHandle) -> List[Request]:
        """Fallback when the INSTANCE's ``export_inflight`` attribute is
        broken (shadowed, wrapped, corrupted): invoke the CLASS
        implementation directly on the engine's host state — the
        journals are plain python lists, and losing a mid-stream request
        because a method binding is broken would violate
        never-silently-dropped. One copy of the journaling logic either
        way. Anything truly unreadable stays lost (nothing more exists
        to read)."""
        try:
            return ServingEngine.export_inflight(h.engine)
        except Exception:
            return []

    def _scrape_queued(self, h: EngineHandle) -> List[Request]:
        """``steal_queued`` fallback via the class implementation, same
        rationale as :meth:`_scrape_inflight`."""
        try:
            return ServingEngine.steal_queued(h.engine)
        except Exception:
            return []

    def _place_elsewhere(self, h: EngineHandle, reqs: Sequence[Request],
                         moved_counter) -> None:
        """The one placement loop behind requeue AND migration: move each
        request to a healthy sibling at most once; a request that cannot
        move (no healthy engine, target refused, already moved) retires
        ``"unavailable"`` — never dropped, never duplicated."""
        for req in reqs:
            if (self._retry_budget is not None
                    and not self._retry_budget.try_take(h.model_id)):
                # retry budget dry: an incident storm is re-dispatching
                # faster than the bucket refills — fail fast instead of
                # amplifying the overload with another placement
                self._m_budget_exhausted.labels(
                    model_id=h.model_id).inc()
                self._retire_unavailable(h, req)
                continue
            target: Optional[EngineHandle] = None
            if req.req_id not in self._requeued:
                try:
                    # tenancy-aware failover: a constrained/adapter
                    # request may only land on a sibling HOLDING its
                    # adapter — adopt_request would reject any other
                    target = self.select(h.model_id,
                                         adapter_id=req.adapter_id)
                except (ValueError, NoHealthyEngineError):
                    target = None
            if target is None:
                self._retire_unavailable(h, req)
                continue
            self._requeued.add(req.req_id)
            try:
                target.engine.adopt_request(req)
            except Exception:
                # the one chosen target refused (bounded queue, shape cap
                # mismatch between heterogeneous replicas): placement is
                # impossible NOW — retire deterministically rather than
                # shopping the request around the fleet
                self._retire_unavailable(h, req)
                continue
            moved_counter.inc()
            # literal event names at BOTH sites (not one parameterized
            # emit): the TPL010 docs-parity collector only sees literals
            if moved_counter is self._m_migrated:
                self._trace.emit("req.migrate", req.req_id,
                                 label=target.engine_id)
            else:
                self._trace.emit("req.requeue", req.req_id,
                                 label=target.engine_id)

    def _retire_unavailable(self, h: EngineHandle, req: Request) -> None:
        """Deterministic dead end: retire ``req`` with
        ``finish_reason="unavailable"`` (journaled tokens, if any,
        deliver — they were already streamed) and drop its move-once
        mark NOW: the id will never be seen again, so keeping the mark
        would leak it forever (the ``_requeued`` growth bug)."""
        self._m_unplaceable.inc()
        self._requeued.discard(req.req_id)
        try:
            h.engine.retire_queued(req, "unavailable")
        except Exception:
            # even the source engine's emit path is dead: the router
            # still owes the caller an output exactly once — synthesize
            # it into the stash run() merges from — AND the terminal
            # stream chunk a streaming client is blocked on (via the
            # engine's _safe_cb so the 3-arg/4-arg protocol and
            # isolation stay in one place; pure host code, guarded)
            self._stash[req.req_id] = RequestOutput(
                req_id=req.req_id, prompt_token_ids=req.prompt,
                token_ids=list(req.resume_tokens or ()),
                finish_reason="unavailable")
            if req.stream_cb is not None:
                try:
                    h.engine._safe_cb(req, None, "unavailable",
                                      len(req.resume_tokens or ()))
                except Exception:
                    pass

    # ---------------------------------------------------------------- drive
    @property
    def has_work(self) -> bool:
        return any(self._safe_has_work(h)
                   for h in list(self._handles.values()))

    def _safe_has_work(self, h: EngineHandle) -> bool:
        """``engine.has_work`` with crash containment: a probe that
        raises gates the engine down (its readable requests evacuate via
        :meth:`_contain`, after which it genuinely has no work here)."""
        if h.state == DOWN:
            return False
        try:
            return bool(h.engine.has_work)
        except Exception as e:
            self._contain(h, e)
            return False

    def step(self) -> None:
        """One fleet sweep: refresh health gates (auto-draining anything
        that tripped), then step every non-down engine that has work.

        CRASH CONTAINMENT: an exception escaping one engine's ``step()``
        — or its ``has_work``/``health()`` probes (hardware fault, bug,
        armed ``router.engine_step`` injection) — never propagates: that
        engine is marked ``down``
        (``paddle_tpu_router_engine_crash_total``), its waiting requests
        requeue and its in-flight requests migrate by token journal,
        and the sweep continues with the next engine. A single engine
        death is invisible to every other tenant of the fleet."""
        if self._retry_budget is not None:
            self._retry_budget.refill()  # one sweep's worth of tokens
        self._refresh_health()
        for h in list(self._handles.values()):
            if h.state == DOWN:
                continue
            try:
                if not h.engine.has_work:
                    continue
                faults.point("router.engine_step")
                h.engine.step()
            except Exception as e:
                self._contain(h, e)
        # reap move-once marks of moved requests that retired on their
        # adoptive engine: a step()-driven server (never calling run())
        # must not grow _requeued forever across incidents. Free in the
        # steady state (the set is empty unless a failover happened);
        # after one, a single guarded pass keeps only ids still live
        # somewhere in the fleet.
        if self._requeued:
            live = self._live_req_ids()
            if live is not None:
                self._requeued &= live
        if self._wal is not None:
            self._wal_commit_and_flush()

    def _live_req_ids(self) -> Optional[set]:
        """Every req_id currently queued or in-flight on any non-down
        engine; None when some engine's state is unreadable (reaping
        aborts for that sweep rather than dropping a mark that might
        still be live). The slot scan covers EVERY in-flight request —
        decoding slots and all concurrently chunk-prefilling slots alike
        (the unified-step engine parks a request in its slot at
        admission, so there is no out-of-slot "active prefill" state to
        enumerate separately; the old single-`_active_prefill` probe
        would silently drop every concurrent chunked prefill but one
        from migration accounting)."""
        live: set = set()
        try:
            for h in self._handles.values():
                if h.state == DOWN:
                    continue  # evacuated: holds no router-managed work
                eng = h.engine
                for req in eng.scheduler.waiting:
                    live.add(req.req_id)
                for st in eng.slots:
                    if st is not None:
                        live.add(st.req.req_id)
        except Exception:
            return None
        return live

    def _contain(self, h: EngineHandle, exc: BaseException) -> None:
        """Contain one engine's failure: count it, record it on the
        handle (surfaces via ``/healthz?engine=``), gate it ``down``,
        and evacuate everything it held."""
        self._m_crash.labels(engine_id=h.engine_id,
                             model_id=h.model_id).inc()
        h.last_error = repr(exc)
        with self._lock:
            h.state = DOWN
        self._set_state_gauge(h)
        self._evacuate(h)
        try:
            # post-mortem first responder: the last window_s seconds of
            # fleet timeline — the victim's per-request histories with
            # the export/adopt hop just taken — land on disk before
            # anyone asks. A failed dump (armed tracing.dump fault,
            # full disk) loses diagnostics, never containment.
            self._trace.dump_flight(reason="crash")
        except Exception:
            pass

    def _evacuate(self, h: EngineHandle) -> None:
        """Empty a just-downed engine: in-flight requests migrate FIRST
        (their tokens are sunk cost and their streams have live
        consumers — under tight sibling capacity they must not lose
        their seat to a request that never started), then waiting
        requests requeue — each exactly once. Nothing raises even if the
        engine is too dead to cooperate (every engine touch inside is
        guarded)."""
        self._migrate_inflight(h)
        self._requeue_waiting(h)

    def take_outputs(self) -> Dict[object, RequestOutput]:
        """Outputs finished fleet-wide since the last collection, merged
        across engines plus anything the router synthesized
        (``_retire_unavailable`` dead ends) — exactly-once handout. The
        incremental collector a PACED driver (``paddle_tpu.loadgen``)
        needs: call it after each :meth:`step` instead of waiting for
        :meth:`run` to drain the whole fleet."""
        out = self._stash
        self._stash = {}
        for h in list(self._handles.values()):
            try:
                out.update(h.engine.take_outputs())
            except Exception:
                # a dead engine's outputs were already evacuated/stashed
                # by containment; never let its corpse break collection
                pass
        return out

    def run(self) -> Dict[object, RequestOutput]:
        """Drive :meth:`step` until the whole fleet drains; returns every
        output finished since the last :meth:`run`, merged across engines
        (a requeued or migrated request's output comes from its adoptive
        engine) — exactly-once handout, same contract as
        ``ServingEngine.run``."""
        while self.has_work:
            self.step()
        out = self.take_outputs()
        # the fleet is fully drained: every request has retired, so NO
        # live request can still hold a move-once mark. Clearing (rather
        # than subtracting the delivered ids) also reaps marks of
        # requests that retired without router-visible output —
        # cancelled on the adoptive engine, drained via engine.run() —
        # which used to leak forever (tests assert the set is empty
        # after every chaos drill)
        self._requeued.clear()
        return out

    def stash_unclaimed(self, outputs: Dict[object, RequestOutput]) -> None:
        """Hand back outputs a caller collected but does not own (a front
        door draining the fleet for its own req_ids); they merge into the
        next :meth:`run`'s return."""
        self._stash.update(outputs)

    # ---------------------------------------------------------- durability
    def _durable_cb(self, wal_id: int) -> Callable:
        """The stream wrapper every WAL-armed request decodes under:
        chunks land in the router's buffer instead of the client — the
        group commit at the end of :meth:`step` journals them and THEN
        releases them (commit-then-emit). The wrapper itself never
        raises, so the engine's callback isolation never fires for a
        durable stream; client exceptions surface at flush time and
        cost only the attachment, never the request."""
        def cb(rid, tok, fin, seq):
            self._chunk_buf.append((wal_id, rid, tok, fin, seq))
        return cb

    def _inflight_fsm_states(self) -> Dict[object, Optional[int]]:
        """Fleet-wide ``{req_id: grammar FSM state}`` snapshot for the
        group commit (guarded per engine: a dead engine's slots were
        already evacuated, and a raising probe must not block the
        commit of every other request's tokens)."""
        out: Dict[object, Optional[int]] = {}
        for h in list(self._handles.values()):
            if h.state == DOWN:
                continue
            try:
                out.update(h.engine.inflight_fsm_states())
            except Exception:
                pass
        return out

    def _wal_commit_and_flush(self) -> None:
        """The group commit closing one :meth:`step`: fold this step's
        buffered chunks into one ``progress`` record per request (plus
        ``retire`` for terminals), pay ONE fsync for the whole batch —
        admits framed by :meth:`submit` since the last barrier ride the
        same commit — and only then release the chunks to client
        callbacks. A crash before the fsync loses tokens no client ever
        saw (deterministic decode regenerates them identically); a crash
        after it loses only deliveries the client can replay via
        :meth:`attach_stream` — exactly-once across process death."""
        buf, self._chunk_buf = self._chunk_buf, []
        if buf:
            fsm = self._inflight_fsm_states()
            per: Dict[int, dict] = {}
            order: List[int] = []
            for wid, rid, tok, fin, _seq in buf:
                rec = per.get(wid)
                if rec is None:
                    per[wid] = rec = {"tokens": [], "fin": None,
                                      "rid": rid}
                    order.append(wid)
                if tok is not None:
                    rec["tokens"].append(int(tok))
                if fin:
                    rec["fin"] = str(fin)
            for wid in order:
                rec = per[wid]
                at = self._wal_cursor.get(wid, 0)
                if rec["tokens"]:
                    # the end-of-step FSM snapshot corresponds exactly
                    # to the journal INCLUDING this delta, which is the
                    # cursor position replay validates it against
                    self._wal.append("progress", id=wid, at=at,
                                     tokens=rec["tokens"],
                                     fsm=fsm.get(rec["rid"]))
                    self._wal_cursor[wid] = at + len(rec["tokens"])
                if rec["fin"] is not None:
                    self._wal.append("retire", id=wid,
                                     reason=rec["fin"])
        self._wal.commit()
        for wid, rid, tok, fin, seq in buf:
            self._deliver(wid, rid, tok, fin, seq)
        for wid, rid, _tok, fin, _seq in buf:
            if fin:
                # terminal delivered: release the durable-stream state
                # (the WAL keeps the durable copy; compaction reaps it)
                self._client_cbs.pop(wid, None)
                self._stream_hist.pop(wid, None)
                self._wal_cursor.pop(wid, None)
                self._wal_ids.pop(rid, None)

    def _deliver(self, wid: int, rid, tok, fin, seq) -> None:
        """Release one committed chunk: record it in the in-memory
        stream history (what :meth:`attach_stream` replays) and forward
        to the attached client, if any. Durable-stream callback
        isolation: a raising client loses its ATTACHMENT — the chunk is
        already journaled, so a reattach replays it — never the
        request (contrast the WAL-off engine path, where a broken
        callback retires the request ``"error"``: with no journal there
        is nothing to reattach to)."""
        self._stream_hist.setdefault(wid, []).append((seq, tok, fin))
        cb = self._client_cbs.get(wid)
        if cb is None:
            return
        try:
            cb(rid, tok, fin, seq)
        except Exception:
            self._client_cbs.pop(wid, None)

    def attach_stream(self, wal_id: int, stream_cb: Callable,
                      after_seq: int = -1) -> int:
        """(Re)attach a client callback to a durable stream by WAL id —
        the client half of exactly-once across process death: pass the
        last seq you saw as ``after_seq`` and every chunk after it
        replays from the journal history, then live chunks follow.
        Recovery aliases resolve (a request re-admitted by
        :meth:`recover` answers to its pre-crash id), and the resolved
        id is returned. Commit-then-emit makes the cursor sound: the
        client can never have seen a chunk the journal does not hold,
        so the replay + live handoff has no gap to fall into."""
        wid = int(wal_id)
        seen: set = set()
        while wid in self._wal_alias and wid not in seen:
            seen.add(wid)
            wid = self._wal_alias[wid]
        rid = next((r for r, w in self._wal_ids.items() if w == wid),
                   None)
        hist = list(self._stream_hist.get(wid, ()))
        for seq, tok, fin in hist:
            if seq > after_seq:
                try:
                    stream_cb(rid, tok, fin, seq)
                except Exception:
                    return wid          # client broke mid-replay
        if not (hist and hist[-1][2]):  # stream still live: go live
            self._client_cbs[wid] = stream_cb
        return wid

    def recover(self, wal_dir: Optional[str] = None,
                ckpt_dir: Optional[str] = None,
                grammar_resolver: Optional[Callable] = None
                ) -> Dict[int, dict]:
        """Replay the WAL and re-admit every unfinished request onto
        whatever engines THIS router has — the process-restart half of
        the durability contract. Call after ``add_model`` (the restarted
        fleet may have fewer or more replicas than the one that died;
        placement is ordinary least-loaded dispatch). ``wal_dir`` arms
        the WAL if the router was built without one; ``ckpt_dir`` would
        first roll a checkpoint into the fleet (:meth:`reload`) and
        raises ``NotImplementedError`` as it does. ``grammar_resolver(key) -> GrammarFSM``
        rebuilds constrained requests' DFAs from their journaled spec
        key ``(pattern, vocab_size, eos_token_id)``; the default lowers
        through :func:`~.grammar.toy_tokenizer` (every test/bench
        tokenizer in-repo) — front doors with a real tokenizer supply
        their own.

        Replay is pure (replay twice ⇒ the same state) and re-admission
        is idempotent: each re-admitted incarnation journals a
        ``recover`` record superseding the old id, so a second
        :meth:`recover` — same process or the next one — finds nothing
        pending it doesn't already own. Per request the outcome is
        ``resumed`` (re-admitted through the journaled re-prefill path:
        prompt + committed tokens re-prefill, decode continues
        token-identically, emission resumes at the journaled seq),
        ``completed`` (journal already terminal — only the retire
        record was torn off the tail), ``expired`` (its deadline lapsed
        across the death, measured on the WALL clock from the original
        admission), or ``failed`` (no engine could adopt it) —
        ``paddle_tpu_wal_recovered_requests_total{outcome}`` counts
        each. A stream the log already retired is not re-admitted, but
        its journal becomes its replay history, so
        :meth:`attach_stream` gives a client the chunks the dead process
        committed and never emitted. Returns ``{old_wal_id: outcome
        dict}``."""
        if self._wal is None:
            if wal_dir is None:
                raise ValueError(
                    "no WAL armed: construct Router(wal_dir=...) or "
                    "pass recover(wal_dir=...)")
            self._wal = RequestWAL(wal_dir)
        if ckpt_dir is not None:
            self.reload(ckpt_dir)
        state = self._wal.replay()
        # rebuild the alias chain from PRIOR incarnations' recover
        # records, so a client holding a two-crashes-ago id still
        # resolves to the live stream
        for wr in state.requests.values():
            if wr.superseded_by is not None:
                self._wal_alias[wr.wal_id] = wr.superseded_by
        live_now = set(self._wal_ids.values())
        results: Dict[int, dict] = {}
        for wr in state.pending():
            if wr.wal_id in live_now:
                continue    # admitted by THIS process: nothing to do
            results[wr.wal_id] = self._recover_one(wr, grammar_resolver)
        # a stream retired in the log may not have reached its client:
        # the dead process committed its last tokens and retire record
        # before it emitted them (commit-then-emit). Its journal is its
        # replay history, so a client re-attaching after its cursor gets
        # the rest (the JAX router keeps no history for such a stream,
        # and the client never sees its tail)
        for wr in state.requests.values():
            if (wr.outcome is not None and wr.superseded_by is None
                    and wr.wal_id not in self._stream_hist):
                self._stream_hist[wr.wal_id] = (
                    [(i, t, None) for i, t in enumerate(wr.tokens)]
                    + [(len(wr.tokens), None, wr.outcome)])
        self._wal.commit()
        return results

    def _recover_one(self, wr: WalRequest,
                     grammar_resolver: Optional[Callable]) -> dict:
        """Re-admit ONE journaled request (see :meth:`recover`)."""
        toks = list(wr.tokens)
        done = None
        if wr.max_new_tokens and len(toks) >= wr.max_new_tokens:
            done = "length"
        elif (wr.eos_token_id is not None and toks
              and toks[-1] == int(wr.eos_token_id)):
            done = "stop"
        if done is not None:
            # the journal is already terminal — the crash tore away only
            # the retire record; close it out, no engine needed
            self._wal.append("retire", id=wr.wal_id, reason=done)
            self._stream_hist[wr.wal_id] = (
                [(i, t, None) for i, t in enumerate(toks)]
                + [(len(toks), None, done)])
            self._m_recovered.labels(outcome="completed").inc()
            return {"outcome": "completed", "finish_reason": done,
                    "tokens": toks, "wal_id": wr.wal_id, "rid": None}
        remaining = None
        if wr.deadline_s is not None:
            remaining = wr.deadline_s - max(
                0.0, time.time() - wr.admit_walltime)
            if remaining <= 0:
                self._wal.append("retire", id=wr.wal_id,
                                 reason="expired")
                self._stream_hist[wr.wal_id] = (
                    [(i, t, None) for i, t in enumerate(toks)]
                    + [(len(toks), None, "expired")])
                self._m_recovered.labels(outcome="expired").inc()
                return {"outcome": "expired", "tokens": toks,
                        "wal_id": wr.wal_id, "rid": None}
        try:
            grammar = None
            if wr.grammar_key is not None:
                if grammar_resolver is not None:
                    grammar = grammar_resolver(wr.grammar_key)
                else:
                    pattern, vocab, eos = wr.grammar_key
                    grammar = GrammarFSM.compile(
                        pattern, toy_tokenizer(vocab, eos))
            wid = self._wal.new_id()
            req = Request(
                prompt=np.asarray(wr.prompt, np.int32),
                max_new_tokens=wr.max_new_tokens,
                temperature=wr.temperature,
                eos_token_id=wr.eos_token_id, seed=wr.seed,
                stream_cb=self._durable_cb(wid),
                deadline_s=remaining, prefix_cache=wr.prefix_cache,
                priority=wr.priority, resume_tokens=toks,
                adapter_id=wr.adapter_id, grammar=grammar,
                resume_fsm_state=wr.fsm_state)
            target = self.select(wr.model, adapter_id=wr.adapter_id)
            target.engine.adopt_request(req)
        except Exception as e:
            # nothing on the restarted fleet can take it (model not
            # registered, adapter not loaded, grammar unbuildable, every
            # engine gated out): retire it deterministically in the LOG
            # — the caller sees "failed" + the tokens, never a silent
            # forever-pending record
            self._wal.append("retire", id=wr.wal_id,
                             reason="unavailable")
            self._m_recovered.labels(outcome="failed").inc()
            return {"outcome": "failed", "error": repr(e),
                    "tokens": toks, "wal_id": wr.wal_id, "rid": None}
        # adopted: supersede the old incarnation and journal the new one
        # WITH its carried journal — the next crash recovers from the
        # new record alone (original deadline fields ride along so
        # elapsed time is never double-counted across restarts)
        self._wal.append("recover", old=wr.wal_id, new=wid)
        payload = req.wal_admission(wid, model=wr.model,
                                    walltime=wr.admit_walltime,
                                    resume_from=wr.wal_id)
        payload["deadline_s"] = wr.deadline_s
        self._wal.append("admit", **payload)
        self._wal_ids[req.req_id] = wid
        self._wal_cursor[wid] = len(toks)
        self._wal_alias[wr.wal_id] = wid
        self._stream_hist[wid] = [(i, t, None)
                                  for i, t in enumerate(toks)]
        cb = self._client_cbs.pop(wr.wal_id, None)
        if cb is not None:
            self._client_cbs[wid] = cb
        self._count_dispatch(target)
        self._trace.emit("req.recover", req.req_id,
                         arg=float(len(toks)), label=target.engine_id)
        self._m_recovered.labels(outcome="resumed").inc()
        return {"outcome": "resumed", "rid": req.req_id, "wal_id": wid,
                "tokens": toks}

    def shutdown(self, drain: bool = True) -> Dict[object, RequestOutput]:
        """Graceful shutdown: drain the fleet, group-commit the last
        window, and SEAL the WAL (a ``seal`` record marks clean exit —
        the next process's :meth:`recover` finds nothing pending and no
        torn tail). ``drain=False`` skips the run-to-empty (commits and
        closes WITHOUT sealing, so pending work correctly reads as
        recoverable). Returns the final outputs; pair with
        :meth:`install_signal_handlers` for the SIGTERM →
        drain → seal → exit-0 path."""
        if drain:
            out = self.run()
        else:
            out = self.take_outputs()
        if self._wal is not None:
            self._wal_commit_and_flush()
            if not self.has_work:
                self._wal.seal()
            self._wal.close()
            self._wal = None
        return out

    def install_signal_handlers(self, signals=(_signal.SIGTERM,),
                                exit_on_shutdown: bool = True):
        """Arm SIGTERM (by default) to run :meth:`shutdown` — the
        serving twin of ``checkpoint.save_on_signal``, riding the SAME
        shared scope (:func:`paddle_tpu.faults.install_signal_handler`):
        training checkpoints-and-exits, serving drains-seals-and-exits,
        one signal path. Returns the scope (``uninstall()`` restores the
        previous handlers; also a context manager)."""
        def _handler(signum, frame):
            try:
                self.shutdown()
            finally:
                scope.uninstall()
            if exit_on_shutdown:
                import sys
                sys.exit(0)
        scope = faults.install_signal_handler(_handler, signals=signals)
        return scope

    # ------------------------------------------------------- manual gating
    def drain(self, engine_id: str) -> None:
        """Gate an engine out of admission (state ``draining``): waiting
        requests move to healthy siblings (exactly once), in-flight work
        keeps stepping to completion. ``undrain`` returns it."""
        h = self._require(engine_id)
        with self._lock:
            h.state = DRAINING
        self._set_state_gauge(h)
        self._requeue_waiting(h)

    def mark_down(self, engine_id: str) -> None:
        """Take an engine out NOW (state ``down``): waiting requests are
        requeued and in-flight requests MIGRATE by token journal (each
        exactly once — the adoptive engine continues every stream
        token-identically; unplaceable work retires ``"unavailable"``
        with its tokens so far), and the engine is no longer stepped
        until :meth:`undrain`. Never raises: every engine touch is
        guarded, so an engine that is already dead — its ``cancel``/
        ``step`` raising, its pool unusable — is still markable down."""
        h = self._require(engine_id)
        with self._lock:
            h.state = DOWN
        self._set_state_gauge(h)
        self._evacuate(h)

    def undrain(self, engine_id: str) -> None:
        """Return a drained/down engine to rotation (state ``healthy``;
        the next health refresh re-derives ``degraded`` if its watchdog
        is still tripped)."""
        h = self._require(engine_id)
        with self._lock:
            h.state = HEALTHY
        self._set_state_gauge(h)

    def _require(self, engine_id: str) -> EngineHandle:
        h = self._handles.get(str(engine_id))
        if h is None:
            raise KeyError(
                f"unknown engine id {engine_id!r} (known: "
                f"{sorted(self._handles)})")
        return h

    # -------------------------------------------------------------- reload
    def reload(self, checkpoint_dir: str, model: Optional[str] = None,
               step: Optional[int] = None,
               warm_prompt: Sequence[int] = (1,)) -> Dict[str, object]:
        """The JAX router's rolling weight push (drain an engine, restore
        a checkpoint into it in place, canary, return it to rotation).
        Not ported: it restores through the checkpoint manager, which
        the port does not have yet (ROADMAP, the checkpoint item).
        Raises ``NotImplementedError`` without touching the fleet."""
        raise NotImplementedError(
            "Router.reload (rolling weight push) waits for the port's "
            "checkpoint manager: see ROADMAP.md, Queue 1C, the "
            "checkpoint item")

    def _warm(self, h: EngineHandle, warm_prompt: Sequence[int],
              **canary_kwargs):
        """Canary decode: one tiny request end to end (prefill and one
        token) on ``h``'s engine, proving it produces finite logits.
        Extra kwargs ride the canary request — ``register_adapter``
        warms THROUGH the new adapter (``adapter_id=``). Returns (ok,
        finish_reason)."""
        eng = h.engine
        wid = eng.add_request(np.asarray(warm_prompt, np.int32),
                              max_new_tokens=1, **canary_kwargs)
        while eng.has_work:
            eng.step()
        outs = eng.take_outputs()
        warm = outs.pop(wid)
        if outs:  # real outputs scooped alongside the canary: hand back
            self._stash.update(outs)
        return warm.finish_reason in ("stop", "length"), warm.finish_reason

    # ------------------------------------------------------------- adapters
    def register_adapter(self, name: str, weights,
                         model: Optional[str] = None,
                         warm_prompt: Sequence[int] = (1,)
                         ) -> Dict[str, object]:
        """Hot-load LoRA adapter ``name`` onto EVERY non-down engine of
        ``model``, under live traffic: per engine, install the weights
        (a write into the adapter store's storage, which the captured
        step reads at its next replay — no capture, no dropped in-flight
        work, no drain) and prove them
        with a one-token canary routed THROUGH the adapter. A canary
        that retires abnormally rolls that engine's install back
        (unregister) and reports ``"error"`` — a bad adapter never
        enters rotation, and siblings that passed keep serving it.
        Returns a per-engine summary; after an all-ok push,
        ``select(adapter_id=name)`` sees the whole fleet."""
        mid = self._resolve_model(model)
        results: List[Dict[str, object]] = []
        for h in self._models[mid]:
            if h.state == DOWN:
                results.append({"engine_id": h.engine_id,
                                "result": "skipped-down"})
                continue
            try:
                h.engine.register_adapter(name, weights)
                canary_ok, reason = self._warm(h, warm_prompt,
                                               adapter_id=name)
            except Exception as e:
                self._m_adapter_loads.labels(result="error").inc()
                results.append({"engine_id": h.engine_id,
                                "result": "error", "error": repr(e)})
                continue
            if not canary_ok:
                # roll back: the adapter produced non-finite logits (or
                # the canary died) — this engine must not advertise it
                try:
                    h.engine.unregister_adapter(name)
                except Exception:
                    pass
                self._m_adapter_loads.labels(result="error").inc()
                results.append({"engine_id": h.engine_id,
                                "result": "error",
                                "canary_finish_reason": reason})
                continue
            self._m_adapter_loads.labels(result="ok").inc()
            results.append({"engine_id": h.engine_id, "result": "ok"})
        return {"adapter": name, "engines": results}

    def unregister_adapter(self, name: str,
                           model: Optional[str] = None) -> None:
        """Remove adapter ``name`` from every non-down engine of
        ``model``. Raises (before touching ANY engine) if a live request
        still uses it anywhere — drain the tenant first."""
        mid = self._resolve_model(model)
        ups = [h for h in self._models[mid] if h.state != DOWN]
        for h in ups:
            if h.engine.adapters.holds(name) \
                    and h.engine._adapter_in_use(name):
                raise ValueError(
                    f"adapter {name!r} is in use on engine "
                    f"{h.engine_id}; drain it before unregistering")
        for h in ups:
            if h.engine.adapters.holds(name):
                h.engine.unregister_adapter(name)

    # -------------------------------------------------------------- health
    @staticmethod
    def _engine_health_view(h: EngineHandle) -> Dict[str, object]:
        """``engine.health()`` guarded for the scrape thread: a raising
        probe reads as a non-ok status instead of 500-ing ``/healthz``.
        Containment (gate down + evacuate) stays the DRIVE thread's job
        — ``_refresh_health`` does it at the next ``router.step()``."""
        try:
            return dict(h.engine.health())
        except Exception as e:
            return {"status": f"probe-error: {e!r}"}

    def health(self, engine: Optional[str] = None) -> Dict[str, object]:
        """Aggregate (or per-engine, via ``engine=``) health view for
        ``MetricsServer(health_cb=router.health)``.

        Aggregate ``status`` is ``"ok"`` unless some served model has NO
        engine that is both router-healthy and watchdog-ok — one degraded
        replica keeps /healthz 200 (its siblings cover), a fully dark
        model flips 503. ``/healthz?engine=<id>`` routes here with
        ``engine=`` set; an unknown id reports non-ok and names the known
        ids."""
        # snapshot the topology under the lock: the scrape thread must
        # not iterate dicts the driver thread's add_model() is growing
        with self._lock:
            handles = list(self._handles.values())
            model_map = {mid: list(hs) for mid, hs in self._models.items()}
        if engine is not None:
            h = next((x for x in handles if x.engine_id == str(engine)),
                     None)
            if h is None:
                return {"status": "unknown-engine",
                        "engine": str(engine),
                        "known": sorted(x.engine_id for x in handles)}
            eh = self._engine_health_view(h)
            ok = h.state == HEALTHY and eh["status"] == "ok"
            return {"status": "ok" if ok else
                    (h.state if h.state != HEALTHY else "degraded"),
                    "state": h.state, "model": h.model_id,
                    "weights_step": h.weights_step,
                    "last_error": h.last_error, **{
                        k: v for k, v in eh.items() if k != "status"}}
        models: Dict[str, Dict[str, int]] = {}
        all_ok = True
        for mid, hs in model_map.items():
            healthy = sum(
                1 for h in hs if h.state == HEALTHY
                and self._engine_health_view(h)["status"] == "ok")
            models[mid] = {"healthy": healthy, "total": len(hs)}
            if healthy == 0:
                all_ok = False
        if self._last_health_ok and not all_ok:
            # the /healthz 200→503 transition (some model just went
            # fully dark): auto-dump the recorder exactly once per
            # transition, from whichever thread (driver or scrape)
            # observed it first
            try:
                self._trace.dump_flight(reason="healthz")
            except Exception:
                pass
        self._last_health_ok = all_ok
        return {"status": "ok" if all_ok else "degraded",
                "models": models,
                "engines": {h.engine_id: h.state for h in handles}}
