"""Chunked-prefill scheduler: priority admission + a shared token budget.

Counterpart of ``paddle_tpu/serving/scheduler.py`` (``Request``,
``RequestOutput``, ``FCFSScheduler``, ``BackpressureError``), without
the brownout caps and the migration journal. Three decisions per engine
step:

**Admission** (:meth:`FCFSScheduler.admit`): waiting requests enter free
batch slots in (priority, arrival) order while a slot is free and the KV
pool covers the request's worst case (prompt + max_new_tokens) on top of
every live reservation, less the pages the prefix cache already holds
for its prompt. Prompt length does not gate admission: a long prompt
admits at once and prefills in chunks.

**Chunking** (:meth:`FCFSScheduler.plan_chunks`): each step has a fixed
``token_budget``. Decode tokens are charged first, so a running stream's
next token is never displaced by prompt work, and mid-prefill slots
split the remainder in SLO order: priority, then earliest deadline,
then arrival.

**Drafts** (:meth:`FCFSScheduler.plan_drafts`): speculative draft rows
take only what the budget leaves after decode tokens and chunks, in the
same order.

**Deadlines and backpressure**: a request's ``deadline_s`` becomes a
:class:`~paddle_tpu_torch.faults.Deadline` running from enqueue;
:meth:`FCFSScheduler.pop_expired` pulls the lapsed ones out of the queue
for the engine to retire. With ``max_queue`` set, :meth:`FCFSScheduler.add`
rejects past that depth with :class:`BackpressureError`, whose
``retry_after_s`` comes from the engine's drain estimate.

**Offload victims** (:meth:`FCFSScheduler.offload_victims`): when the
queue head cannot admit for pages, which live streams the engine may park
on the host page tier: strictly lower-priority ones, coldest first.

Head-of-line: if the head request does not fit the pool, nothing behind
it is admitted.
"""
from __future__ import annotations

import itertools
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .. import faults, metrics

__all__ = ["BackpressureError", "Request", "RequestOutput", "FCFSScheduler"]


class BackpressureError(RuntimeError):
    """The scheduler queue is full: the request was rejected, not queued.

    ``retry_after_s`` is the engine's drain-rate estimate of when a slot
    is likely to open (an HTTP front door maps it onto ``429`` and
    ``Retry-After``); ``queue_depth`` the depth that refused it."""

    def __init__(self, message: str, retry_after_s: float,
                 queue_depth: int):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.queue_depth = int(queue_depth)


_req_counter = itertools.count()


@dataclass
class Request:
    """One generation request (the engine's admission unit)."""

    prompt: np.ndarray  # [S] int32 token ids
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    seed: int = 0
    # called with (req_id, token_id, finished) as each token lands, and a
    # fourth argument, the request's token sequence number, when the
    # callback asks for it; finished is False per token, and the terminal
    # call passes token=None and the finish reason as finished
    stream_cb: Optional[Callable] = None
    # seconds from enqueue until the engine retires the request (queued:
    # "expired", admitted: "timeout"); None is no deadline
    deadline_s: Optional[float] = None
    # lower is more urgent; honoured at admission and at chunking
    priority: int = 0
    # False opts this request out of prefix-cache matching and insertion
    # (under the engine's prefix_cache= flag)
    prefix_cache: bool = True
    # the NAME of the LoRA adapter this request decodes under, or None for
    # the base model (slot 0, the zero-delta identity); the engine
    # resolves it against its AdapterStore at admission
    adapter_id: Optional[str] = None
    # a compiled grammar.GrammarFSM constraining every sampled token, or
    # None for free text
    grammar: Optional[object] = None
    # the grammar's local DFA state to resume from (None: its start)
    resume_fsm_state: Optional[int] = None
    req_id: object = field(default_factory=lambda: next(_req_counter))
    arrival_t: float = field(default_factory=time.perf_counter)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        # canonicalise the seed into int32 range (keep the low 32 bits):
        # the step stages seeds as int32, and the sampling key of a wide
        # seed must be the key of its canonical value
        s = int(self.seed) & 0xFFFFFFFF
        self.seed = s - (1 << 32) if s >= (1 << 31) else s
        self.priority = int(self.priority)
        if self.adapter_id is not None and not isinstance(self.adapter_id,
                                                          str):
            raise ValueError("adapter_id must be a registered adapter "
                             "NAME (str) or None for the base model")
        if self.grammar is not None and not hasattr(self.grammar,
                                                    "mask_table"):
            raise ValueError(
                "grammar must be a compiled serving.grammar.GrammarFSM "
                "(use GrammarFSM.compile(pattern, tokenizer))")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
        # the clock starts at enqueue, as TTFT's: queue wait burns budget
        self.deadline = (faults.Deadline(self.deadline_s)
                         if self.deadline_s is not None else None)

    @property
    def max_total_tokens(self) -> int:
        return int(self.prompt.size) + int(self.max_new_tokens)


@dataclass
class RequestOutput:
    """Terminal state of a request."""

    req_id: object
    prompt_token_ids: np.ndarray
    token_ids: List[int]            # generated tokens (incl. eos if hit)
    # "stop" (eos or a finished grammar) | "length" | "timeout" |
    # "expired" (deadline lapsed while queued) | "cancelled" | "nan"
    # (quarantined) | "error"
    finish_reason: str
    n_gen: int = 0
    error: Optional[str] = None     # the diagnostic of an "error"

    def __post_init__(self):
        self.n_gen = len(self.token_ids)


class FCFSScheduler:
    """Priority-tiered waiting queue + per-step admission + chunk planning
    (policy only: slots and pages stay with the engine and the pool).
    Within one priority tier the order is first-come-first-served.
    ``max_queue`` bounds the queue (``None``: unbounded);
    ``retry_after_cb`` gives the backpressure hint (the engine installs
    its drain estimate)."""

    def __init__(self, max_batch_slots: int, token_budget: int = 1024,
                 max_queue: Optional[int] = None,
                 retry_after_cb: Optional[Callable[[], float]] = None):
        if max_batch_slots < 1:
            raise ValueError("max_batch_slots must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None: unbounded)")
        if token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        self.max_batch_slots = int(max_batch_slots)
        self.token_budget = int(token_budget)
        self.max_queue = None if max_queue is None else int(max_queue)
        self._retry_after_cb = retry_after_cb
        self.waiting: deque = deque()
        # queued requests with a deadline: pop_expired is free without
        self._n_deadlined = 0
        reg = metrics.get_registry()
        self._m_queue_wait = reg.histogram(
            "paddle_tpu_serving_queue_wait_seconds",
            "Time a request waits in the FCFS queue before admission")
        self._m_rejections = reg.counter(
            "paddle_tpu_serving_queue_rejections_total",
            "Requests rejected at enqueue because the bounded queue was "
            "full (BackpressureError)")

    def _retry_after(self) -> float:
        if self._retry_after_cb is not None:
            return max(float(self._retry_after_cb()), 0.0)
        return max(0.05, 0.1 * len(self.waiting) / self.max_batch_slots)

    def add(self, request: Request) -> None:
        """Queue a request in (priority, arrival) order, or raise
        :class:`BackpressureError` when the bounded queue is full
        (priority does not bypass it)."""
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            self._m_rejections.inc()
            hint = self._retry_after()
            raise BackpressureError(
                f"scheduler queue full ({len(self.waiting)}/{self.max_queue}"
                f" waiting, limit: max_queue={self.max_queue}); retry in "
                f"~{hint:.3f}s", retry_after_s=hint,
                queue_depth=len(self.waiting))
        idx = len(self.waiting)
        while idx > 0 and self.waiting[idx - 1].priority > request.priority:
            idx -= 1
        self.waiting.insert(idx, request)
        if request.deadline is not None:
            self._n_deadlined += 1

    def pop_expired(self) -> List[Request]:
        """Pull every deadline-expired request out of the queue in one
        pass; free when nothing queued carries a deadline."""
        if self._n_deadlined == 0:
            return []
        expired: List[Request] = []
        alive: deque = deque()
        for r in self.waiting:
            if r.deadline is not None and r.deadline.expired():
                expired.append(r)
            else:
                alive.append(r)
        self.waiting = alive
        self._n_deadlined -= len(expired)
        return expired

    def remove(self, req_id) -> Optional[Request]:
        """Pull a waiting request out of the queue (cancellation); None
        if it is not queued."""
        # by index: dataclass equality would compare prompt arrays
        for i, r in enumerate(self.waiting):
            if r.req_id == req_id:
                del self.waiting[i]
                if r.deadline is not None:
                    self._n_deadlined -= 1
                return r
        return None

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    def admit(self, free_slots: int, pool) -> List[Request]:
        """Pop the (priority, arrival)-ordered prefix that fits this step:
        free slots and worst-case page reservations, charging the pages
        of requests admitted earlier in the same call. Pages the prefix
        cache holds for a prompt join its table by refcount, so they are
        discounted, and taken off the reclaimable side for later
        batch-mates."""
        admitted: List[Request] = []
        pending_pages = 0
        pending_cached = 0
        while self.waiting and free_slots > 0:
            req = self.waiting[0]
            matched = (pool.prefix_match_len(req.prompt)
                       if req.prefix_cache else 0)
            cached_pages = matched // pool.page_size
            if not pool.can_admit(req.max_total_tokens, pending_pages,
                                  cached_pages=cached_pages,
                                  pending_cached=pending_cached):
                break  # head-of-line blocks: no overtaking
            self.waiting.popleft()
            if req.deadline is not None:
                self._n_deadlined -= 1
            admitted.append(req)
            self._m_queue_wait.observe(time.perf_counter() - req.arrival_t)
            pending_pages += (pool.pages_needed(req.max_total_tokens)
                              - cached_pages)
            pending_cached += cached_pages
            free_slots -= 1
        return admitted
    @staticmethod
    def offload_victims(head: Request,
                        candidates: Sequence[Tuple[float, object, Request]]
                        ) -> List[object]:
        """Which live slots may be parked on the host page tier so the
        blocked queue ``head`` can admit: ``candidates`` is
        ``[(last_active_t, key, request)]``; returns the keys in park
        order. Only strictly lower-priority tenants (a tie never thrashes
        two equal streams), the coldest (oldest ``last_active_t``)
        first."""
        eligible = [c for c in candidates if c[2].priority > head.priority]
        eligible.sort(key=lambda c: c[0])
        return [c[1] for c in eligible]

    def plan_chunks(self, n_decode: int,
                    prefills: Sequence[Tuple[object, int, Request]]
                    ) -> List[Tuple[object, int]]:
        """Slice this step's prompt work under the token budget:
        ``n_decode`` decode tokens are charged first, then mid-prefill
        slots ``[(key, remaining_prompt_tokens, request)]`` take what is
        left in SLO order (:func:`_slo_key`). Returns ``[(key, chunk)]``,
        chunks >= 1, in service order."""
        left = max(self.token_budget - int(n_decode), 0)
        plan: List[Tuple[object, int]] = []
        order = sorted(prefills, key=_slo_key)
        for key, remaining, _req in order:
            if left <= 0:
                break
            chunk = min(int(remaining), left)
            if chunk > 0:
                plan.append((key, chunk))
                left -= chunk
        return plan

    def plan_drafts(self, leftover: int,
                    wants: Sequence[Tuple[object, int, Request]]
                    ) -> List[Tuple[object, int]]:
        """Share the budget this step leaves after decode tokens and
        chunks (``leftover``) among speculative drafts: ``wants`` is
        ``[(key, max_draft_tokens, request)]``, served in SLO order.
        Returns ``[(key, granted)]``, granted >= 1."""
        left = max(int(leftover), 0)
        plan: List[Tuple[object, int]] = []
        if left <= 0 or not wants:
            return plan
        order = sorted(wants, key=_slo_key)
        for key, want, _req in order:
            if left <= 0:
                break
            d = min(int(want), left)
            if d <= 0:
                continue
            plan.append((key, d))
            left -= d
        return plan


def _slo_key(entry) -> tuple:
    """SLO order of a ``(key, n, request)`` entry: priority tier, then
    earliest deadline (a request without one last), then arrival."""
    req = entry[2]
    return (req.priority,
            req.deadline.remaining() if req.deadline is not None
            else math.inf, req.arrival_t)
