"""Chunked-prefill scheduler: priority admission + a shared token budget.

Counterpart of ``paddle_tpu/serving/scheduler.py`` (``Request``,
``RequestOutput``, ``FCFSScheduler``), without its metrics, faults,
deadlines and brownout caps. Three decisions per engine step:

**Admission** (:meth:`FCFSScheduler.admit`): waiting requests enter free
batch slots in (priority, arrival) order while a slot is free and the KV
pool covers the request's worst case (prompt + max_new_tokens) on top of
every live reservation, less the pages the prefix cache already holds
for its prompt. Prompt length does not gate admission: a long prompt
admits at once and prefills in chunks.

**Chunking** (:meth:`FCFSScheduler.plan_chunks`): each step has a fixed
``token_budget``. Decode tokens are charged first, so a running stream's
next token is never displaced by prompt work, and mid-prefill slots
split the remainder in (priority, arrival) order.

**Drafts** (:meth:`FCFSScheduler.plan_drafts`): speculative draft rows
take only what the budget leaves after decode tokens and chunks, in the
same order.

**Offload victims** (:meth:`FCFSScheduler.offload_victims`): when the
queue head cannot admit for pages, which live streams the engine may park
on the host page tier: strictly lower-priority ones, coldest first.

Head-of-line: if the head request does not fit the pool, nothing behind
it is admitted.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Request", "RequestOutput", "FCFSScheduler"]

_req_counter = itertools.count()


@dataclass
class Request:
    """One generation request (the engine's admission unit)."""

    prompt: np.ndarray  # [S] int32 token ids
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    seed: int = 0
    # called with (req_id, token_id, finished) as each token lands;
    # finished is False per token, and the terminal call passes token=None
    # and the finish reason ("stop" | "length") as finished
    stream_cb: Optional[Callable] = None
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

    @property
    def max_total_tokens(self) -> int:
        return int(self.prompt.size) + int(self.max_new_tokens)


@dataclass
class RequestOutput:
    """Terminal state of a request."""

    req_id: object
    prompt_token_ids: np.ndarray
    token_ids: List[int]            # generated tokens (incl. eos if hit)
    finish_reason: str              # "stop" (eos) | "length"
    n_gen: int = 0

    def __post_init__(self):
        self.n_gen = len(self.token_ids)


class FCFSScheduler:
    """Priority-tiered waiting queue + per-step admission + chunk planning
    (policy only: slots and pages stay with the engine and the pool).
    Within one priority tier the order is first-come-first-served."""

    def __init__(self, max_batch_slots: int, token_budget: int = 1024):
        if max_batch_slots < 1:
            raise ValueError("max_batch_slots must be >= 1")
        if token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        self.max_batch_slots = int(max_batch_slots)
        self.token_budget = int(token_budget)
        self.waiting: deque = deque()

    def add(self, request: Request) -> None:
        """Queue a request in (priority, arrival) order."""
        idx = len(self.waiting)
        while idx > 0 and self.waiting[idx - 1].priority > request.priority:
            idx -= 1
        self.waiting.insert(idx, request)

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
            admitted.append(req)
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
        left in (priority, arrival) order. Returns ``[(key, chunk)]``,
        chunks >= 1, in service order."""
        left = max(self.token_budget - int(n_decode), 0)
        plan: List[Tuple[object, int]] = []
        order = sorted(prefills, key=lambda e: (e[2].priority,
                                                e[2].arrival_t))
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
        ``[(key, max_draft_tokens, request)]``, served in (priority,
        arrival) order. Returns ``[(key, granted)]``, granted >= 1."""
        left = max(int(leftover), 0)
        plan: List[Tuple[object, int]] = []
        if left <= 0 or not wants:
            return plan
        order = sorted(wants, key=lambda e: (e[2].priority, e[2].arrival_t))
        for key, want, _req in order:
            if left <= 0:
                break
            d = min(int(want), left)
            if d <= 0:
                continue
            plan.append((key, d))
            left -= d
        return plan
