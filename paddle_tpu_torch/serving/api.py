"""An OpenAI-shaped completion front door over one engine or a router.

Counterpart of ``paddle_tpu/serving/api.py``: an in-process API whose
payloads mirror the OpenAI completions surface (``id``, ``object:
"text_completion"``, ``choices[].finish_reason``, ``usage``), with
per-request streaming callbacks (the SSE chunk analogue).

:class:`CompletionAPI` fronts one :class:`~.engine.ServingEngine` or a
:class:`~.router.Router` fleet: with a router, ``create_completion(
model=...)`` routes by model id (a Llama fleet beside a GPT engine, say)
through least-loaded dispatch and health gates, and drives the whole
fleet, so a request moved off a draining engine still delivers here.
Token ids in, token ids out (``detokenize=`` fills ``text``).
``adapter_id=`` selects a LoRA tenant (routed only to engines holding
it); ``grammar=`` constrains every choice to a compiled
:class:`~.grammar.GrammarFSM`.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from .. import faults, metrics
from .engine import ServingEngine
from .router import NoHealthyEngineError, Router

__all__ = ["CompletionAPI"]

_cmpl_counter = itertools.count()


class CompletionAPI:
    """OpenAI-completions-shaped facade over one :class:`ServingEngine`
    or a :class:`Router` fleet (pass either as ``backend``)."""

    def __init__(self, backend, model_name: str = "paddle-tpu",
                 detokenize: Optional[Callable[[Sequence[int]], str]] = None):
        if isinstance(backend, Router):
            self.router: Optional[Router] = backend
            self.engine: Optional[ServingEngine] = None
        else:
            self.router = None
            self.engine = backend
        self.model_name = model_name
        self.detokenize = detokenize
        reg = metrics.get_registry()
        self._m_completions = reg.counter(
            "paddle_tpu_serving_completions_total",
            "create_completion calls by outcome", labels=("status",))
        self._m_latency = reg.histogram(
            "paddle_tpu_serving_completion_seconds",
            "Whole create_completion latency: queue + prefill + decode "
            "to the last choice finishing")

    def _route(self, model: Optional[str],
               adapter_id: Optional[str] = None):
        """(engine, handle, response_model_name) for this completion."""
        if self.router is not None:
            # ValueError on unknown id; tenancy is (model, adapter) —
            # only engines holding the adapter are candidates
            handle = self.router.select(model, adapter_id=adapter_id)
            # echo the tenant the caller named; the display name covers
            # the single-model default (same as the engine-backed path)
            return handle.engine, handle, (model if model is not None
                                           else self.model_name)
        if model is not None and model != self.model_name:
            raise ValueError(
                f"unknown model id {model!r} (this CompletionAPI serves "
                f"only {self.model_name!r}); front a Router to serve "
                f"several models")
        return self.engine, None, self.model_name

    def create_completion(self, prompt, max_tokens: int = 16,
                          temperature: float = 0.0,
                          stop_token_id: Optional[int] = None,
                          seed: int = 0, echo: bool = False,
                          stream_cb: Optional[Callable] = None,
                          deadline_s: Optional[float] = None,
                          model: Optional[str] = None,
                          prefix_cache: bool = True,
                          priority: int = 0,
                          adapter_id: Optional[str] = None,
                          grammar=None,
                          resume_after_seq=None) -> dict:
        """Run one or more prompts to completion and return an OpenAI-ish
        response dict. ``prompt`` is a token-id list or a batch of them
        (one ``choices`` entry each, continuous-batched through the
        engine). ``stream_cb(chunk)`` receives OpenAI-chunk-shaped dicts
        as tokens land. Each batch-mate's first token samples from its
        own stream (``seed + index``), so n-best sampling of one prompt
        diverges instead of returning n identical choices. ``deadline_s``
        bounds each choice from enqueue; an expired one comes back with
        ``finish_reason="timeout"`` and whatever tokens it produced.
        ``model=`` selects the tenant on a Router backend (batch-mates
        stay on one engine so they continuous-batch together); unknown
        ids raise an actionable ValueError, a fully gated-out model
        raises :class:`NoHealthyEngineError`. ``prefix_cache=False``
        opts every choice of this call out of the engine's prompt
        prefix cache: full prefill
        from token 0, no page sharing — for prompts that must not be
        indexed (privacy) or A/B-measuring the cache itself.
        ``priority`` is the request's SLO tier (lower = more urgent,
        0 default): it orders admission and prompt-chunk scheduling on
        the engine, so a latency-tier tenant's prompt chunks preempt a batch tier's
        under a contended token budget. ``adapter_id`` names a LoRA
        adapter every choice decodes through (on a Router backend,
        placement narrows to engines holding it); ``grammar`` is a
        compiled :class:`~.grammar.GrammarFSM` constraining every
        choice's tokens.
        ``resume_after_seq`` is the reconnect half of the exactly-once
        streaming contract: a client
        that saw chunks through seq N before losing its connection
        passes ``resume_after_seq=N`` (an int for every choice, or one
        per choice) and ``stream_cb`` receives only chunks with
        ``seq > N`` — re-submitted deterministic requests (same prompt/
        seed/temperature) regenerate identical tokens, so the suppressed
        prefix is exactly what the client already holds."""
        t0 = time.perf_counter()
        prompts = self._as_batch(prompt)
        try:
            engine, handle, resp_model = self._route(model, adapter_id)
        except (ValueError, NoHealthyEngineError):
            self._m_completions.labels(status="rejected").inc()
            raise
        # validate the WHOLE batch before queueing anything: a rejected
        # later prompt must not strand already-queued batch-mates
        try:
            for p in prompts:
                engine.check_request(p.size, max_tokens)
        except ValueError:
            self._m_completions.labels(status="rejected").inc()
            raise
        cid = f"cmpl-{next(_cmpl_counter)}"
        req_ids = []
        try:
            for idx, p in enumerate(prompts):
                cb = None
                if stream_cb is not None:
                    after = -1
                    if resume_after_seq is not None:
                        after = int(
                            resume_after_seq[idx]
                            if isinstance(resume_after_seq,
                                          (list, tuple, np.ndarray))
                            else resume_after_seq)
                    cb = self._chunk_cb(stream_cb, cid, idx, resp_model,
                                        after_seq=after)
                req_ids.append(engine.add_request(
                    p, max_new_tokens=max_tokens, temperature=temperature,
                    eos_token_id=stop_token_id, seed=seed + idx,
                    stream_cb=cb, deadline_s=deadline_s,
                    prefix_cache=prefix_cache, priority=priority,
                    adapter_id=adapter_id, grammar=grammar))
                if handle is not None:
                    self.router._count_dispatch(handle)
        except Exception:
            # enqueue failed mid-batch (bounded queue filled, or a
            # Request invariant check_request can't see, e.g. an empty
            # prompt): silently un-queue the mates already added — from
            # the caller's perspective this call was never accepted, so
            # no cancelled counters, no terminal stream chunks, no
            # orphans running under the next create_completion
            for rid in req_ids:
                engine.scheduler.remove(rid)
            self._m_completions.labels(status="rejected").inc()
            raise
        if self.router is not None:
            # drive the FLEET: a health-gated drain may move our queued
            # requests to a sibling mid-flight, and their outputs then
            # come from that engine; outputs we don't own go back
            all_outputs = self.router.run()
            ours = set(req_ids)
            outputs = {k: v for k, v in all_outputs.items() if k in ours}
            unclaimed = {k: v for k, v in all_outputs.items()
                         if k not in ours}
            if unclaimed:
                self.router.stash_unclaimed(unclaimed)
        else:
            outputs = engine.run()
        choices = []
        usage_p = usage_c = 0
        for idx, rid in enumerate(req_ids):
            out = outputs[rid]
            ids = list(out.token_ids)
            full = (list(map(int, out.prompt_token_ids)) + ids
                    if echo else ids)
            choices.append({
                "index": idx,
                "token_ids": full,
                "text": (self.detokenize(full)
                         if self.detokenize is not None else None),
                # pass the engine's reason straight through — the
                # resilience reasons ("timeout"/"cancelled"/"nan"/
                # "error"/"unavailable") must not
                # be masked as a normal "length" stop
                "finish_reason": out.finish_reason,
            })
            usage_p += int(out.prompt_token_ids.size)
            usage_c += out.n_gen
        self._m_completions.labels(status="ok").inc()
        self._m_latency.observe(time.perf_counter() - t0)
        return {
            "id": cid,
            "object": "text_completion",
            "created": int(time.time()),
            "model": resp_model,
            "choices": choices,
            "usage": {"prompt_tokens": usage_p,
                      "completion_tokens": usage_c,
                      "total_tokens": usage_p + usage_c},
        }

    def _chunk_cb(self, stream_cb, cid, idx, model_name,
                  after_seq: int = -1):
        def cb(req_id, token, finished, seq):
            if int(seq) <= after_seq:
                # reconnect resume: the client already holds this chunk
                # (resume_after_seq cursor) — suppressing it here keeps
                # delivery exactly-once without the engine knowing
                return
            # the engine's terminal callback passes the finish reason
            # as `finished`, so streamed chunks
            # agree with the final response's choices[].finish_reason —
            # and carry the same routed model name as the final response.
            # `seq` is the engine's per-request monotone token sequence
            # number (token chunks: 0-based generated index; terminal
            # chunk: total tokens emitted): after an in-flight migration
            # the adoptive engine resumes at the journaled seq, so a
            # client can VERIFY it saw every token exactly once.
            try:
                stream_cb({
                    "id": cid,
                    "object": "text_completion.chunk",
                    "model": model_name,
                    "choices": [{
                        "index": idx,
                        "token_id": None if token is None else int(token),
                        "seq": int(seq),
                        "finish_reason": finished or None,
                    }],
                })
            except Exception as e:
                # a raising USER callback must never abort the engine
                # step its batch-mates are riding: normalize to
                # CallbackError (original chained) — the engine's
                # callback isolation records it and retires THIS request
                # with finish_reason="error"
                raise faults.CallbackError(
                    f"stream_cb raised for {cid} choice {idx}") from e

        return cb

    @staticmethod
    def _as_batch(prompt) -> List[np.ndarray]:
        if isinstance(prompt, (list, tuple)):
            if not prompt:
                raise ValueError("empty prompt batch")
            if np.ndim(prompt[0]) == 0:  # flat token-id list
                return [np.asarray(prompt, np.int32)]
            # ragged batch: one choices entry per prompt
            return [np.asarray(p, np.int32).reshape(-1) for p in prompt]
        arr = np.asarray(prompt)
        if arr.ndim == 1:
            return [arr.astype(np.int32)]
        if arr.ndim == 2:
            return [row.astype(np.int32) for row in arr]
        raise ValueError(f"prompt rank {arr.ndim} unsupported")
