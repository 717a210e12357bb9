"""Continuous-batching LLM inference engine over the paged KV cache.

Counterpart of ``paddle_tpu/serving/engine.py`` (``ServingEngine``), its
main path. The engine keeps a fixed grid of ``max_batch_slots`` slots;
requests join and retire mid-decode. Each :meth:`ServingEngine.step`

1. **admits** waiting requests into free slots in (priority, arrival)
   order under the pool's worst-case page accounting (scheduler.py),
2. **plans** the step's token mix under ``token_budget``: decode tokens
   first, prompt chunks in the remainder,
3. runs **one unified ragged step**: every query token of the step,
   decode tokens and prompt-chunk tokens alike, is one row of a
   flattened ``[T]`` grid carrying its owner's block table and absolute
   position. The model writes each row's KV into the pool, then the
   ragged paged-attention kernel attends each row over its pages up to
   its own position. Only the rows that sample (one per slot) go through
   the vocab projection,
4. **retires** finished sequences (eos or max tokens), freeing their
   pages at once.

``T`` is bucketed as in the JAX package (the slot grid while the step fits
it, else the next power of two, at least 16); padding rows carry the null
block table and position 0, and their output is discarded.

Sampling: the token after position ``p`` is drawn with the key
``fold_in(PRNGKey(seed), p)`` (sampling.py), so a request's stream is a
pure function of (prompt, seed, temperature), independent of batch
composition and chunk boundaries, and equal to the JAX engine's.

The step runs eagerly, one kernel launch per layer for attention; there
is no prefix cache, speculation, adapters, grammar, host tier, metrics or
fault handling in this slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.paged_attention import ragged_paged_attention
from . import sampling
from .kv_cache import PagedKVCachePool
from .scheduler import FCFSScheduler, Request, RequestOutput

__all__ = ["ServingEngine"]

_MIN_GRID_TOKENS = 16


class _SeqState:
    """One live slot. ``ids`` is the prompt, ``pos`` counts tokens of KV
    in the pool (chunked-prefill progress is a cache length) and ``gen``
    the tokens sampled so far. While ``pos < len(ids)`` the slot feeds its
    next prompt chunk; the final chunk's sample is the first generated
    token. Then it decodes: ``last_token`` feeds back at ``pos``."""

    __slots__ = ("req", "ids", "pos", "last_token", "gen")

    def __init__(self, req: Request):
        self.req = req
        self.ids = req.prompt
        self.pos = 0
        self.last_token = -1
        self.gen: List[int] = []

    @property
    def prefilling(self) -> bool:
        return self.pos < self.ids.size


@dataclass
class _StepBatch:
    """One unified step's grid, planned on the host: ``rows`` are
    ``(slot, token ids, positions, is_chunk)``; the arrays are the grid
    (``tok``/``tok_pos`` ``[T]``, ``tok_bt`` ``[T, pages]``) and the
    per-slot sample rows and their sampling parameters (``[B]``)."""

    rows: list
    total: int
    tok: np.ndarray
    tok_pos: np.ndarray
    tok_bt: np.ndarray
    sample_rows: np.ndarray
    sample_pos: np.ndarray
    temps: np.ndarray
    seeds: np.ndarray
    n_decode: int


class ServingEngine:
    """Continuous-batching engine for ``LlamaForCausalLM``: paged KV pool
    + chunked-prefill scheduler + one unified ragged step per iteration.

    ``device`` defaults to ``cuda`` (``RuntimeError`` without a card
    unless ``device="cpu"``); the model must already live there.
    ``num_pages=None`` sizes the pool for ``max_batch_slots`` worst-case
    sequences of ``max_model_len`` tokens (+1 null page). ``kv_dtype`` is
    the page dtype (``torch.float32`` or ``torch.bfloat16``, or their
    names)."""

    def __init__(self, model, *, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_batch_slots: int = 8,
                 max_model_len: Optional[int] = None,
                 token_budget: int = 1024,
                 kv_dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        model.eval()
        self.trunk = model._decode_trunk()
        n_layers, n_kv, head_dim = model._cache_spec()
        self.n_layers = n_layers
        cfg_max = int(model.config.max_position_embeddings)
        self.max_model_len = min(int(max_model_len or cfg_max), cfg_max)
        self.page_size = int(page_size)
        self.max_batch_slots = int(max_batch_slots)
        self.token_budget = int(token_budget)
        self.pages_per_seq = -(-self.max_model_len // self.page_size)
        if num_pages is None:
            num_pages = self.max_batch_slots * self.pages_per_seq + 1
        self.pool = PagedKVCachePool(n_layers, num_pages, self.page_size,
                                     n_kv, head_dim, dtype=kv_dtype,
                                     device=self.device)
        self.scheduler = FCFSScheduler(self.max_batch_slots,
                                       self.token_budget)
        self.slots: List[Optional[_SeqState]] = [None] * self.max_batch_slots
        self._outputs: Dict[object, RequestOutput] = {}
        self.stats: Dict[str, float] = {
            "steps": 0, "generated_tokens": 0, "finished_requests": 0,
            "queue_depth": 0, "running_seqs": 0, "tokens_per_sec": 0.0,
            "page_utilization": 0.0, "peak_pages": 0,
            # the token mix of the last step (decode rows, prompt rows)
            "step_decode_tokens": 0, "step_prefill_tokens": 0,
        }

    # ------------------------------------------------------------ frontend
    def check_request(self, prompt_len: int, max_new_tokens: int) -> None:
        """Raise ValueError if a request of this shape could never be
        served, naming the limit it breaks."""
        p, m = int(prompt_len), int(max_new_tokens)
        if p > self.max_model_len:
            raise ValueError(
                f"prompt_len {p} exceeds the context window (limit: "
                f"max_model_len={self.max_model_len})")
        total = p + m
        if total > self.max_model_len:
            raise ValueError(
                f"prompt_len {p} + max_new_tokens {m} = {total} exceeds "
                f"the per-request token cap (limit: max_model_len="
                f"{self.max_model_len})")
        need = self.pool.pages_needed(total)
        if need > self.pool.usable_pages:
            raise ValueError(
                f"max_total_tokens {total} needs {need} KV pages but the "
                f"pool has only {self.pool.usable_pages} usable pages "
                f"(limit: num_pages={self.pool.num_pages})")

    def add_request(self, prompt, max_new_tokens: int = 32,
                    temperature: float = 0.0,
                    eos_token_id: Optional[int] = None, seed: int = 0,
                    stream_cb=None, priority: int = 0):
        """Queue a request; returns its ``req_id``. Generation starts at
        the next :meth:`step` with capacity."""
        req = Request(prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      eos_token_id=eos_token_id, seed=seed,
                      stream_cb=stream_cb, priority=priority)
        self.check_request(req.prompt.size, req.max_new_tokens)
        self.scheduler.add(req)
        return req.req_id

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.waiting) or any(
            s is not None for s in self.slots)

    def run(self) -> Dict[object, RequestOutput]:
        """Drive :meth:`step` until queue and slots drain; returns every
        request finished since the last call, keyed by ``req_id``."""
        while self.has_work:
            self.step()
        return self.take_outputs()

    def take_outputs(self) -> Dict[object, RequestOutput]:
        out, self._outputs = self._outputs, {}
        return out

    # ---------------------------------------------------------------- step
    def step(self) -> List[RequestOutput]:
        """One engine iteration: admit, one unified ragged step, retire.
        Returns the requests that finished in it."""
        t0 = time.perf_counter()
        tokens_before = self.stats["generated_tokens"]
        free = sum(1 for s in self.slots if s is None)
        for req in self.scheduler.admit(free, self.pool):
            self._admit(req)
        finished: List[RequestOutput] = []
        self.stats["step_decode_tokens"] = 0
        self.stats["step_prefill_tokens"] = 0
        batch = self._plan()
        if batch is not None:
            logits = self._forward(batch)
            nxt = sampling.sample(logits, batch.temps, batch.seeds,
                                  batch.sample_pos)
            finished.extend(self._land(batch, nxt.cpu().numpy()))
        dt = time.perf_counter() - t0
        self.stats["steps"] += 1
        self.stats["queue_depth"] = self.scheduler.queue_depth
        self.stats["running_seqs"] = sum(1 for s in self.slots
                                         if s is not None)
        produced = self.stats["generated_tokens"] - tokens_before
        self.stats["tokens_per_sec"] = produced / dt if dt > 0.0 else 0.0
        self.stats["page_utilization"] = self.pool.utilization()
        self.stats["peak_pages"] = self.pool.peak_used
        return finished

    def _admit(self, req: Request) -> None:
        """Park a request in a free slot with its worst-case reservation;
        its prefill runs inside the next steps, in chunks."""
        self.pool.allocate(req.req_id, 0,
                           max_total_tokens=req.max_total_tokens)
        self.slots[self.slots.index(None)] = _SeqState(req)

    def _grid_tokens(self, total: int) -> int:
        """Token-grid bucket: the slot grid while the step fits it, else
        the next power of two, at least 16."""
        if total <= self.max_batch_slots:
            return self.max_batch_slots
        return max(_MIN_GRID_TOKENS, 1 << (int(total) - 1).bit_length())

    def _plan(self) -> Optional[_StepBatch]:
        """Decide this step's rows and reserve their KV room: one row per
        decoding slot, then prompt chunks under the budget; lay them out
        on the token grid."""
        B = self.max_batch_slots
        decode_idx: List[int] = []
        prefill_info = []
        for i, st in enumerate(self.slots):
            if st is None:
                continue
            if st.prefilling:
                prefill_info.append((i, int(st.ids.size) - st.pos, st.req))
            else:
                decode_idx.append(i)
        chunks = self.scheduler.plan_chunks(len(decode_idx), prefill_info)
        rows = []
        for i in decode_idx:
            st = self.slots[i]
            self.pool.extend(st.req.req_id, st.pos + 1)
            rows.append((i, np.asarray([st.last_token], np.int32),
                         np.asarray([st.pos], np.int32), False))
        for i, c in chunks:
            st = self.slots[i]
            self.pool.extend_write(st.req.req_id, st.pos, st.pos + c)
            rows.append((i, st.ids[st.pos:st.pos + c],
                         np.arange(st.pos, st.pos + c, dtype=np.int32),
                         True))
        if not rows:
            return None
        total = sum(r[1].size for r in rows)
        T = self._grid_tokens(total)
        tok = np.zeros(T, np.int32)
        tok_pos = np.zeros(T, np.int32)
        tok_bt = np.zeros((T, self.pages_per_seq), np.int32)
        sample_rows = np.zeros(B, np.int32)
        sample_pos = np.zeros(B, np.int32)
        temps = np.zeros(B, np.float32)
        seeds = np.zeros(B, np.int32)
        cur = 0
        for i, toks, poss, _is_chunk in rows:
            st = self.slots[i]
            c = toks.size
            tok[cur:cur + c] = toks
            tok_pos[cur:cur + c] = poss
            table = self.pool.block_table(st.req.req_id)
            tok_bt[cur:cur + c, :len(table)] = table
            # a slot samples from its last row: its decode token, or the
            # chunk's final token (kept only when the prompt is done)
            sample_rows[i] = cur + c - 1
            sample_pos[i] = int(poss[-1])
            temps[i] = st.req.temperature
            seeds[i] = st.req.seed
            cur += c
        n_decode = len(decode_idx)
        self.stats["step_decode_tokens"] = n_decode
        self.stats["step_prefill_tokens"] = total - n_decode
        return _StepBatch(rows, total, tok, tok_pos, tok_bt, sample_rows,
                          sample_pos, temps, seeds, n_decode)

    @torch.no_grad()
    def _forward(self, batch: _StepBatch,
                 attention=ragged_paged_attention) -> torch.Tensor:
        """The unified step on the device: the trunk over every grid row
        (KV written into the pool in place), then the vocab head over the
        per-slot sample rows only. Returns ``[B, V]`` f32 logits."""
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev, non_blocking=True)

        hidden = self.trunk.forward_paged(
            put(batch.tok), put(batch.tok_pos), put(batch.tok_bt),
            self.pool.layer_caches(), attention=attention)
        last_h = hidden[put(batch.sample_rows).to(torch.int64)]
        return self.model.logits(last_h).to(torch.float32)

    def _land(self, batch: _StepBatch, nxt: np.ndarray
              ) -> List[RequestOutput]:
        """Advance every row's slot by what the step computed and land the
        sampled tokens of slots that finished their prompt or decoded."""
        finished: List[RequestOutput] = []
        for i, toks, _poss, is_chunk in batch.rows:
            st = self.slots[i]
            st.pos += toks.size
            if is_chunk and st.prefilling:
                continue  # mid-prompt: more chunks to go, no token
            out = self._land_token(st, slot=i, token=int(nxt[i]))
            if out is not None:
                finished.append(out)
        return finished

    def _land_token(self, st: _SeqState, slot: int,
                    token: int) -> Optional[RequestOutput]:
        """Append a sampled token, stream it, and retire on eos/length."""
        st.last_token = token
        st.gen.append(token)
        self.stats["generated_tokens"] += 1
        if st.req.stream_cb is not None:
            st.req.stream_cb(st.req.req_id, token, False)
        return self._maybe_retire(st, slot=slot)

    # -------------------------------------------------------------- retire
    def _maybe_retire(self, st: _SeqState,
                      slot: int) -> Optional[RequestOutput]:
        req = st.req
        hit_eos = (req.eos_token_id is not None
                   and st.last_token == req.eos_token_id)
        if not hit_eos and len(st.gen) < req.max_new_tokens:
            return None
        self.pool.free(req.req_id)
        self.slots[slot] = None
        self.stats["finished_requests"] += 1
        out = RequestOutput(req_id=req.req_id, prompt_token_ids=req.prompt,
                            token_ids=list(st.gen),
                            finish_reason="stop" if hit_eos else "length")
        self._outputs[out.req_id] = out
        if req.stream_cb is not None:
            req.stream_cb(req.req_id, None, out.finish_reason)
        return out
