"""Continuous-batching LLM inference engine over the paged KV cache.

Counterpart of ``paddle_tpu/serving/engine.py`` (``ServingEngine``), its
main path. The engine keeps a fixed grid of ``max_batch_slots`` slots;
requests join and retire mid-decode. Each :meth:`ServingEngine.step`

1. **admits** waiting requests into free slots in (priority, arrival)
   order under the pool's worst-case page accounting (scheduler.py); a
   prompt whose leading full pages the radix prefix cache holds adopts
   those pages by refcount and prefills only the rest,
2. **plans** the step's token mix under ``token_budget``: decode tokens
   first, prompt chunks in the remainder, speculative draft rows in what
   is left (``spec_k``; spec.py proposes them),
3. runs **one unified ragged step**: every query token of the step,
   decode, draft and prompt-chunk tokens alike, is one row of a
   flattened ``[T]`` grid carrying its owner's block table and absolute
   position. The model writes each row's KV into the pool, then the
   ragged paged-attention kernel attends each row over its pages up to
   its own position. Only the sample rows (``spec_k + 1`` per slot) go
   through the vocab projection,
4. **lands** the samples: a final chunk's sample is the first generated
   token (and the prompt's full pages enter the prefix cache); a decode
   row's drafts are accepted while they equal the tokens sampled at
   their positions, the rest rolled back (``pool.truncate``), and one
   more token lands from the first mismatch,
5. **retires** finished sequences (eos or max tokens), releasing their
   pages at once.

``T`` is bucketed as in the JAX package (the slot grid, or
``min_step_tokens`` when larger, while the step fits it, else the next
power of two, at least 16); padding rows carry the null block table and
position 0, and their output is discarded.

The step at each bucket is a :class:`_StepProgram`, the counterpart of
the JAX engine's one compiled program per bucket: static device buffers
for the step's inputs, into which each step copies its host arrays, and
on a card one CUDA graph of the whole step (trunk, sample-row gather,
logits, finite flag, sampler), captured at the bucket's first step and
replayed from then on. ``compile_counts()`` pins the programs to the
buckets seen. A capture that fails raises; nothing falls back to eager.
``cuda_graph=False`` runs the same program eagerly, which is what the
graphed step is held against on the card; on the CPU it always runs
eagerly.

Sampling: the token after position ``p`` is drawn with the key
``fold_in(PRNGKey(seed), p)`` (sampling.py), so a request's stream is a
pure function of (prompt, seed, temperature), independent of batch
composition, chunk boundaries, prefix hits and speculation, and equal to
the JAX engine's.

Tenancy rides the step as data, as in the JAX engine, where adapters and
grammars are always in the step program and turning them off is a value:

- **Multi-LoRA adapters** (adapters.py): every grid row carries its
  owner's adapter slot (``tok_adp``), and every projection of every layer
  adds that slot's LoRA delta; slot 0 is the zero identity, so a base
  row comes out bit for bit as without adapters. ``register_adapter``
  writes into the store's existing storage, so a captured step reads a
  hot-swapped adapter at its next replay.
- **Constrained decoding** (grammar.py): every sample row carries the
  absolute row of its DFA state in one interned ``[grammar_states, V]``
  device table (``fsm_state``); the step masks disallowed tokens to
  -1e30 before sampling, after the finite flag read the raw logits. Row
  0 is all True, which leaves a free row's logits as they are. Drafts of
  a constrained slot are cut to their grammar-valid prefix, and their
  sample columns carry the states the drafts would reach. The DFA
  advances on the host as tokens land; a finished structure retires the
  request. The table is written in place as grammars are interned and
  released.
- **The host page tier** (``host_offload=True``; kv_cache.py): before
  admission, a queue head that does not fit the pool parks the coldest
  strictly lower-priority decoding streams (their pages move to pinned
  host memory and their tail reservations are released; the slot stays
  and contributes no rows), and after admission parked streams that fit
  again come back, written into the existing page tensors before the
  step that reads them. ``park_request``/``unpark_request`` do the same
  on demand.

The radix prefix cache keys pages on token ids only, as the JAX
engine's: a request on one adapter can adopt pages another adapter's
request (or a base one) wrote, though their k/v differ.
``stats["prefix_hit_tokens_cross_adapter"]`` counts such hits.

Resilience and telemetry, as the JAX engine wires them:

- **Faults stay with their request.** A non-finite sample row
  quarantines only its sequence (``finish_reason="nan"``): its pages are
  freed with a scrub (kv_cache.py), the prefix nodes its prompt created
  are evicted, and its batch-mates go on untouched, since every op of
  the step is row-wise. An admission failure, a KV-room failure and a
  raising stream callback retire their request with ``"error"``.
  Nothing else is isolated: an exception from the model, the kernel or
  a capture leaves :meth:`ServingEngine.step` (with the watchdog's
  bracket closed) and is never retried.
- **Deadlines, cancel, backpressure.** ``deadline_s`` runs from enqueue:
  a request still queued when it lapses retires ``"expired"``, an
  admitted one ``"timeout"``; :meth:`ServingEngine.cancel` works queued,
  mid-prefill, mid-decode and from the request's own stream callback;
  ``max_queue`` bounds the queue with a ``retry_after_s`` hint.
- **Health.** A :class:`~paddle_tpu_torch.faults.StepWatchdog` brackets
  every step; :meth:`ServingEngine.health` feeds ``/healthz``.
- **Fault points** ``serving.step``, ``serving.prefill``,
  ``serving.decode_step`` (after the KV-room loop, before the step reads
  the pool: the place to poison a sequence), ``serving.compile_step``
  (around the construction of a bucket's program, on the host, retried
  with backoff; never inside a capture) and, in the pool,
  ``serving.kv_alloc``. A fault writes the pool in place on the host's
  schedule, so the graph captured before it replays after it.
- **Telemetry.** The JAX engine's ``paddle_tpu_serving_*`` families,
  labelled ``{engine_id, model_id}``, and one
  ``paddle_tpu_jit_compiles_total{fn="serving_step"}`` per program
  built (captured, on a card), so it equals ``compile_counts()["step"]``;
  every request's lifecycle goes to the process-wide request tracer
  (tracing.py) under the JAX engine's event names. ``stats`` stays a
  thin per-step view.
"""
from __future__ import annotations

import functools
import inspect
import itertools
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import faults, metrics
from ..device import resolve_device
from ..ops import paged_attention as pa
from ..ops.paged_attention import ragged_paged_attention
from ..quantization.observers import KV_SCALE_FLOOR
from . import sampling, tracing
from .adapters import AdapterRows, AdapterStore
from .kv_cache import PagedKVCachePool, PrefixCache
from .overload import DrainEstimator
from .scheduler import FCFSScheduler, Request, RequestOutput
from .spec import NGramDrafter

__all__ = ["ServingEngine"]

_MIN_GRID_TOKENS = 16
_engine_counter = itertools.count()

faults.declare_point(
    "serving.step", "top of ServingEngine.step(), before the deadline "
    "sweep: arm latency here to stall whole iterations")
faults.declare_point(
    "serving.prefill", "admission of one request (cache match, page "
    "adoption, slot binding): a raise retires that request with "
    "finish_reason=\"error\"; batch-mates proceed")
faults.declare_point(
    "serving.decode_step", "after the per-slot KV-room loop and before "
    "the step program reads the pool: arm call= here to corrupt state "
    "(pool.poison_seq), delay_s to trip the watchdog")
faults.declare_point(
    "serving.compile_step", "construction of a token-grid bucket's step "
    "program on the host, outside any capture: a transient raise is "
    "retried with backoff; each bucket is still built once")


def _cb_accepts_seq(cb) -> bool:
    """True if a stream callback takes the fourth positional argument,
    the request's token sequence number: ``*args``, a required fourth
    positional parameter, or one named ``seq``. A three-argument
    callback (or one whose fourth parameter has a default and another
    name) is called with three."""
    try:
        sig = inspect.signature(cb)
    except (TypeError, ValueError):
        return False
    positional = []
    for prm in sig.parameters.values():
        if prm.kind == prm.VAR_POSITIONAL:
            return True
        if prm.kind in (prm.POSITIONAL_ONLY, prm.POSITIONAL_OR_KEYWORD):
            positional.append(prm)
    if len(positional) < 4:
        return False
    fourth = positional[3]
    return fourth.default is fourth.empty or fourth.name == "seq"


class _SeqState:
    """One live slot. ``ids`` is the prompt, ``pos`` counts tokens of KV
    in the pool (chunked-prefill progress and prefix hits are both a
    cache length) and ``gen`` the tokens sampled so far. While ``pos <
    len(ids)`` the slot feeds its next prompt chunk; the final chunk's
    sample is the first generated token. Then it decodes: ``last_token``
    feeds back at ``pos``, with its drafts behind it. ``t_last`` is when
    its last token landed. ``adp_slot`` is its adapter's slot in the
    engine's store (0: none); ``fsm`` its grammar, ``fsm_off`` the
    grammar's first row in the engine's table and ``fsm_state`` its
    local DFA state; ``parked`` is False, ``"auto"`` (parked by pressure,
    restored by the engine) or ``"manual"`` (by ``park_request``).
    ``t_admit`` anchors the prefill histogram; ``inserted_nodes`` are the
    prefix-cache nodes built from this request's KV, evicted if it is
    quarantined."""

    __slots__ = ("req", "ids", "pos", "last_token", "gen", "t_last",
                 "t_admit", "inserted_nodes", "adp_slot", "fsm", "fsm_off",
                 "fsm_state", "parked")

    def __init__(self, req: Request, pos: int = 0):
        self.req = req
        self.ids = req.prompt
        self.pos = int(pos)
        self.last_token = -1
        self.gen: List[int] = []
        self.t_last = time.perf_counter()
        self.t_admit = self.t_last
        self.inserted_nodes = []
        self.adp_slot = 0
        self.fsm = None
        self.fsm_off = 0
        self.fsm_state = 0
        self.parked = False

    @property
    def prefilling(self) -> bool:
        return self.pos < self.ids.size


@dataclass
class _StepBatch:
    """One unified step's grid, planned on the host: ``rows`` are
    ``(slot, token ids, positions, is_chunk, n_draft)``; the arrays are
    the grid (``tok``/``tok_pos``/``tok_adp`` ``[T]``, ``tok_bt`` ``[T,
    pages]``), each slot's sample rows, their positions and their
    grammar-table rows (``[B, S]``, ``S = spec_k + 1``: column 0 the
    slot's last row, then its draft rows) and the per-slot sampling
    parameters (``[B]``)."""

    rows: list
    total: int
    tok: np.ndarray
    tok_pos: np.ndarray
    tok_bt: np.ndarray
    tok_adp: np.ndarray
    sample_rows: np.ndarray
    sample_pos: np.ndarray
    fsm_state: np.ndarray
    temps: np.ndarray
    seeds: np.ndarray
    n_decode: int
    n_draft: int = 0


class _StepProgram:
    """The unified step at one token-grid bucket ``T``: the counterpart of
    the JAX engine's compiled program per bucket (``_make_step``).

    It owns the step's inputs as static device buffers (slices of one
    int32 buffer: ``tok``, ``tok_pos``, ``tok_bt``, ``tok_adp``,
    ``sample_rows``, ``sample_pos``, ``fsm_state``, ``temps`` as f32 bits
    and ``seeds``) with a host mirror (pinned on a card), so staging a
    step is one host-to-device copy, and K4's split workspace for ``T``
    rows. The pool's page and scale tensors, the adapter stacks and the
    grammar table keep their addresses, so the program reads them as they
    are.

    On a card the first call warms the program up on a side stream (lazy
    initialisation stays out of the capture), captures it as a CUDA graph
    in the engine's shared memory pool, and replays it; later calls
    stage and replay. Nothing inside reads the host: the sampler draws
    every row at a fixed shape, the KV writes are ``index_put_`` at int64
    indices, K4's launch plan reads shapes only. Copy-on-write copies
    and rollbacks, adapter and grammar-table writes and prefetched pages
    land on the host's schedule before the replay, never inside it. Off
    the card the same program runs eagerly from the same buffers."""

    def __init__(self, engine: "ServingEngine", T: int):
        self.engine = engine
        self.T = int(T)
        B, S = engine.max_batch_slots, engine._spec_rows
        P = engine.pages_per_seq
        dev = engine.device
        sizes = (("tok", T), ("tok_pos", T), ("tok_bt", T * P),
                 ("tok_adp", T), ("sample_rows", B * S),
                 ("sample_pos", B * S), ("fsm_state", B * S),
                 ("temps", B), ("seeds", B))
        n = sum(s for _k, s in sizes)
        self._buf = torch.zeros(n, dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            self._host_t = torch.zeros(n, dtype=torch.int32, pin_memory=True)
            self._host = self._host_t.numpy()
        else:
            self._host = np.zeros(n, np.int32)
            self._host_t = torch.from_numpy(self._host)
        self.dev: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, np.ndarray] = {}
        off = 0
        for name, size in sizes:
            self.dev[name] = self._buf[off:off + size]
            self.host[name] = self._host[off:off + size]
            off += size
        self.dev["temps"] = self.dev["temps"].view(torch.float32)
        self.host["temps"] = self.host["temps"].view(np.float32)
        cfg = engine.model.config
        ws = pa.workspace_numel(self.T, cfg.num_heads, engine.pool.n_kv_heads,
                                engine.pool.head_dim, engine.page_size, P)
        self.workspace = (torch.empty(ws, dtype=torch.float32, device=dev)
                          if ws else None)
        self.graph = None
        self._out: Optional[torch.Tensor] = None
        self.k4_calls = 0
        self.capture_s = 0.0

    def stage(self, batch: _StepBatch) -> None:
        """Copy the step's host arrays into the static buffers."""
        for name in self.host:
            self.host[name][:] = getattr(batch, name).reshape(-1)
        self._buf.copy_(self._host_t, non_blocking=True)

    @torch.no_grad()
    def _body(self) -> torch.Tensor:
        """The step on the device, from the static buffers: ``[2 * B*S +
        1]`` int64, the sampled tokens, each sample row's finite flag (of
        the raw logits, before the grammar mask) and, on int8 pages, the
        written slots whose scale sits at ``KV_SCALE_FLOOR`` (all layers,
        K and V; 0 otherwise), counted here so no extra read of the
        device is needed."""
        eng = self.engine
        d = self.dev
        P = eng.pages_per_seq
        B, S = eng.max_batch_slots, eng._spec_rows
        hidden = eng.trunk.forward_paged(
            d["tok"], d["tok_pos"], d["tok_bt"].view(self.T, P),
            eng.pool.layer_caches(),
            attention=functools.partial(ragged_paged_attention,
                                        workspace=self.workspace),
            adapters=AdapterRows(eng.adapters, d["tok_adp"]))
        logits = eng.model.logits(
            hidden[d["sample_rows"].to(torch.int64)]).to(torch.float32)
        fin = torch.isfinite(logits).all(dim=-1)
        allowed = eng._grammar_dev[d["fsm_state"].to(torch.int64)]
        logits = torch.where(allowed, logits, -1e30)
        nxt = sampling.sample(
            logits, d["temps"][:, None].expand(B, S).reshape(-1),
            d["seeds"][:, None].expand(B, S).reshape(-1), d["sample_pos"])
        clips = torch.zeros(1, dtype=torch.int64, device=nxt.device)
        if eng.pool.quantized:
            # the slot each row wrote; padding rows wrote the null page
            pos = d["tok_pos"].to(torch.int64)
            pages = d["tok_bt"].view(self.T, P).to(torch.int64).gather(
                1, (pos // eng.page_size)[:, None])[:, 0]
            live = (pages > 0)[:, None]
            for t in eng.pool.k_scales + eng.pool.v_scales:
                clips += ((t[pages, pos % eng.page_size] <= KV_SCALE_FLOOR)
                          & live).sum()
        return torch.cat([nxt, fin.to(torch.int64), clips])

    def _capture(self) -> None:
        eng = self.engine
        dev = eng.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        if eng._graph_pool is None:
            eng._graph_pool = torch.cuda.graph_pool_handle()
        before = pa.captured_launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=eng._graph_pool):
            out = self._body()
        self.k4_calls = pa.captured_launches - before
        self.graph, self._out = graph, out
        self.capture_s = time.perf_counter() - t0

    def __call__(self, batch: _StepBatch) -> np.ndarray:
        """Run the step on ``batch``: :meth:`_body`'s result on the
        host."""
        self.stage(batch)
        if not self.engine._graphed:
            return self._body().cpu().numpy()
        if self.graph is None:
            try:
                self._capture()
            except RuntimeError as e:
                raise RuntimeError(
                    f"CUDA-graph capture of the serving step at token-grid "
                    f"bucket T={self.T} failed") from e
        self.graph.replay()
        pa.count_replays(self.k4_calls)
        return self._out.cpu().numpy()


class ServingEngine:
    """Continuous-batching engine for ``LlamaForCausalLM``: paged KV pool
    + radix prefix cache + chunked-prefill scheduler + one unified ragged
    step per iteration, captured per token-grid bucket on a card.

    ``device`` defaults to ``cuda`` (``RuntimeError`` without a card
    unless ``device="cpu"``); the model must already live there.
    ``num_pages=None`` sizes the pool for ``max_batch_slots`` worst-case
    sequences of ``max_model_len`` tokens (+1 null page). ``kv_dtype`` is
    the page dtype (``torch.float32``, ``torch.bfloat16`` or
    ``torch.int8``, or their names). ``min_step_tokens`` floors the token
    grid (with it equal to ``token_budget`` every step has one shape).
    ``prefix_cache=False`` turns the prefix cache off. ``spec_k > 0``
    drafts up to that many tokens a decoding slot with an
    ``NGramDrafter(max_ngram=spec_ngram)``, or with ``drafter`` (anything
    with ``propose(ids, k)``). ``cuda_graph=False`` runs the step eagerly
    on a card too. ``host_offload=True`` arms the host page tier.
    ``adapter_capacity``/``adapter_rank`` size the LoRA store (slot 0 the
    identity), ``grammar_states`` the grammar table (row 0 the
    identity). ``max_queue`` bounds the waiting queue (``None``:
    unbounded); ``watchdog_stall_s`` is the step watchdog's threshold
    (``None``: no watchdog), ``watchdog_recovery_steps`` the healthy
    steps it needs to recover; ``engine_id`` (default: a process-wide
    count) and ``model_id`` label every metric series."""

    def __init__(self, model, *, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_batch_slots: int = 8,
                 max_model_len: Optional[int] = None,
                 token_budget: int = 1024,
                 min_step_tokens: Optional[int] = None,
                 kv_dtype=torch.float32, host_offload: bool = False,
                 prefix_cache: bool = True,
                 spec_k: int = 0, spec_ngram: int = 3, drafter=None,
                 adapter_capacity: int = 4, adapter_rank: int = 4,
                 grammar_states: int = 64,
                 max_queue: Optional[int] = None,
                 watchdog_stall_s: Optional[float] = 30.0,
                 watchdog_recovery_steps: int = 3,
                 engine_id: Optional[str] = None,
                 model_id: str = "default",
                 cuda_graph: bool = True, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        model.eval()
        self.engine_id = (str(engine_id) if engine_id is not None
                          else str(next(_engine_counter)))
        self.model_id = str(model_id)
        self._lbl = {"engine_id": self.engine_id, "model_id": self.model_id}
        self._trace = tracing.get_tracer()
        self.trunk = model._decode_trunk()
        n_layers, n_kv, head_dim = model._cache_spec()
        self.n_layers = n_layers
        cfg_max = int(model.config.max_position_embeddings)
        self.max_model_len = min(int(max_model_len or cfg_max), cfg_max)
        self.page_size = int(page_size)
        self.max_batch_slots = int(max_batch_slots)
        self.token_budget = int(token_budget)
        self.min_step_tokens = (None if min_step_tokens is None
                                else int(min_step_tokens))
        self.spec_k = max(int(spec_k), 0)
        if drafter is not None:
            self.drafter = drafter
            self.spec_k = max(self.spec_k, 1)
        elif self.spec_k > 0:
            self.drafter = NGramDrafter(k=self.spec_k,
                                        max_ngram=int(spec_ngram))
        else:
            self.drafter = None
        # sample-grid width: every slot owns spec_k + 1 sample rows, fixed
        # per engine so the step's shapes never vary with the drafts
        self._spec_rows = self.spec_k + 1
        # the LoRA store is always built and always in the step: with no
        # adapter registered every row reads slot 0's zeros
        self.adapters = AdapterStore.from_model(
            model, rank=adapter_rank, capacity=adapter_capacity)
        # one [grammar_states, V] allow-mask table for every interned
        # grammar, row 0 all True (the free rows' identity); a host copy
        # and the device table the step reads, written in place
        self._vocab_size = int(model.config.vocab_size)
        self._grammar_cap = int(grammar_states)
        if self._grammar_cap < 2:
            raise ValueError("grammar_states must be >= 2 (row 0 is the "
                             f"reserved identity), got {grammar_states}")
        self._grammar_table = np.zeros(
            (self._grammar_cap, self._vocab_size), bool)
        self._grammar_table[0, :] = True
        self._grammar_dev = torch.from_numpy(self._grammar_table).to(
            self.device)
        # fsm.key -> [offset, n_states, refcount, fsm]
        self._grammar_segments: Dict[object, list] = {}
        self._host_offload = bool(host_offload)
        # the adapter that wrote each page the prefix cache indexes
        self._page_writer: Dict[int, Optional[str]] = {}
        self.pages_per_seq = -(-self.max_model_len // self.page_size)
        if num_pages is None:
            num_pages = self.max_batch_slots * self.pages_per_seq + 1
        self.pool = PagedKVCachePool(n_layers, num_pages, self.page_size,
                                     n_kv, head_dim, dtype=kv_dtype,
                                     device=self.device,
                                     engine_id=self.engine_id,
                                     model_id=self.model_id)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.pool) if prefix_cache else None)
        self.scheduler = FCFSScheduler(
            self.max_batch_slots, self.token_budget, max_queue=max_queue,
            retry_after_cb=self._estimate_retry_after)
        self.watchdog = (faults.StepWatchdog(
            stall_threshold_s=watchdog_stall_s,
            recovery_steps=watchdog_recovery_steps)
            if watchdog_stall_s is not None else None)
        # step wall-time EWMA, seeded at 50 ms: the drain rate behind the
        # backpressure hint
        self._avg_step_s = 0.05
        self._estimator = DrainEstimator()
        self.slots: List[Optional[_SeqState]] = [None] * self.max_batch_slots
        self._graphed = bool(cuda_graph) and self.device.type == "cuda"
        self._graph_pool = None
        self._programs: Dict[int, _StepProgram] = {}
        self._grid_buckets_seen: set = set()
        self._outputs: Dict[object, RequestOutput] = {}
        self.stats: Dict[str, float] = {
            "steps": 0, "generated_tokens": 0, "finished_requests": 0,
            "queue_depth": 0, "running_seqs": 0, "tokens_per_sec": 0.0,
            "page_utilization": 0.0, "peak_pages": 0,
            # the token mix of the last step (decode, draft, prompt rows)
            "step_decode_tokens": 0, "step_draft_tokens": 0,
            "step_prefill_tokens": 0,
            # running totals: prompt tokens prefix hits covered (and of
            # those, the ones written under another adapter), draft rows
            # scored and drafts accepted
            "prefix_hit_tokens": 0, "prefix_hit_tokens_cross_adapter": 0,
            "spec_drafted": 0, "spec_accepted": 0,
            # tokens landed under a grammar; drafts cut by one
            "grammar_tokens": 0, "grammar_filtered_drafts": 0,
            # the host tier: parks and unparks, pages moved each way, and
            # pages a slot still had on the host when its step came
            "parks": 0, "unparks": 0, "kv_offloaded_pages": 0,
            "kv_prefetched_pages": 0, "kv_prefetch_late_pages": 0,
        }
        self._register_metrics()

    def _register_metrics(self) -> None:
        """The JAX engine's instruments, under its names and help, each
        series labelled ``{engine_id, model_id}``."""
        reg = metrics.get_registry()
        eng = ("engine_id", "model_id")
        lbl = self._lbl

        def hist(name, help_):
            return reg.histogram(name, help_, labels=eng).labels(**lbl)

        def counter(name, help_):
            return reg.counter(name, help_, labels=eng).labels(**lbl)

        self._m_ttft = hist(
            "paddle_tpu_serving_ttft_seconds",
            "Time to first token: request enqueue -> first sampled token")
        self._m_itl = hist(
            "paddle_tpu_serving_inter_token_seconds",
            "Inter-token latency: gap between consecutive tokens of one "
            "sequence during decode")
        self._m_step = hist(
            "paddle_tpu_serving_step_seconds",
            "Full engine step: admit + unified ragged step + retire")
        self._m_prefill = hist(
            "paddle_tpu_serving_prefill_seconds",
            "One request's whole chunked prefill: admission -> first "
            "sampled token")
        self._m_decode = hist(
            "paddle_tpu_serving_decode_step_seconds",
            "One unified compiled step over all live slots (decode "
            "tokens + prompt chunks)")
        mix = reg.histogram(
            "paddle_tpu_serving_step_mix",
            "Per-step token split of the unified step: tokens of each "
            "kind (decode, prefill chunk, speculative draft) the step "
            "carried", labels=("kind",) + eng)
        self._m_mix_decode = mix.labels(kind="decode", **lbl)
        self._m_mix_prefill = mix.labels(kind="prefill", **lbl)
        self._m_mix_draft = mix.labels(kind="draft", **lbl)
        self._m_spec_drafted = counter(
            "paddle_tpu_serving_spec_drafted_tokens_total",
            "Draft tokens proposed by the speculative drafter and scored "
            "as extra unified-step rows")
        self._m_spec_accepted = counter(
            "paddle_tpu_serving_spec_accepted_tokens_total",
            "Draft tokens accepted (exact match against the per-position "
            "sampled target); the rest rolled back by KV truncation")
        self._m_spec_accept = hist(
            "paddle_tpu_serving_spec_acceptance_ratio",
            "Per-burst acceptance: accepted/drafted for each decode step "
            "that carried draft rows")
        self._m_chunk = hist(
            "paddle_tpu_serving_prefill_chunk_tokens",
            "Tokens per prompt chunk the scheduler sliced under the step "
            "token budget")
        self._m_requests = reg.counter(
            "paddle_tpu_serving_requests_total",
            "Requests by lifecycle event", labels=("event",) + eng)
        self._m_tokens = counter(
            "paddle_tpu_serving_generated_tokens_total",
            "Tokens sampled by the engine (prefill first tokens included)")
        for ev in ("admitted", "rejected", "retired", "preempted"):
            self._m_requests.labels(event=ev, **lbl)  # scrapes show 0
        self._m_cb_errors = counter(
            "paddle_tpu_serving_callback_errors_total",
            "Exceptions raised by user stream callbacks (isolated: the "
            "engine step survives; the request retires \"error\")")
        self._m_wd_trips = counter(
            "paddle_tpu_serving_watchdog_trips_total",
            "Watchdog trip episodes (healthy->tripped transitions, not "
            "slow-step count)")
        self._m_degraded = reg.gauge(
            "paddle_tpu_serving_degraded",
            "1 while the step watchdog holds this engine degraded "
            "(/healthz returns 503), else 0; refreshed at step end and "
            "on every health() probe", labels=eng).labels(**lbl)
        # one counter per abnormal finish reason, moved once per event
        self._reason_counters = {
            reason: counter(name, help_) for reason, name, help_ in (
                ("timeout", "paddle_tpu_serving_request_timeouts_total",
                 "Admitted requests retired on deadline expiry mid-stream "
                 "(finish_reason=\"timeout\"); queued expiry counts "
                 "paddle_tpu_serving_expired_total instead"),
                ("expired", "paddle_tpu_serving_expired_total",
                 "QUEUED requests whose deadline lapsed before admission "
                 "(finish_reason=\"expired\"): retired with pages never "
                 "allocated"),
                ("cancelled", "paddle_tpu_serving_cancellations_total",
                 "Requests retired by cancel() "
                 "(finish_reason=\"cancelled\")"),
                ("nan", "paddle_tpu_serving_nan_quarantines_total",
                 "Sequences quarantined for non-finite decode logits "
                 "(finish_reason=\"nan\"); batch-mates are unaffected"),
                ("error", "paddle_tpu_serving_request_errors_total",
                 "Requests retired on an internal failure "
                 "(finish_reason=\"error\": admission/alloc/callback "
                 "faults)"),
                ("unavailable", "paddle_tpu_serving_unavailable_total",
                 "Queued requests retired because no healthy engine could "
                 "adopt them (finish_reason=\"unavailable\": the router's "
                 "requeue-impossible path)"))}
        self._m_adapter_req = reg.counter(
            "paddle_tpu_serving_adapter_requests_total",
            "Requests admitted under a named LoRA adapter (base/slot-0 "
            "requests are not counted)", labels=("adapter_id",) + eng)
        self._m_adapter_slots = reg.gauge(
            "paddle_tpu_serving_adapter_slots",
            "Named adapters currently registered in this engine's "
            "AdapterStore (the slot-0 identity is not counted)",
            labels=eng).labels(**lbl)
        self._m_grammar_req = counter(
            "paddle_tpu_serving_grammar_requests_total",
            "Grammar-constrained requests admitted (regex/JSON-schema "
            "FSM attached)")
        self._m_grammar_tokens = counter(
            "paddle_tpu_serving_grammar_tokens_total",
            "Tokens landed under an in-step grammar mask (FSM advanced "
            "on the host)")
        self._m_grammar_completions = reg.counter(
            "paddle_tpu_serving_grammar_completions_total",
            "Constrained requests retired normally (stop/length) by "
            "whether the finished stream walks its grammar to an "
            "accepting state", labels=("result",) + eng)
        for r in ("valid", "invalid"):
            self._m_grammar_completions.labels(result=r, **lbl)
        self._m_grammar_filtered = counter(
            "paddle_tpu_serving_grammar_draft_filtered_total",
            "Speculative draft tokens dropped before staging because "
            "they would leave the proposer slot's grammar (an unmasked "
            "draft would collapse acceptance)")
        self._m_grammar_states = reg.gauge(
            "paddle_tpu_serving_grammar_states",
            "Grammar-table rows in use (interned DFA states plus the "
            "row-0 identity) out of the grammar_states capacity",
            labels=eng).labels(**lbl)
        self._m_grammar_states.set(1.0)
        self._m_prefetch_late = counter(
            "paddle_tpu_serving_kv_prefetch_late_total",
            "KV pages prefetched host→HBM inside the step path (late: "
            "the unpark-time prefetch should have restored them first)")
        self._m_compiles = reg.counter(
            "paddle_tpu_jit_compiles_total",
            "Step programs built: one per token-grid bucket (on a card, "
            "its CUDA-graph capture)", labels=("fn", "source")).labels(
                fn="serving_step", source="fresh")
        # the JAX engine's record_counter gauges, under the names its
        # profiler bridge gives them
        self._m_gauges = {k: reg.gauge(
            f"paddle_tpu_serving_{k}",
            f"record_counter('serving.{k}') gauge (profiler bridge)")
            for k in ("queue_depth", "running_seqs", "tokens_per_sec",
                      "page_utilization")}

    # ------------------------------------------------------------ frontend
    def check_request(self, prompt_len: int, max_new_tokens: int) -> None:
        """Raise ValueError if a request of this shape could never be
        served, naming the limit it breaks."""
        p, m = int(prompt_len), int(max_new_tokens)
        if p > self.max_model_len:
            self._reject()
            raise ValueError(
                f"prompt_len {p} exceeds the context window (limit: "
                f"max_model_len={self.max_model_len})")
        total = p + m
        if total > self.max_model_len:
            self._reject()
            raise ValueError(
                f"prompt_len {p} + max_new_tokens {m} = {total} exceeds "
                f"the per-request token cap (limit: max_model_len="
                f"{self.max_model_len})")
        need = self.pool.pages_needed(total)
        if need > self.pool.usable_pages:
            self._reject()
            raise ValueError(
                f"max_total_tokens {total} needs {need} KV pages but the "
                f"pool has only {self.pool.usable_pages} usable pages "
                f"(limit: num_pages={self.pool.num_pages})")

    def _reject(self) -> None:
        self._m_requests.labels(event="rejected", **self._lbl).inc()

    def _check_features(self, req: Request) -> None:
        """Raise ValueError at enqueue for an adapter this engine does not
        hold, a grammar compiled for another vocabulary, or a DFA larger
        than the grammar table."""
        if (req.adapter_id is not None
                and not self.adapters.holds(req.adapter_id)):
            self._reject()
            raise ValueError(
                f"adapter {req.adapter_id!r} is not registered on this "
                f"engine (holding {list(self.adapters.names())}); "
                f"register it first")
        fsm = req.grammar
        if fsm is not None:
            if int(fsm.vocab_size) != self._vocab_size:
                self._reject()
                raise ValueError(
                    f"grammar was compiled for vocab_size "
                    f"{int(fsm.vocab_size)} but this model's vocab is "
                    f"{self._vocab_size}; recompile the GrammarFSM "
                    f"against this model's tokenizer")
            if fsm.n_states > self._grammar_cap - 1:
                self._reject()
                raise ValueError(
                    f"grammar needs {fsm.n_states} DFA states but the "
                    f"table holds at most {self._grammar_cap - 1} "
                    f"(limit: grammar_states={self._grammar_cap}); "
                    f"simplify the pattern or raise grammar_states")

    def add_request(self, prompt, max_new_tokens: int = 32,
                    temperature: float = 0.0,
                    eos_token_id: Optional[int] = None, seed: int = 0,
                    stream_cb=None, deadline_s: Optional[float] = None,
                    priority: int = 0, prefix_cache: bool = True,
                    adapter_id: Optional[str] = None, grammar=None):
        """Queue a request; returns its ``req_id``. Generation starts at
        the next :meth:`step` with capacity. ``deadline_s`` bounds the
        request from enqueue, queue wait included. ``prefix_cache=False``
        keeps this request out of the prefix cache. ``adapter_id`` names
        a LoRA adapter this engine holds (:meth:`register_adapter`);
        ``grammar`` is a compiled ``GrammarFSM`` constraining every
        sampled token. Raises :class:`~.scheduler.BackpressureError`
        when a bounded queue (``max_queue``) is full."""
        req = Request(prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      eos_token_id=eos_token_id, seed=seed,
                      stream_cb=stream_cb, deadline_s=deadline_s,
                      priority=priority, prefix_cache=prefix_cache,
                      adapter_id=adapter_id, grammar=grammar)
        self.check_request(req.prompt.size, req.max_new_tokens)
        self._check_features(req)
        try:
            self.scheduler.add(req)
        except Exception:
            self._reject()
            raise
        self._trace.emit("req.enqueue", req.req_id,
                         arg=float(req.prompt.size), label=self.engine_id)
        return req.req_id

    def cancel(self, req_id) -> bool:
        """Cancel a request wherever it is: pulled from the queue, or
        retired mid-prefill or mid-decode with its pages freed in this
        call (also from its own stream callback). Its output (the tokens
        so far, ``finish_reason="cancelled"``) comes out of :meth:`run`
        and the terminal callback fires. False if the request is unknown
        or finished."""
        req = self.scheduler.remove(req_id)
        if req is not None:
            self._finish_queued(req, "cancelled")
            return True
        for i, st in enumerate(self.slots):
            if st is not None and st.req.req_id == req_id:
                self._retire_abnormal(st, slot=i, reason="cancelled")
                return True
        return False

    def health(self) -> Dict[str, object]:
        """The liveness view ``MetricsServer(health_cb=engine.health)``
        serves: ``status`` is ``"degraded"`` while the watchdog is
        tripped or a step is hung past its threshold (readable from the
        scrape thread mid-step)."""
        degraded = (self.watchdog is not None
                    and self.watchdog.status() != "ok")
        self._m_degraded.set(1.0 if degraded else 0.0)
        return {
            "status": "degraded" if degraded else "ok",
            "watchdog_trips": (0 if self.watchdog is None
                               else self.watchdog.trips),
            "queue_depth": self.scheduler.queue_depth,
            "running_seqs": sum(1 for s in self.slots if s is not None),
        }

    def _estimate_retry_after(self) -> float:
        """The backpressure hint: queue depth x the step EWMA, floored at
        50 ms (:class:`~.overload.DrainEstimator`)."""
        return self._estimator.for_engine(self)

    @property
    def avg_step_s(self) -> float:
        """Step wall-time EWMA, the drain rate behind ``retry_after_s``."""
        return self._avg_step_s

    def load_score(self) -> float:
        """Estimated seconds to drain this engine's commitment: the steps
        its queued and live requests still need (prompt chunks under the
        token budget, one step per remaining new token) x the step
        EWMA."""
        budget = max(self.scheduler.token_budget, 1)
        steps = 0
        for r in self.scheduler.waiting:
            steps += max(-(-int(r.prompt.size) // budget), 1)
            steps += int(r.max_new_tokens)
        for st in self.slots:
            if st is None:
                continue
            steps += -(-max(int(st.ids.size) - st.pos, 0) // budget)
            steps += max(int(st.req.max_new_tokens) - len(st.gen), 0)
        return steps * self._avg_step_s

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

    def compile_counts(self) -> Dict[str, int]:
        """``step``: the step programs built (captured, on a card);
        ``step_buckets``: the token-grid buckets seen. The two must stay
        equal, as in the JAX engine."""
        return {"step": len(self._programs),
                "step_buckets": len(self._grid_buckets_seen)}

    def capture_seconds(self) -> Dict[int, float]:
        """Seconds each bucket's capture took (warm-up included), by
        ``T``; empty off the card."""
        return {T: p.capture_s for T, p in sorted(self._programs.items())
                if p.graph is not None}

    # ------------------------------------------------ adapters and grammars
    def register_adapter(self, name: str, weights) -> int:
        """Install (or hot-swap) LoRA adapter ``name``: a write into the
        store's existing storage, so no step program changes
        (``compile_counts()`` before == after) and a captured step reads
        the new weights at its next replay. Returns the slot."""
        slot = self.adapters.register(name, weights)
        self._m_adapter_slots.set(float(len(self.adapters.names())))
        return slot

    def unregister_adapter(self, name: str) -> None:
        """Zero and free adapter ``name``'s slot; refused while an
        admitted or queued request still names it."""
        if self._adapter_in_use(name):
            raise ValueError(
                f"adapter {name!r} is in use by an admitted or queued "
                f"request; drain it before unregistering")
        self.adapters.unregister(name)
        self._m_adapter_slots.set(float(len(self.adapters.names())))

    def _adapter_in_use(self, name: str) -> bool:
        for st in self.slots:
            if st is not None and st.req.adapter_id == name:
                return True
        return any(r.adapter_id == name for r in self.scheduler.waiting)

    def _grammar_intern(self, fsm) -> int:
        """Refcounted first-fit interning of a compiled DFA into the
        grammar table: returns the grammar's first row. The same
        ``fsm.key`` shares its rows; row 0 is the identity."""
        seg = self._grammar_segments.get(fsm.key)
        if seg is not None:
            seg[2] += 1
            return seg[0]
        n = int(fsm.n_states)
        taken = sorted((s[0], s[1]) for s in self._grammar_segments.values())
        off, ok = 1, False
        for seg_off, seg_n in taken:
            if off + n <= seg_off:
                ok = True
                break
            off = seg_off + seg_n
        if not ok and off + n > self._grammar_cap:
            held = {str(k[0]): s[1] for k, s in
                    self._grammar_segments.items()}
            raise ValueError(
                f"grammar table full: need {n} rows but only "
                f"{self._grammar_cap - off} remain of "
                f"grammar_states={self._grammar_cap} (holding {held}); "
                f"raise grammar_states or drain constrained requests")
        self._write_grammar_rows(off, fsm.mask_table)
        self._grammar_segments[fsm.key] = [off, n, 1, fsm]
        self._count_grammar_rows()
        return off

    def _count_grammar_rows(self) -> None:
        self._m_grammar_states.set(float(1 + sum(
            s[1] for s in self._grammar_segments.values())))

    def _grammar_release(self, st: _SeqState) -> None:
        """Drop ``st``'s reference on its interned grammar; at refcount
        zero its rows are cleared and the segment freed."""
        fsm, st.fsm = st.fsm, None
        if fsm is None:
            return
        seg = self._grammar_segments.get(fsm.key)
        if seg is None:
            return
        seg[2] -= 1
        if seg[2] <= 0:
            off, n = seg[0], seg[1]
            self._write_grammar_rows(off, np.zeros((n, self._vocab_size),
                                                   bool))
            del self._grammar_segments[fsm.key]
        self._count_grammar_rows()

    def _write_grammar_rows(self, off: int, rows: np.ndarray) -> None:
        """Rows ``off..`` of the grammar table, host copy and device table
        alike; the device table keeps its storage."""
        self._grammar_table[off:off + rows.shape[0]] = rows
        self._grammar_dev[off:off + rows.shape[0]].copy_(
            torch.from_numpy(self._grammar_table[off:off + rows.shape[0]]))

    # ---------------------------------------------------------------- step
    def step(self) -> List[RequestOutput]:
        """One engine iteration: sweep deadlines, admit, one unified
        ragged step, land, retire. Returns the requests that finished in
        it. The watchdog's bracket closes even when the body raises."""
        t0 = time.perf_counter()
        if self.watchdog is not None:
            self.watchdog.begin_step()
        tokens_before = self.stats["generated_tokens"]
        finished: List[RequestOutput] = []
        try:
            faults.point("serving.step")
            finished.extend(self._sweep_deadlines())
            if self._host_offload:
                # pressure relief before admission: a parked stream's
                # pages and tail reservation are what the queue head needs
                self._park_for_pressure()
            free = sum(1 for s in self.slots if s is None)
            for req in self.scheduler.admit(free, self.pool):
                self._m_requests.labels(event="admitted", **self._lbl).inc()
                try:
                    self._admit(req)
                except Exception as e:
                    # an admission failure fails this request only
                    finished.append(self._fail_admitted_request(req, e))
            if self._host_offload:
                # after admission, so a just-admitted head is never
                # displaced by the stream it preempted
                self._unpark_ready()
            self._set_step_mix(0, 0, 0)
            if any(s is not None for s in self.slots):
                finished.extend(self._step_once())
        finally:
            dt = time.perf_counter() - t0
            self._avg_step_s = 0.8 * self._avg_step_s + 0.2 * dt
            if self.watchdog is not None:
                if self.watchdog.end_step(dt):
                    self._m_wd_trips.inc()
                self._m_degraded.set(
                    0.0 if self.watchdog.status() == "ok" else 1.0)
        self._m_step.observe(dt)
        self.stats["steps"] += 1
        self.stats["queue_depth"] = self.scheduler.queue_depth
        self.stats["running_seqs"] = sum(1 for s in self.slots
                                         if s is not None)
        produced = self.stats["generated_tokens"] - tokens_before
        self.stats["tokens_per_sec"] = produced / dt if dt > 0.0 else 0.0
        self.stats["page_utilization"] = self.pool.utilization()
        self.stats["peak_pages"] = self.pool.peak_used
        for k, g in self._m_gauges.items():
            g.set(self.stats[k])
        self._trace.emit("step.tokens", self.engine_id, arg=float(produced))
        return finished

    def _set_step_mix(self, decode: int, draft: int, prefill: int) -> None:
        self.stats["step_decode_tokens"] = decode
        self.stats["step_draft_tokens"] = draft
        self.stats["step_prefill_tokens"] = prefill

    def _step_once(self) -> List[RequestOutput]:
        """Plan the step (retiring with ``"error"`` a slot whose KV room
        fails), build the bucket's program if it is new (under
        ``serving.compile_step``, retried), run it and land its
        samples."""
        t0 = time.perf_counter()
        finished: List[RequestOutput] = []
        batch = self._plan(finished)
        if batch is None:
            return finished
        T = batch.tok.size
        fresh = T not in self._grid_buckets_seen
        self._grid_buckets_seen.add(T)
        prog = self._programs.get(T)
        if prog is None:
            prog = self._compile_with_retry(
                "serving.compile_step", lambda: _StepProgram(self, T))
        t_prog = time.perf_counter()
        out = prog(batch)
        if T not in self._programs:
            # a bucket's program counts once its first run (its capture,
            # on a card) went through
            self._programs[T] = prog
            self._m_compiles.inc()
        BS = self.max_batch_slots * self._spec_rows
        self.pool.count_scale_clips(int(out[2 * BS]))
        now = time.perf_counter()
        self._m_decode.observe(now - t0)
        self._m_mix_decode.observe(batch.n_decode)
        self._m_mix_draft.observe(batch.n_draft)
        self._m_mix_prefill.observe(batch.total - batch.n_decode
                                    - batch.n_draft)
        if fresh:
            # the bucket's build and capture ran under every rider
            for i, *_rest in batch.rows:
                if self.slots[i] is not None:
                    self._trace.emit("req.compile", self.slots[i].req.req_id,
                                     arg=now - t_prog, t=now)
        finished.extend(self._land(batch, out[:BS], out[BS:2 * BS],
                                   now=now))
        return finished

    def _compile_with_retry(self, point_name: str, make_fn):
        """Build a step program under a fault point with a short seeded
        backoff: a transient failure costs milliseconds, a persistent one
        propagates. Only the successful build counts."""
        def build():
            faults.point(point_name)
            return make_fn()

        return faults.retry(build, attempts=3, base_delay_s=0.01,
                            max_delay_s=0.1)

    # ------------------------------------------------- host-tier parking
    def _find_slot(self, req_id):
        for i, st in enumerate(self.slots):
            if st is not None and st.req.req_id == req_id:
                return i, st
        raise KeyError(f"unknown or finished request: {req_id!r}")

    def park_request(self, req_id) -> int:
        """Park a live request: its exclusively owned KV pages move to the
        host tier, its unwritten tail reservation is released, and its
        slot (which it keeps) contributes no rows until
        :meth:`unpark_request`; the engine never restores it by itself.
        Returns the pages moved; 0 for a parked request."""
        return self._park(req_id, mode="manual")

    def _require_host_tier(self) -> None:
        if not self._host_offload:
            raise RuntimeError(
                "host_offload is disabled on this engine "
                "(ServingEngine(host_offload=True) to enable the tier)")

    def _park(self, req_id, mode: str) -> int:
        self._require_host_tier()
        _, st = self._find_slot(req_id)
        if st.parked:
            return 0
        n = self.pool.offload_seq(req_id)
        st.parked = mode
        self.stats["parks"] += 1
        self.stats["kv_offloaded_pages"] += n
        self._trace.emit("req.park", req_id, arg=float(n))
        return n

    def unpark_request(self, req_id) -> int:
        """Restore a parked request's pages bit for bit (into the existing
        page tensors) and its tail reservation; the slot rejoins the next
        step. Raises if the pool cannot cover it (``pool.can_prefetch``).
        Returns the pages restored."""
        self._require_host_tier()
        _, st = self._find_slot(req_id)
        if not st.parked:
            return 0
        n = self.pool.prefetch_seq(req_id)
        st.parked = False
        self.stats["unparks"] += 1
        self.stats["kv_prefetched_pages"] += n
        self._trace.emit("req.unpark", req_id, arg=float(n))
        return n

    def _head_cached_pages(self, head: Request) -> int:
        matched = (self.pool.prefix_match_len(head.prompt)
                   if head.prefix_cache else 0)
        return matched // self.page_size

    def _park_for_pressure(self) -> None:
        """When the queue head cannot admit for pages while a slot is
        free, park the coldest strictly lower-priority decoding streams
        until its worst case fits."""
        sched = self.scheduler
        if not sched.waiting or not any(s is None for s in self.slots):
            return
        head = sched.waiting[0]
        cached = self._head_cached_pages(head)
        if self.pool.can_admit(head.max_total_tokens, cached_pages=cached):
            return
        cands = [(st.t_last, st.req.req_id, st.req)
                 for st in self.slots
                 if st is not None and not st.parked and not st.prefilling]
        for rid in sched.offload_victims(head, cands):
            self._park(rid, mode="auto")
            if self.pool.can_admit(head.max_total_tokens,
                                   cached_pages=cached):
                return

    def _unpark_ready(self) -> None:
        """Restore streams parked by pressure whose pages fit again,
        highest priority and oldest first, each only if the queue head's
        worst case still fits after it (else the next step would park it
        right back)."""
        parked = [(st.req.priority, st.req.arrival_t, st.req.req_id)
                  for st in self.slots
                  if st is not None and st.parked == "auto"]
        if not parked:
            return
        head_need = 0
        if self.scheduler.waiting:
            head = self.scheduler.waiting[0]
            head_need = max(self.pool.pages_needed(head.max_total_tokens)
                            - self._head_cached_pages(head), 0)
        for _, _, rid in sorted(parked):
            if not self.pool.can_prefetch(rid):
                continue
            if (head_need and self.pool.spare_pages()
                    - self.pool.prefetch_cost(rid) < head_need):
                continue
            self.unpark_request(rid)

    def _admit(self, req: Request) -> None:
        """Put a request in a free slot with its worst-case reservation:
        the longest cached prefix of its prompt (full pages, capped one
        token short) joins its table by refcount and its chunk cursor
        starts after it; the rest prefills inside the next steps. Binds
        its adapter slot and interns its grammar. A raise (the
        ``serving.prefill`` point, a full grammar table) leaves the pages
        to :meth:`_fail_admitted_request`."""
        faults.point("serving.prefill")
        cache = self.prefix_cache if req.prefix_cache else None
        matched, shared = 0, []
        if cache is not None:
            matched, shared, _nodes = cache.match(req.prompt)
        self.pool.allocate(req.req_id, matched,
                           max_total_tokens=req.max_total_tokens,
                           prefix_pages=shared, prefix_tokens=matched)
        self.stats["prefix_hit_tokens"] += matched
        self.stats["prefix_hit_tokens_cross_adapter"] += self.page_size * sum(
            self._page_writer.get(p) != req.adapter_id for p in shared)
        st = _SeqState(req, pos=matched)
        try:
            st.adp_slot = self.adapters.slot(req.adapter_id)
        except KeyError as e:
            raise ValueError(str(e)) from None
        if req.adapter_id is not None:
            self._m_adapter_req.labels(adapter_id=req.adapter_id,
                                       **self._lbl).inc()
        if req.grammar is not None:
            st.fsm_off = self._grammar_intern(req.grammar)
            st.fsm = req.grammar
            st.fsm_state = (req.grammar.start_state
                            if req.resume_fsm_state is None
                            else int(req.resume_fsm_state))
            self._m_grammar_req.inc()
        self.slots[self.slots.index(None)] = st
        self._trace.emit("req.admit", req.req_id, arg=float(matched),
                         label=self.engine_id)
        if matched:
            self._trace.emit("req.prefix_hit", req.req_id,
                             arg=float(matched))

    def _grid_tokens(self, total: int) -> int:
        """Token-grid bucket: the slot grid (or ``min_step_tokens`` when
        larger) while the step fits it, else the next power of two, at
        least 16."""
        floor_ = max(self.max_batch_slots, int(self.min_step_tokens or 0))
        if total <= floor_:
            return floor_
        return max(_MIN_GRID_TOKENS, 1 << (int(total) - 1).bit_length())

    def _plan_drafts(self, decode_idx: List[int], leftover: int
                     ) -> Dict[int, np.ndarray]:
        """Draft tokens per decoding slot from the budget's leftover, each
        capped so the burst stays inside ``max_new_tokens`` (the base row
        lands at least one) and the request's reservation. A constrained
        slot keeps only the grammar-valid prefix of its proposal: a draft
        past the first violation could never equal its masked target."""
        if self.drafter is None or not decode_idx or leftover <= 0:
            return {}
        wants = []
        for i in decode_idx:
            st = self.slots[i]
            limit = min(st.req.max_total_tokens, self.max_model_len)
            cap = min(self.spec_k,
                      int(st.req.max_new_tokens) - len(st.gen) - 1,
                      limit - (st.pos + 1))
            if cap > 0:
                wants.append((i, cap, st.req))
        drafts = {}
        for i, d in self.scheduler.plan_drafts(leftover, wants):
            st = self.slots[i]
            prop = self.drafter.propose(
                np.concatenate([st.req.prompt, np.asarray(st.gen, np.int32)]),
                d)
            prop = np.asarray(prop, np.int32).reshape(-1)[:d]
            if st.fsm is not None and prop.size:
                s_, keep = st.fsm_state, 0
                for t in prop:
                    s_ = st.fsm.next_state(s_, int(t))
                    if s_ < 0:
                        break
                    keep += 1
                if keep < prop.size:
                    self.stats["grammar_filtered_drafts"] += \
                        int(prop.size) - keep
                    self._m_grammar_filtered.inc(int(prop.size) - keep)
                    prop = prop[:keep]
            if prop.size:
                drafts[i] = prop
                self._trace.emit("req.drafts", st.req.req_id,
                                 arg=float(prop.size))
        return drafts

    def _plan(self, finished: Optional[List[RequestOutput]] = None
              ) -> Optional[_StepBatch]:
        """Decide this step's rows and reserve their KV room (copying
        shared pages they write into first): one row per decoding slot
        with its drafts behind it, then prompt chunks under the budget;
        lay them out on the token grid. A parked slot has no rows; one
        that reaches this point with pages still on the host fetches them
        now (a late prefetch, counted). A slot whose prefetch or KV room
        fails retires with ``"error"`` (appended to ``finished``) and its
        batch-mates go on. The ``serving.decode_step`` fault point fires
        after the KV room is reserved."""
        if finished is None:
            finished = []
        B, S = self.max_batch_slots, self._spec_rows
        decode_idx: List[int] = []
        prefill_info = []
        for i, st in enumerate(self.slots):
            if st is None or st.parked:
                continue
            if self._host_offload and self.pool.offloaded_pages(
                    st.req.req_id):
                try:
                    n = self.pool.prefetch_seq(st.req.req_id)
                except Exception as e:
                    finished.append(self._retire_abnormal(
                        st, slot=i, reason="error", error=e))
                    continue
                self.stats["kv_prefetch_late_pages"] += n
                self._m_prefetch_late.inc(n)
            if st.prefilling:
                prefill_info.append((i, int(st.ids.size) - st.pos, st.req))
            else:
                decode_idx.append(i)
        chunks = self.scheduler.plan_chunks(len(decode_idx), prefill_info)
        for i, c in chunks:
            self._trace.emit("req.chunk_planned", self.slots[i].req.req_id,
                             arg=float(c))
        drafts = self._plan_drafts(
            decode_idx,
            self.token_budget - len(decode_idx) - sum(c for _, c in chunks))
        rows = []
        n_decode = n_draft = 0
        for i in decode_idx:
            st = self.slots[i]
            d_toks = drafts.get(i)
            d = 0 if d_toks is None else int(d_toks.size)
            try:
                if d:
                    self.pool.extend_write(st.req.req_id, st.pos,
                                           st.pos + 1 + d)
                else:
                    self.pool.extend(st.req.req_id, st.pos + 1)
            except Exception as e:
                finished.append(self._retire_abnormal(
                    st, slot=i, reason="error", error=e))
                continue
            toks = (np.concatenate([[st.last_token], d_toks]).astype(
                np.int32) if d else np.asarray([st.last_token], np.int32))
            rows.append((i, toks,
                         np.arange(st.pos, st.pos + 1 + d, dtype=np.int32),
                         False, d))
            n_decode += 1
            n_draft += d
        for i, c in chunks:
            st = self.slots[i]
            try:
                self.pool.extend_write(st.req.req_id, st.pos, st.pos + c)
            except Exception as e:
                finished.append(self._retire_abnormal(
                    st, slot=i, reason="error", error=e))
                continue
            rows.append((i, st.ids[st.pos:st.pos + c],
                         np.arange(st.pos, st.pos + c, dtype=np.int32),
                         True, 0))
        faults.point("serving.decode_step")
        if not rows:
            return None
        total = sum(r[1].size for r in rows)
        T = self._grid_tokens(total)
        tok = np.zeros(T, np.int32)
        tok_pos = np.zeros(T, np.int32)
        tok_bt = np.zeros((T, self.pages_per_seq), np.int32)
        tok_adp = np.zeros(T, np.int32)
        sample_rows = np.zeros((B, S), np.int32)
        sample_pos = np.zeros((B, S), np.int32)
        # absolute grammar-table rows; 0 (all True) for free slots
        fsm_state = np.zeros((B, S), np.int32)
        temps = np.zeros(B, np.float32)
        seeds = np.zeros(B, np.int32)
        cur = 0
        for i, toks, poss, is_chunk, d in rows:
            st = self.slots[i]
            c = toks.size
            tok[cur:cur + c] = toks
            tok_pos[cur:cur + c] = poss
            table = self.pool.block_table(st.req.req_id)
            tok_bt[cur:cur + c, :len(table)] = table
            tok_adp[cur:cur + c] = st.adp_slot
            if is_chunk:
                # the chunk's final token samples (kept only when the
                # prompt is done)
                sample_rows[i, 0] = cur + c - 1
                sample_pos[i, 0] = int(poss[-1])
                if st.fsm is not None:
                    fsm_state[i, 0] = st.fsm_off + st.fsm_state
            else:
                # column j samples the token after burst token j
                sample_rows[i, :d + 1] = np.arange(cur, cur + d + 1)
                sample_pos[i, :d + 1] = poss
                if st.fsm is not None:
                    # column j masks at the state drafts 1..j would reach
                    s_ = st.fsm_state
                    fsm_state[i, 0] = st.fsm_off + s_
                    for j in range(1, d + 1):
                        s_ = st.fsm.next_state(s_, int(toks[j]))
                        fsm_state[i, j] = st.fsm_off + s_
            temps[i] = st.req.temperature
            seeds[i] = st.req.seed
            cur += c
        self._set_step_mix(n_decode, n_draft, total - n_decode - n_draft)
        return _StepBatch(rows, total, tok, tok_pos, tok_bt, tok_adp,
                          sample_rows, sample_pos, fsm_state, temps, seeds,
                          n_decode, n_draft)

    @torch.no_grad()
    def _forward(self, batch: _StepBatch,
                 attention=ragged_paged_attention) -> torch.Tensor:
        """The unified step's model half, eagerly, with ``attention``:
        the trunk over every grid row (KV written into the pool in place;
        each row's adapter), then the vocab head over the sample rows
        only. Returns ``[B * S, V]`` f32 logits, before the grammar
        mask."""
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev, non_blocking=True)

        hidden = self.trunk.forward_paged(
            put(batch.tok), put(batch.tok_pos), put(batch.tok_bt),
            self.pool.layer_caches(), attention=attention,
            adapters=AdapterRows(self.adapters, put(batch.tok_adp)))
        last_h = hidden[put(batch.sample_rows.reshape(-1)).to(torch.int64)]
        return self.model.logits(last_h).to(torch.float32)

    def _land(self, batch: _StepBatch, nxt, finite=None,
              now: Optional[float] = None) -> List[RequestOutput]:
        """Advance every row's slot by what the step computed and land the
        sampled tokens (``nxt`` ``[B * S]``): a final chunk's first token,
        or a decode row's accepted drafts and the token after them.
        ``finite`` flags each sample row's logits: a slot with a
        non-finite one is quarantined (``"nan"``), its sample never
        landed, the KV its chunk wrote as suspect as the sample."""
        B, S = self.max_batch_slots, self._spec_rows
        nxt = np.asarray(nxt).reshape(B, S)
        fin = (None if finite is None
               else np.asarray(finite).reshape(B, S).astype(bool))
        finished: List[RequestOutput] = []
        if now is None:
            now = time.perf_counter()
        for i, toks, _poss, is_chunk, d in batch.rows:
            st = self.slots[i]
            if st is None:
                continue  # an earlier row's callback cancelled it
            if fin is not None and not fin[i, :1 if is_chunk else d + 1].all():
                if is_chunk:
                    st.pos += toks.size
                    self._m_chunk.observe(toks.size)
                finished.append(self._retire_abnormal(st, slot=i,
                                                      reason="nan"))
                continue
            if is_chunk:
                st.pos += toks.size
                self._m_chunk.observe(toks.size)
                self._trace.emit("req.chunk", st.req.req_id,
                                 arg=float(toks.size), t=now)
                if st.prefilling:
                    continue  # mid-prompt: more chunks to go, no token
                if self.prefix_cache is not None and st.req.prefix_cache:
                    # index the prompt's full pages for later admissions;
                    # the nodes created are evicted if this request is
                    # later quarantined
                    st.inserted_nodes = self.prefix_cache.insert(
                        st.req.prompt, int(st.req.prompt.size),
                        self.pool.block_table(st.req.req_id))
                    for node in st.inserted_nodes:
                        self._page_writer[node.page] = st.req.adapter_id
                self._m_prefill.observe(now - st.t_admit)
                self._m_ttft.observe(now - st.req.arrival_t)
                out = self._land_token(st, slot=i, token=int(nxt[i, 0]),
                                       now=now)
                if out is not None:
                    finished.append(out)
                continue
            # column j is the stream's token at position pos + j + 1: the
            # drafts equal to their targets are accepted, then the target
            # of the first mismatch (or the last column) lands as well;
            # rejected drafts' KV is rolled back before anything lands
            targets = nxt[i, :d + 1]
            a = 0
            while a < d and int(toks[a + 1]) == int(targets[a]):
                a += 1
            if d:
                self.stats["spec_drafted"] += d
                self.stats["spec_accepted"] += a
                self._m_spec_drafted.inc(d)
                self._m_spec_accepted.inc(a)
                self._m_spec_accept.observe(a / d)
                self._trace.emit("req.spec_accept", st.req.req_id,
                                 arg=float(a), t=now)
                if a < d:
                    self._trace.emit("req.spec_reject", st.req.req_id,
                                     arg=float(d - a), t=now)
                    self.pool.truncate(st.req.req_id, st.pos + a + 1)
            for t in targets[:a + 1]:
                st.pos += 1
                self._m_itl.observe(now - st.t_last)
                out = self._land_token(st, slot=i, token=int(t), now=now)
                if out is not None:
                    finished.append(out)
                    break
                if self.slots[i] is not st:
                    break  # cancelled from its own stream callback
        return finished

    def _land_token(self, st: _SeqState, slot: int, token: int,
                    now: float) -> Optional[RequestOutput]:
        """Append a sampled token, advance the slot's grammar over it
        (eos has no edge), stream it (isolated; a callback may cancel its
        own request), and retire on eos, length or a finished grammar."""
        st.last_token = token
        st.gen.append(token)
        st.t_last = now
        self.stats["generated_tokens"] += 1
        self._m_tokens.inc()
        self._trace.emit("req.token", st.req.req_id,
                         arg=float(len(st.gen) - 1), t=now)
        if st.fsm is not None and (st.req.eos_token_id is None
                                   or token != st.req.eos_token_id):
            nxt = st.fsm.next_state(st.fsm_state, token)
            if nxt >= 0:
                st.fsm_state = nxt
            self.stats["grammar_tokens"] += 1
            self._m_grammar_tokens.inc()
            self._trace.emit("req.grammar_mask", st.req.req_id,
                             arg=float(st.fsm_state), t=now)
        if st.req.stream_cb is not None:
            cb_err = self._safe_cb(st.req, token, False, len(st.gen) - 1)
            if self.slots[slot] is not st:
                return None  # cancel() retired it inside the callback
            if cb_err is not None:
                return self._retire_abnormal(st, slot=slot, reason="error",
                                             error=cb_err)
        return self._maybe_retire(st, slot=slot)

    # -------------------------------------------------------------- retire
    def _maybe_retire(self, st: _SeqState,
                      slot: int) -> Optional[RequestOutput]:
        req = st.req
        hit_eos = (req.eos_token_id is not None
                   and st.last_token == req.eos_token_id)
        # a grammar that admits no further token but eos is done
        done_fsm = st.fsm is not None and st.fsm.is_complete(st.fsm_state)
        if not (hit_eos or done_fsm) and len(st.gen) < req.max_new_tokens:
            return None
        if st.fsm is not None:
            valid = st.fsm.is_accepting(st.fsm_state)
            self._m_grammar_completions.labels(
                result="valid" if valid else "invalid", **self._lbl).inc()
        self._grammar_release(st)
        if self.pool.has_seq(req.req_id):
            self.pool.free(req.req_id)
        self.slots[slot] = None
        self._m_requests.labels(event="retired", **self._lbl).inc()
        self.stats["finished_requests"] += 1
        out = RequestOutput(req_id=req.req_id, prompt_token_ids=req.prompt,
                            token_ids=list(st.gen),
                            finish_reason=("stop" if hit_eos or done_fsm
                                           else "length"))
        self._trace.emit("req.retire", req.req_id, label=out.finish_reason)
        self._outputs[out.req_id] = out  # before the callback: it may raise
        if req.stream_cb is not None:
            self._safe_cb(req, None, out.finish_reason, len(st.gen))
        return out

    def _safe_cb(self, req: Request, token, finished, seq: int):
        """Call ``req.stream_cb`` isolated: an exception is counted, the
        callback is dropped for the rest of the request, and the
        exception is returned (None on success) for the caller to retire
        the request with ``"error"``. A callback that takes four
        arguments also gets ``seq``, the token's index in the stream (the
        terminal call: the count)."""
        cb = req.stream_cb
        wants_seq = getattr(req, "_cb_wants_seq", None)
        if wants_seq is None:
            wants_seq = _cb_accepts_seq(cb)
            req._cb_wants_seq = wants_seq
        try:
            if wants_seq:
                cb(req.req_id, token, finished, seq)
            else:
                cb(req.req_id, token, finished)
            return None
        except Exception as e:
            self._m_cb_errors.inc()
            req.stream_cb = None
            return e

    def _emit_terminal(self, req: Request, gen, reason: str,
                       error=None) -> RequestOutput:
        """The common tail of every abnormal retirement: the reason's
        counter, the lifecycle counter, the output (registered at once,
        so it is delivered even if the rest of the step raises) and the
        terminal callback."""
        self._reason_counters[reason].inc()
        self._trace.emit("req.retire", req.req_id, label=reason)
        self._m_requests.labels(event="retired", **self._lbl).inc()
        self.stats["finished_requests"] += 1
        out = RequestOutput(req_id=req.req_id, prompt_token_ids=req.prompt,
                            token_ids=list(gen), finish_reason=reason,
                            error=None if error is None else repr(error))
        self._outputs[out.req_id] = out
        if req.stream_cb is not None:
            self._safe_cb(req, None, reason, len(out.token_ids))
        return out

    def _finish_queued(self, req: Request, reason: str) -> RequestOutput:
        """Retire a request that never ran (expired or cancelled while
        queued)."""
        return self._emit_terminal(req, [], reason)

    def _fail_admitted_request(self, req: Request,
                               error: Exception) -> RequestOutput:
        """Retire a request whose admission failed partway; the pages its
        allocation took go back now."""
        if self.pool.has_seq(req.req_id):
            self.pool.free(req.req_id)
        return self._emit_terminal(req, [], "error", error)

    def _retire_abnormal(self, st: _SeqState, slot: int, reason: str,
                         error=None) -> RequestOutput:
        """Retire a live sequence off the eos/length path (timeout,
        cancelled, nan, error): pages freed in this call, slot cleared,
        the tokens so far delivered. A quarantine (``"nan"``) evicts the
        prefix nodes built from the sequence's KV and frees its pages
        with a scrub: masked attention weighs a stale slot 0, and 0 x NaN
        is NaN, so a poisoned page would poison its next owner."""
        req = st.req
        if (reason == "nan" and st.inserted_nodes
                and self.prefix_cache is not None):
            self.prefix_cache.evict_nodes(st.inserted_nodes)
        if self.pool.has_seq(req.req_id):
            self.pool.free(req.req_id, scrub=(reason == "nan"))
        self.slots[slot] = None
        self._grammar_release(st)
        return self._emit_terminal(req, st.gen, reason, error)

    def _sweep_deadlines(self) -> List[RequestOutput]:
        """Retire every request past its deadline, at the top of each
        step: still queued ``"expired"`` (pages never allocated),
        admitted ``"timeout"`` with the tokens so far."""
        finished: List[RequestOutput] = []
        for req in self.scheduler.pop_expired():
            self._trace.emit("req.expire", req.req_id, label=self.engine_id)
            finished.append(self._finish_queued(req, "expired"))
        for i, st in enumerate(self.slots):
            if (st is not None and st.req.deadline is not None
                    and st.req.deadline.expired()):
                finished.append(
                    self._retire_abnormal(st, slot=i, reason="timeout"))
        return finished
