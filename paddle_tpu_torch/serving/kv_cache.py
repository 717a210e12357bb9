"""Paged KV-cache pool with refcounted pages, and the radix prefix cache.

Counterpart of ``paddle_tpu/serving/kv_cache.py`` (``PagedKVCachePool``,
``PrefixCache``), the subset the engine's path uses. Every layer owns a
fixed pool of ``[num_pages, page_size, n_kv_heads, head_dim]`` K and V
pages and a sequence is a list of page ids (its block table), so
admission and retirement move page ids, never KV bytes.

Page 0 is the reserved null page: block tables are 0-padded and the
step's padding rows carry all-zero tables, so their writes land there
instead of in a live sequence. The allocator hands out pages
``1..num_pages-1`` from a LIFO free list.

Allocation is lazy (a page leaves the free list when a token first lands
in it) but admission is accounted against each sequence's worst case
(prompt + max_new_tokens): ``can_admit`` only passes when the pool can
cover every live reservation, so a sequence never runs out mid-decode.

Pages are refcounted. A fork shares every page of its source, and the
prefix cache (:class:`PrefixCache`) holds one reference on each page it
indexes, so a later request whose prompt starts with a cached prefix
adopts those pages instead of prefilling them. A shared page is never
written in place: :meth:`PagedKVCachePool.extend` and
:meth:`~PagedKVCachePool.extend_write` copy a shared page into a fresh
one (copy-on-write) before the step that writes into it, on the device,
driven from the host. Under pressure ``_take_page`` evicts pages that
only the prefix cache holds.

int8 pages (``kv_dtype="int8"``) store codes and carry one f32 absmax
scale per (page, slot, kv head) (``quantization/observers.py``): each
layer's cache is then ``(k, v, k_scale, v_scale)``, and every
page-granular copy copies the scale rows with the bytes.

The page and scale tensors live on the engine's device, keep their
addresses for the pool's life, and are written IN PLACE by the model's
paged forward (so a captured step may hold them); the JAX pool is
functional and swaps in the arrays each compiled step returns.

The host tier: :meth:`PagedKVCachePool.offload_seq` moves a parked
sequence's exclusively owned written pages (bytes and int8 scale rows,
verbatim) into a :class:`HostPageStore` in pinned host memory, returns
the device pages to the free list and journals the sequence's unwritten
tail reservation, so admission sees a parked tenant as preempted.
:meth:`~PagedKVCachePool.prefetch_seq` takes fresh pages and writes the
saved bytes back into the existing page tensors (``index_copy_``), all
or nothing, on the host's schedule before the slot's next step; the
copies are synchronous, so no pinned source is freed under a copy in
flight.

The NaN quarantine: ``free(seq_id, scrub=True)`` marks the pages a
quarantined sequence releases dirty, and :meth:`PagedKVCachePool._take_page`
zeroes every dirty page (bytes and int8 scale rows, one ``index_fill_``
per tensor) in place before one of them re-enters a block table. Masked
attention gives a padding lane weight 0, but 0 x NaN is NaN, so a
poisoned page must never reach a new owner unscrubbed. The scrub is
refcount-aware: a page a fork or the prefix cache still holds is only
marked, and whoever drops the last reference turns the mark into a
scrub. :meth:`PagedKVCachePool.poison_seq` is the drill's fault: NaN
into a sequence's exclusively owned written slots (int8: their scale
rows), in place. Neither ever rebinds a page tensor, so a captured step
reads both at its next replay.

Telemetry: the pool and the prefix cache keep the JAX package's
``paddle_tpu_serving_kv_*`` and ``paddle_tpu_serving_prefix_*``
families, labelled ``{engine_id, model_id}``.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import faults, metrics
from ..device import resolve_device

faults.declare_point(
    "serving.kv_alloc",
    "PagedKVCachePool._take_page, before a page leaves the free list; "
    "arm ResourceExhausted here to drill pool exhaustion")

__all__ = ["PagedKVCachePool", "PrefixCache", "HostPageStore", "page_bytes",
           "normalize_kv_dtype"]

_KV_DTYPE_ALIASES = {
    "f32": torch.float32, "fp32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


def normalize_kv_dtype(dtype) -> torch.dtype:
    """A KV page dtype knob (``"bf16"``, ``"f32"``, ``"int8"`` or a torch
    dtype) as the torch dtype the pool stores; int8 means quantized pages
    with per-slot scales."""
    if isinstance(dtype, str):
        try:
            return _KV_DTYPE_ALIASES[dtype.lower()]
        except KeyError:
            raise ValueError(f"unknown kv_dtype {dtype!r}; expected one of "
                             f"{sorted(_KV_DTYPE_ALIASES)}") from None
    if dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"kv_dtype {dtype} is not supported (f32, bf16 or "
                         "int8)")
    return dtype


def page_bytes(page_size: int, n_kv_heads: int, head_dim: int,
               num_layers: int, kv_dtype=torch.float32) -> int:
    """Device bytes one page costs across all layers, K and V, an int8
    page's 4-byte f32 scale per slot and head included."""
    dt = normalize_kv_dtype(kv_dtype)
    itemsize = torch.empty((), dtype=dt).element_size()
    scale_bytes = 4 if dt == torch.int8 else 0
    return (2 * num_layers * page_size * n_kv_heads
            * (head_dim * itemsize + scale_bytes))


def pages_for_hbm_budget(hbm_bytes: int, page_size: int, n_kv_heads: int,
                         head_dim: int, num_layers: int,
                         kv_dtype=torch.float32) -> int:
    """Pool sizing: how many pages of ``kv_dtype`` fit ``hbm_bytes`` of
    device memory (the caller budgets weights and activations apart)."""
    per = page_bytes(page_size, n_kv_heads, head_dim, num_layers,
                     kv_dtype=kv_dtype)
    return max(int(hbm_bytes) // per, 0)


class HostPageStore:
    """The host page tier: per parked sequence, the block-table indices of
    its offloaded pages (ascending) and their bytes, one host tensor
    ``[num_layers, n_pages, page_size, n_kv_heads, ...]`` per page tensor
    (``k``, ``v`` and, for int8 pages, ``ks``/``vs``), pinned when the
    pool lives on a card, so a restore is one host-to-device copy each.
    Written by :meth:`PagedKVCachePool.offload_seq`, drained by
    :meth:`PagedKVCachePool.prefetch_seq`; bytes are kept verbatim, so a
    round trip is bit-exact. The JAX store keys each page apart; a
    sequence's pages leave and come back together in both."""

    def __init__(self):
        self._seqs: Dict[object, tuple] = {}

    def __len__(self) -> int:
        """Pages held, over every sequence."""
        return sum(len(pages) for pages, _ in self._seqs.values())

    def put(self, seq_id, page_indices: Sequence[int], slabs: dict) -> None:
        self._seqs[seq_id] = (list(page_indices), slabs)

    def pop(self, seq_id):
        """``(page_indices, slabs)`` of ``seq_id``, removed."""
        return self._seqs.pop(seq_id)

    def seq_pages(self, seq_id) -> List[int]:
        """The block-table indices of ``seq_id``'s offloaded pages."""
        return self._seqs[seq_id][0] if seq_id in self._seqs else []

    def drop_seq(self, seq_id) -> int:
        """Discard a retiring sequence's host copies."""
        return len(self._seqs.pop(seq_id, ((), None))[0])


class PagedKVCachePool:
    """Fixed K/V page pool per layer + refcounted block-table allocator.

    Device state: ``k_pools``/``v_pools``, one tensor per layer of shape
    ``[num_pages, page_size, n_kv_heads, head_dim]`` on ``device``
    (default ``cuda``; ``RuntimeError`` without a card unless
    ``device="cpu"``, as every entry point of the port), and for int8
    pages ``k_scales``/``v_scales`` ``[num_pages, page_size,
    n_kv_heads]`` f32.
    Host state: free list, per-page refcounts, per-sequence block tables
    and lengths, worst-case reservations, and the high-water mark
    ``peak_used``; the host tier's ``host_store`` (a parked sequence's
    offloaded pages, whose table entries hold the null page 0), each
    parked sequence's journaled tail reservation, and running totals of
    pages offloaded and prefetched with the seconds each took; the
    quarantine's dirty and scrub-pending pages. ``engine_id`` and
    ``model_id`` label the pool's metric series.
    """

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.float32,
                 device=None, engine_id: str = "", model_id: str = ""):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        self._lbl = {"engine_id": str(engine_id), "model_id": str(model_id)}
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = normalize_kv_dtype(dtype)
        self.quantized = self.dtype == torch.int8
        self.device = resolve_device(device)
        shape = (self.num_pages, self.page_size, self.n_kv_heads,
                 self.head_dim)

        def zeros(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=self.device)
                    for _ in range(self.num_layers)]

        self.k_pools: List[torch.Tensor] = zeros(shape, self.dtype)
        self.v_pools: List[torch.Tensor] = zeros(shape, self.dtype)
        self.k_scales: Optional[List[torch.Tensor]] = None
        self.v_scales: Optional[List[torch.Tensor]] = None
        if self.quantized:
            self.k_scales = zeros(shape[:3], torch.float32)
            self.v_scales = zeros(shape[:3], torch.float32)
        # LIFO: a just-freed page is the next handed out
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._ref = np.zeros(self.num_pages, np.int32)
        # free pages a quarantine released, zeroed when one is next taken
        self._dirty: set = set()
        # pages a quarantine released while another holder still reads
        # them: dirty once the last reference drops
        self._scrub_pending: set = set()
        self.prefix_cache: Optional["PrefixCache"] = None
        self._tables: Dict[object, List[int]] = {}
        self._lens: Dict[object, int] = {}
        self._resv: Dict[object, int] = {}
        self.peak_used = 0
        self.cow_copies = 0
        self.host_store = HostPageStore()
        self._parked_resv: Dict[object, int] = {}
        self.offloaded_total = 0
        self.prefetched_total = 0
        self.offload_seconds = 0.0
        self.prefetch_seconds = 0.0
        reg = metrics.get_registry()
        _eng = ("engine_id", "model_id")
        self._m_pages_used = reg.gauge(
            "paddle_tpu_serving_kv_pages_used",
            "KV pages currently allocated out of the pool",
            labels=_eng).labels(**self._lbl)
        self._m_pages_total = reg.gauge(
            "paddle_tpu_serving_kv_pages_total",
            "Usable KV pages in the pool (page 0 reserved excluded)",
            labels=_eng).labels(**self._lbl)
        self._m_page_events = reg.counter(
            "paddle_tpu_serving_kv_page_events_total",
            "Page allocator traffic", labels=("event",) + _eng)
        tier = reg.gauge(
            "paddle_tpu_serving_kv_page_tier",
            "KV pages currently resident per tier: hbm = pages pinned by "
            "live sequences, host = pages parked in the HostPageStore",
            labels=("tier",) + _eng)
        self._m_tier_hbm = tier.labels(tier="hbm", **self._lbl)
        self._m_tier_host = tier.labels(tier="host", **self._lbl)
        self._m_offload = reg.counter(
            "paddle_tpu_serving_kv_offload_pages_total",
            "KV pages swapped HBM → host by offload_seq (parked tenants)",
            labels=_eng).labels(**self._lbl)
        self._m_prefetch = reg.counter(
            "paddle_tpu_serving_kv_prefetch_pages_total",
            "KV pages swapped host → HBM by prefetch_seq (unpark)",
            labels=_eng).labels(**self._lbl)
        self._m_scale_clips = reg.counter(
            "paddle_tpu_serving_kv_dequant_scale_clip_total",
            "Quantized KV slots written at the absmax scale floor "
            "(absmax underflowed KV_SCALE_FLOOR — dynamic range lost)",
            labels=_eng).labels(**self._lbl)
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        """Re-set the pool gauges after every allocator event, the totals
        too, so a registry ``reset()`` heals at the next event."""
        self._m_pages_used.set(self.used_pages)
        self._m_pages_total.set(self.usable_pages)
        self._m_tier_hbm.set(self.used_pages)
        self._m_tier_host.set(len(self.host_store))

    # ---------------------------------------------------------- accounting
    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def used_pages(self) -> int:
        """Pages pinned by live sequences; pages only the prefix cache
        holds are reclaimable and not counted."""
        return (self.usable_pages - len(self._free)
                - self._reclaimable_pages())

    def _reclaimable_pages(self) -> int:
        return (self.prefix_cache.reclaimable_pages()
                if self.prefix_cache is not None else 0)

    def utilization(self) -> float:
        return self.used_pages / max(self.usable_pages, 1)

    def pages_needed(self, n_tokens: int) -> int:
        return max(math.ceil(int(n_tokens) / self.page_size), 1)

    def _unallocated_reserved(self) -> int:
        """Pages promised to live sequences but not drawn yet."""
        return sum(max(r - len(self._tables[s]), 0)
                   for s, r in self._resv.items())

    def can_admit(self, max_total_tokens: int, pending_pages: int = 0,
                  cached_pages: int = 0, pending_cached: int = 0) -> bool:
        """True when the pool covers a new sequence's worst case on top of
        every live reservation. ``pending_pages`` charges requests admitted
        earlier in the same scheduler step. ``cached_pages`` discounts the
        pages the prefix cache holds for this prompt (adopted by refcount)
        and takes them, with ``pending_cached`` (those of earlier
        admissions of the step), off the reclaimable side."""
        need = self.pages_needed(max_total_tokens) - int(cached_pages)
        reclaim = max(self._reclaimable_pages() - int(cached_pages)
                      - int(pending_cached), 0)
        avail = len(self._free) + reclaim - self._unallocated_reserved()
        return need + int(pending_pages) <= avail

    # ---------------------------------------------------------- allocation
    def _take_page(self) -> int:
        faults.point("serving.kv_alloc")
        # evict pages only the prefix cache holds before giving up
        while not self._free and self.prefix_cache is not None:
            if not self.prefix_cache.evict_one():
                break
        if not self._free:
            raise RuntimeError(
                "KV page pool exhausted — admission accounting should have "
                "prevented this")
        p = self._free.pop()
        if p in self._dirty:
            self._scrub(sorted(self._dirty))
            self._dirty.clear()
        self._ref[p] = 1
        self.peak_used = max(self.peak_used, self.used_pages)
        self._m_page_events.labels(event="alloc", **self._lbl).inc()
        self._refresh_gauges()
        return p

    def _scrub(self, pages: Sequence[int]) -> None:
        """Zero ``pages`` (bytes and int8 scale rows) of every layer in
        place: one ``index_fill_`` per tensor, whatever the count."""
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        for _name, tensors in self._page_tensors():
            for t in tensors:
                t.index_fill_(0, idx, 0)

    def allocate(self, seq_id, n_tokens: int,
                 max_total_tokens: Optional[int] = None,
                 prefix_pages: Sequence[int] = (),
                 prefix_tokens: int = 0) -> List[int]:
        """Create a sequence holding ``n_tokens`` of KV with a worst-case
        reservation of ``max_total_tokens`` (default ``n_tokens``).
        ``prefix_pages``/``prefix_tokens`` seed the table with shared
        pages (a prefix-cache hit), adopted by refcount before any fresh
        page is taken. Returns the block table."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        if prefix_tokens and int(prefix_tokens) % self.page_size:
            raise ValueError(
                f"prefix_tokens {prefix_tokens} must be page-aligned "
                f"(page_size={self.page_size})")
        table: List[int] = []
        for p in prefix_pages:
            self._ref[p] += 1
            table.append(int(p))
        self._tables[seq_id] = table
        self._lens[seq_id] = int(prefix_tokens)
        self._resv[seq_id] = self.pages_needed(
            max_total_tokens if max_total_tokens is not None else n_tokens)
        if int(n_tokens) > int(prefix_tokens):
            try:
                self.extend(seq_id, n_tokens)
            except Exception:
                # atomic: a failure midway (exhaustion, an armed
                # serving.kv_alloc fault) leaves no half-built sequence
                self.free(seq_id)
                raise
        self.peak_used = max(self.peak_used, self.used_pages)
        return list(self._tables[seq_id])

    def extend(self, seq_id, total_tokens: int) -> None:
        """Grow ``seq_id``'s table to cover ``total_tokens`` of KV, and
        make the page of the last slot (the one about to be written) this
        sequence's own (copy-on-write)."""
        self._assert_resident(seq_id, "extend")
        table = self._tables[seq_id]
        need = self.pages_needed(total_tokens)
        while len(table) < need:
            table.append(self._take_page())
        self._lens[seq_id] = max(self._lens[seq_id], int(total_tokens))
        if int(total_tokens) > 0:
            self._ensure_page_writable(
                seq_id, (int(total_tokens) - 1) // self.page_size)

    def extend_write(self, seq_id, start: int, total_tokens: int) -> None:
        """Cover positions ``start .. total_tokens-1`` (a prompt chunk or
        a draft burst) before the step writes them, making every page
        they touch this sequence's own (copy-on-write)."""
        start, total = int(start), int(total_tokens)
        if total <= start:
            return
        self._assert_resident(seq_id, "extend_write")
        table = self._tables[seq_id]
        need = self.pages_needed(total)
        while len(table) < need:
            table.append(self._take_page())
        self._lens[seq_id] = max(self._lens[seq_id], total)
        for pi in range(start // self.page_size,
                        (total - 1) // self.page_size + 1):
            self._ensure_page_writable(seq_id, pi)

    def truncate(self, seq_id, total_tokens: int) -> None:
        """Roll ``seq_id``'s KV length back to ``total_tokens`` (rejected
        drafts). The pages stay in the table, inside the reservation;
        their stale slots lie past every row's length, so attention never
        reads them, and the next write lands over them."""
        total = int(total_tokens)
        cur = self._lens[seq_id]
        if total < 0 or total > cur:
            raise ValueError(
                f"truncate({seq_id!r}, {total}) outside [0, {cur}] — "
                f"rollback can only shorten a sequence")
        self._lens[seq_id] = total

    def _ensure_page_writable(self, seq_id, pi: int) -> None:
        """Copy-on-write of block-table entry ``pi``: a page another
        holder references is copied (bytes and, for int8 pages, scale
        rows) into a fresh page, on the device, and the entry swapped."""
        table = self._tables[seq_id]
        old = table[pi]
        if self._ref[old] <= 1:
            return
        fresh = self._take_page()
        for _name, tensors in self._page_tensors():
            for t in tensors:
                t[fresh].copy_(t[old])
        table[pi] = fresh
        self._ref[old] -= 1  # ours only: it was > 1
        self.cow_copies += 1
        self._m_page_events.labels(event="cow", **self._lbl).inc()
        self.peak_used = max(self.peak_used, self.used_pages)
        self._refresh_gauges()

    def _release_ref(self, p: int, scrub: bool = False) -> bool:
        """Drop one reference on page ``p``; True when it went back to the
        free list. Every release path (retirement, eviction, offload)
        goes through here. ``scrub`` (a quarantine) while another holder
        still reads the page only marks it scrub-pending; whoever drops
        the last reference, scrubbing or not, then marks it dirty, so
        :meth:`_take_page` zeroes it before reuse."""
        self._ref[p] -= 1
        if self._ref[p] > 0:
            if scrub:
                self._scrub_pending.add(p)
            return False
        self._free.append(p)
        if scrub or p in self._scrub_pending:
            self._dirty.add(p)
        self._scrub_pending.discard(p)
        self._m_page_events.labels(event="free", **self._lbl).inc()
        return True

    def free(self, seq_id, scrub: bool = False) -> None:
        """Retire a sequence now: each of its pages loses this reference,
        and those no one else holds go back to the free list; with
        ``scrub`` (the NaN quarantine) they are zeroed before reuse, at
        once or when their last other holder lets go. A parked
        sequence's host copies are dropped; its offloaded entries (the
        null page) release nothing."""
        table = self._tables.pop(seq_id)
        self._lens.pop(seq_id)
        self._resv.pop(seq_id, None)
        self._parked_resv.pop(seq_id, None)
        off = set(self.host_store.seq_pages(seq_id))
        self.host_store.drop_seq(seq_id)
        for pi, p in enumerate(table):
            if pi not in off:
                self._release_ref(p, scrub=scrub)
        self._refresh_gauges()

    def fork(self, src_id, dst_id, max_total_tokens: Optional[int] = None
             ) -> List[int]:
        """``dst_id`` shares every page of ``src_id`` by refcount; the
        first write into a shared page copies it."""
        if dst_id in self._tables:
            raise ValueError(f"sequence {dst_id!r} already allocated")
        self._assert_resident(src_id, "fork")
        src = self._tables[src_id]
        n = self._lens[src_id]
        for p in src:
            self._ref[p] += 1
        self._tables[dst_id] = list(src)
        self._lens[dst_id] = n
        self._resv[dst_id] = self.pages_needed(
            max_total_tokens if max_total_tokens is not None else n)
        self.peak_used = max(self.peak_used, self.used_pages)
        return list(src)

    # ----------------------------------------------------------- host tier
    def _page_tensors(self):
        """``(name, per-layer tensors)`` of everything a page holds: k and
        v, and for int8 pages their scale rows."""
        out = [("k", self.k_pools), ("v", self.v_pools)]
        if self.quantized:
            out += [("ks", self.k_scales), ("vs", self.v_scales)]
        return out

    def _assert_resident(self, seq_id, op: str) -> None:
        """Writes and forks need every page on the device: an offloaded
        table entry is the null page 0."""
        n = self.offloaded_pages(seq_id)
        if n:
            raise RuntimeError(
                f"{op}({seq_id!r}): sequence has {n} offloaded page(s) — "
                f"prefetch_seq() must restore them first")

    def offloaded_pages(self, seq_id=None) -> int:
        """Pages on the host tier, for one sequence or pool-wide."""
        if seq_id is not None:
            return len(self.host_store.seq_pages(seq_id))
        return len(self.host_store)

    def spare_pages(self) -> int:
        """Pages the pool could hand out now without breaking any live
        reservation: free + cache-reclaimable - promised lazy tails."""
        return (len(self._free) + self._reclaimable_pages()
                - self._unallocated_reserved())

    def prefetch_cost(self, seq_id) -> int:
        """Pages :meth:`prefetch_seq` charges against :meth:`spare_pages`:
        the offloaded pages plus the journaled tail reservation."""
        n = self.offloaded_pages(seq_id)
        if not n:
            return 0
        tail = max(self._parked_resv.get(seq_id, 0)
                   - len(self._tables[seq_id]), 0)
        return n + tail

    def can_prefetch(self, seq_id) -> bool:
        """True when :meth:`prefetch_seq` can restore ``seq_id`` and
        re-assume its tail reservation without overcommitting."""
        if not self.offloaded_pages(seq_id):
            return True
        return self.prefetch_cost(seq_id) <= self.spare_pages()

    def offload_seq(self, seq_id) -> int:
        """Move ``seq_id``'s exclusively owned written pages (bytes and
        scale rows) to the host tier and release them and the sequence's
        unwritten tail reservation (journaled for :meth:`prefetch_seq`).
        Shared pages stay: other holders read them. Returns the pages
        moved; a parked sequence moves none (the JAX pool would move a
        page that became exclusive since; the engine parks once)."""
        if seq_id in self._parked_resv:
            return 0
        t0 = time.perf_counter()
        table = self._tables[seq_id]
        n = int(self._lens[seq_id])
        written = self.pages_needed(n) if n > 0 else 0
        move = [pi for pi in range(min(written, len(table)))
                if self._ref[table[pi]] == 1]
        self._parked_resv[seq_id] = self._resv.get(seq_id, 0)
        self._resv[seq_id] = 0
        if move:
            idx = torch.tensor([table[pi] for pi in move], dtype=torch.int64,
                               device=self.device)
            pin = self.device.type == "cuda"
            slabs = {}
            for name, tensors in self._page_tensors():
                dev = torch.stack([t.index_select(0, idx) for t in tensors])
                slabs[name] = torch.empty(dev.shape, dtype=dev.dtype,
                                          pin_memory=pin)
                slabs[name].copy_(dev)  # synchronous: read back before use
            self.host_store.put(seq_id, move, slabs)
            for pi in move:
                self._release_ref(table[pi])
                table[pi] = 0
            self.offloaded_total += len(move)
            self._m_offload.inc(len(move))
            self._m_page_events.labels(event="offload", **self._lbl).inc(
                len(move))
        self.offload_seconds += time.perf_counter() - t0
        self._refresh_gauges()
        return len(move)

    def prefetch_seq(self, seq_id) -> int:
        """Restore every offloaded page of ``seq_id`` into fresh pages of
        the existing page tensors (bytes and scale rows verbatim) and
        re-assume its journaled tail reservation. All or nothing: if the
        pool cannot cover the restore, the pages taken go back and the
        sequence stays parked. Returns the pages restored."""
        n = self.offloaded_pages(seq_id)
        if not n:
            if seq_id in self._parked_resv:
                self._resv[seq_id] = max(self._parked_resv.pop(seq_id),
                                         self._resv.get(seq_id, 0))
            return 0
        t0 = time.perf_counter()
        table = self._tables[seq_id]
        fresh: List[int] = []
        try:
            for _ in range(n):
                fresh.append(self._take_page())
        except Exception:
            for p in fresh:
                self._release_ref(p)
            self._refresh_gauges()
            raise
        idxs, slabs = self.host_store.pop(seq_id)
        idx = torch.tensor(fresh, dtype=torch.int64, device=self.device)
        for name, tensors in self._page_tensors():
            dev = slabs[name].to(self.device)  # synchronous: slab outlives it
            for li, t in enumerate(tensors):
                t.index_copy_(0, idx, dev[li])
        for pi, p in zip(idxs, fresh):
            table[pi] = p
        if seq_id in self._parked_resv:
            self._resv[seq_id] = max(self._parked_resv.pop(seq_id),
                                     self._resv.get(seq_id, 0))
        self.prefetched_total += len(idxs)
        self._m_prefetch.inc(len(idxs))
        self._m_page_events.labels(event="prefetch", **self._lbl).inc(
            len(idxs))
        self.peak_used = max(self.peak_used, self.used_pages)
        self.prefetch_seconds += time.perf_counter() - t0
        self._refresh_gauges()
        return len(idxs)

    # ----------------------------------------------------- quarantine drill
    def poison_seq(self, seq_id, value: float = float("nan")) -> int:
        """Write ``value`` (NaN by default) into every exclusively owned
        written KV slot of one sequence, all layers, K and V, in place
        (``index_put_``). Shared pages (a fork or the prefix cache holds
        them) are skipped, since attention reads them for other tenants
        too; raises ``ValueError`` when every written page is shared.
        int8 pools poison the scale rows: a code cannot hold NaN, but
        the dequantized value does. Returns the slots poisoned."""
        self._assert_resident(seq_id, "poison_seq")
        n = int(self._lens[seq_id])
        table = np.asarray(self._tables[seq_id], np.int64)
        idx = np.arange(n)
        idx = idx[self._ref[table[idx // self.page_size]] == 1]
        if idx.size == 0:
            raise ValueError(
                f"poison_seq({seq_id!r}): every written page is shared "
                f"(fork sibling or prefix cache holds a reference) — "
                f"poisoning would corrupt healthy tenants; poison a "
                f"sequence with exclusive pages instead")
        pages = torch.from_numpy(table[idx // self.page_size]).to(
            self.device)
        offs = torch.from_numpy(idx % self.page_size).to(self.device)
        targets = ((self.k_scales, self.v_scales) if self.quantized
                   else (self.k_pools, self.v_pools))
        for tensors in targets:
            for t in tensors:
                t.index_put_((pages, offs),
                             torch.tensor(value, dtype=t.dtype,
                                          device=self.device))
        return int(idx.size)

    def count_scale_clips(self, n: int) -> None:
        """Add ``n`` written int8 slots whose absmax scale sat at
        ``KV_SCALE_FLOOR`` (their dynamic range underflowed) to
        ``kv_dequant_scale_clip_total``; the step program counts them on
        the device."""
        if n:
            self._m_scale_clips.inc(n)

    # ------------------------------------------------------------- queries
    def has_seq(self, seq_id) -> bool:
        return seq_id in self._tables

    def seq_len(self, seq_id) -> int:
        return self._lens[seq_id]

    def block_table(self, seq_id) -> List[int]:
        return list(self._tables[seq_id])

    def block_table_array(self, seq_ids: Sequence, width: int) -> np.ndarray:
        """Padded ``[len(seq_ids), width]`` int32 block tables; ``None``
        entries and table tails pad with the null page 0."""
        out = np.zeros((len(seq_ids), width), np.int32)
        for i, s in enumerate(seq_ids):
            if s is None:
                continue
            t = self._tables[s]
            if len(t) > width:
                raise ValueError(f"sequence {s!r} spans {len(t)} pages > "
                                 f"table width {width}")
            out[i, :len(t)] = t
        return out

    def layer_caches(self):
        """Per layer ``(k_pool, v_pool)``, or ``(k_pool, v_pool, k_scale,
        v_scale)`` for int8 pages, as the paged forward takes them."""
        if self.quantized:
            return list(zip(self.k_pools, self.v_pools, self.k_scales,
                            self.v_scales))
        return list(zip(self.k_pools, self.v_pools))

    def device_bytes(self) -> int:
        """Bytes of the page (and scale) tensors on the device."""
        return sum(t.numel() * t.element_size()
                   for _name, tensors in self._page_tensors()
                   for t in tensors)

    # ---------------------------------------------------------- cache hooks
    def attach_prefix_cache(self, cache: "PrefixCache") -> None:
        if self.prefix_cache is not None and self.prefix_cache is not cache:
            raise ValueError("pool already has a prefix cache attached")
        self.prefix_cache = cache

    def prefix_match_len(self, token_ids) -> int:
        """Tokens of ``token_ids`` the attached prefix cache would cover
        (0 without one); a read-only probe."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.probe(token_ids)


class _PrefixNode:
    """One radix-tree edge, one full page of tokens: the path from the
    root spells a prefix, and ``page`` holds the KV of its last page
    (valid only under the whole prefix, which keying each hop by its
    page's token bytes enforces)."""

    __slots__ = ("key", "page", "parent", "children", "last_used",
                 "detached")

    def __init__(self, key: bytes, page: int, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[bytes, "_PrefixNode"] = {}
        self.last_used = 0
        self.detached = False


class PrefixCache:
    """Radix index over cached prompt prefixes -> page lists, built on
    the pool's refcounts: every node holds one reference on its page, a
    sequence that matched it holds its own, so a page is reclaimable
    exactly when the cache's reference is the last.

    Admission :meth:`match`\\ es the longest cached prefix (full pages,
    capped one token short of the prompt, so the final chunk computes the
    first sample), adopts its pages, prefills the rest, and a finished
    prompt :meth:`insert`\\ s its full pages. Eviction is LRU over
    unreferenced leaves, driven by the pool under pressure."""

    def __init__(self, pool: PagedKVCachePool):
        self.pool = pool
        pool.attach_prefix_cache(self)
        self.page_size = pool.page_size
        self._root = _PrefixNode(b"", 0, None)
        self._nodes: Dict[int, _PrefixNode] = {}
        self._page_arr: Optional[np.ndarray] = None
        self._clock = 0
        reg = metrics.get_registry()
        _eng = ("engine_id", "model_id")
        lbl = pool._lbl
        self._m_hits = reg.counter(
            "paddle_tpu_serving_prefix_hits_total",
            "Admissions that matched a cached prefix and prefilled only "
            "their uncovered suffix", labels=_eng).labels(**lbl)
        self._m_misses = reg.counter(
            "paddle_tpu_serving_prefix_misses_total",
            "Admissions that found no cached prefix (full prefill)",
            labels=_eng).labels(**lbl)
        self._m_saved = reg.counter(
            "paddle_tpu_serving_prefill_tokens_saved_total",
            "Prompt tokens NOT prefilled because a cached prefix covered "
            "them (the prefix-cache capacity win)",
            labels=_eng).labels(**lbl)
        self._m_pages = reg.gauge(
            "paddle_tpu_serving_prefix_cached_pages",
            "KV pages currently resident in the prefix cache (shared "
            "pages pinned by live sequences included)",
            labels=_eng).labels(**lbl)
        self._m_evictions = reg.counter(
            "paddle_tpu_serving_prefix_evictions_total",
            "Cache nodes evicted (LRU under pool pressure, or quarantine "
            "of a suspect prefix)", labels=_eng).labels(**lbl)
        self._m_pages.set(0)

    def __len__(self) -> int:
        return len(self._nodes)

    def reclaimable_pages(self) -> int:
        """Resident pages no live sequence references."""
        if not self._nodes:
            return 0
        if self._page_arr is None:
            self._page_arr = np.fromiter(
                (n.page for n in self._nodes.values()), np.int32,
                len(self._nodes))
        return int(np.count_nonzero(self.pool._ref[self._page_arr] == 1))

    def _walk(self, ids, touch: bool) -> List[_PrefixNode]:
        ids = np.asarray(ids, np.int32).reshape(-1)
        max_pages = max(int(ids.size) - 1, 0) // self.page_size
        path: List[_PrefixNode] = []
        cur = self._root
        for i in range(max_pages):
            key = ids[i * self.page_size:(i + 1) * self.page_size].tobytes()
            node = cur.children.get(key)
            if node is None:
                break
            path.append(node)
            cur = node
        if touch and path:
            self._clock += 1
            for n in path:
                n.last_used = self._clock
        return path

    def probe(self, ids) -> int:
        """Match length in tokens, without touching LRU or the counts."""
        return len(self._walk(ids, touch=False)) * self.page_size

    def match(self, ids):
        """``(matched_tokens, page_ids, nodes)`` of the longest cached
        prefix of ``ids``; touches LRU and counts the hit or miss."""
        path = self._walk(ids, touch=True)
        if not path:
            self._m_misses.inc()
            return 0, [], []
        matched = len(path) * self.page_size
        self._m_hits.inc()
        self._m_saved.inc(matched)
        return matched, [n.page for n in path], path

    def insert(self, ids, n_tokens: int, table: Sequence[int]
               ) -> List[_PrefixNode]:
        """Index every full page of ``ids[:n_tokens]``, taking one cache
        reference per new node on the page ``table`` names. A prefix
        already cached keeps its node. Returns the nodes created."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        n_full = min(int(n_tokens), int(ids.size)) // self.page_size
        created: List[_PrefixNode] = []
        cur = self._root
        self._clock += 1
        for i in range(n_full):
            key = ids[i * self.page_size:(i + 1) * self.page_size].tobytes()
            node = cur.children.get(key)
            if node is None:
                node = _PrefixNode(key, int(table[i]), cur)
                cur.children[key] = node
                self.pool._ref[node.page] += 1
                self._nodes[id(node)] = node
                self._page_arr = None
                created.append(node)
            node.last_used = self._clock
            cur = node
        if created:
            self._m_pages.set(len(self._nodes))
            self.pool._refresh_gauges()
        return created

    def _detach(self, node: _PrefixNode, scrub: bool = False) -> bool:
        """Drop one childless node and the cache's page reference
        (scrub-marked for a quarantine); True when the page went back to
        the free list."""
        if node.detached:
            return False
        assert not node.children, "evicting a node with children"
        node.detached = True
        node.parent.children.pop(node.key, None)
        self._nodes.pop(id(node), None)
        self._page_arr = None
        freed = self.pool._release_ref(node.page, scrub=scrub)
        self._m_evictions.inc()
        self._m_pages.set(len(self._nodes))
        return freed

    def evict_one(self) -> bool:
        """Evict the least recently used unreferenced leaf; True when a
        page went back to the free list."""
        best: Optional[_PrefixNode] = None
        for n in self._nodes.values():
            if n.children or self.pool._ref[n.page] != 1:
                continue
            if best is None or n.last_used < best.last_used:
                best = n
        if best is None:
            return False
        freed = self._detach(best)
        self.pool._refresh_gauges()
        return freed

    def evict_nodes(self, nodes: Sequence[_PrefixNode]) -> None:
        """The quarantine's eviction: drop ``nodes`` and their subtrees,
        so a prefix built from a poisoned request's KV never serves
        another admission. Pages live sequences still hold stay theirs;
        the releases are scrub-marked."""
        for node in nodes:
            self._evict_subtree(node, scrub=True)
        self.pool._refresh_gauges()

    def clear(self) -> int:
        """Drop every node (required after a weight change); returns how
        many. No scrub: stale finite bytes are masked like any retired
        page's."""
        n = len(self._nodes)
        for child in list(self._root.children.values()):
            self._evict_subtree(child, scrub=False)
        self.pool._refresh_gauges()
        return n

    def _evict_subtree(self, node: _PrefixNode, scrub: bool) -> None:
        if node.detached:
            return
        for child in list(node.children.values()):
            self._evict_subtree(child, scrub)
        self._detach(node, scrub=scrub)
