"""Paged KV-cache pool: fixed page pool per layer + per-sequence block tables.

Counterpart of ``paddle_tpu/serving/kv_cache.py`` (``PagedKVCachePool``),
the subset the engine's main path uses. Every layer owns a fixed pool of
``[num_pages, page_size, n_kv_heads, head_dim]`` K and V pages and a
sequence is a list of page ids (its block table), so admission and
retirement move page ids, never KV bytes.

Page 0 is the reserved null page: block tables are 0-padded and the
step's padding rows carry all-zero tables, so their writes land there
instead of in a live sequence. The allocator hands out pages
``1..num_pages-1`` from a LIFO free list.

Allocation is lazy (a page leaves the free list when a token first lands
in it) but admission is accounted against each sequence's worst case
(prompt + max_new_tokens): ``can_admit`` only passes when the pool can
cover every live reservation, so a sequence never runs out mid-decode.

The page tensors live on the engine's device and are written IN PLACE by
the model's paged forward; the JAX pool is functional and swaps in the
arrays each compiled step returns. Prefix caching, copy-on-write forks,
int8 pages and the host tier are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["PagedKVCachePool", "page_bytes", "normalize_kv_dtype"]

_KV_DTYPE_ALIASES = {
    "f32": torch.float32, "fp32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}


def normalize_kv_dtype(dtype) -> torch.dtype:
    """A KV page dtype knob (``"bf16"``, ``"f32"`` or a torch dtype) as the
    torch dtype the pool stores."""
    if isinstance(dtype, str):
        try:
            return _KV_DTYPE_ALIASES[dtype.lower()]
        except KeyError:
            raise ValueError(f"unknown kv_dtype {dtype!r}; expected one of "
                             f"{sorted(_KV_DTYPE_ALIASES)}") from None
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kv_dtype {dtype} is not supported (f32 or bf16)")
    return dtype


def page_bytes(page_size: int, n_kv_heads: int, head_dim: int,
               num_layers: int, kv_dtype=torch.float32) -> int:
    """Device bytes one page costs across all layers, K and V."""
    itemsize = torch.empty((), dtype=normalize_kv_dtype(kv_dtype)).element_size()
    return 2 * num_layers * page_size * n_kv_heads * head_dim * itemsize


class PagedKVCachePool:
    """Fixed K/V page pool per layer + block-table allocator.

    Device state: ``k_pools``/``v_pools``, one tensor per layer of shape
    ``[num_pages, page_size, n_kv_heads, head_dim]`` on ``device``
    (default ``cuda``; ``RuntimeError`` without a card unless
    ``device="cpu"``, as every entry point of the port).
    Host state: free list, per-sequence block tables, worst-case
    reservations, and the high-water mark ``peak_used``.
    """

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.float32,
                 device=None):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = normalize_kv_dtype(dtype)
        self.device = resolve_device(device)
        shape = (self.num_pages, self.page_size, self.n_kv_heads,
                 self.head_dim)
        self.k_pools: List[torch.Tensor] = [
            torch.zeros(shape, dtype=self.dtype, device=self.device)
            for _ in range(self.num_layers)]
        self.v_pools: List[torch.Tensor] = [
            torch.zeros(shape, dtype=self.dtype, device=self.device)
            for _ in range(self.num_layers)]
        # LIFO: a just-freed page is the next handed out
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._tables: Dict[object, List[int]] = {}
        self._resv: Dict[object, int] = {}
        self.peak_used = 0

    # ---------------------------------------------------------- accounting
    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free)

    def utilization(self) -> float:
        return self.used_pages / max(self.usable_pages, 1)

    def pages_needed(self, n_tokens: int) -> int:
        return max(math.ceil(int(n_tokens) / self.page_size), 1)

    def _unallocated_reserved(self) -> int:
        """Pages promised to live sequences but not drawn yet."""
        return sum(max(r - len(self._tables[s]), 0)
                   for s, r in self._resv.items())

    def can_admit(self, max_total_tokens: int,
                  pending_pages: int = 0) -> bool:
        """True when the pool covers a new sequence's worst case on top of
        every live reservation. ``pending_pages`` charges requests admitted
        earlier in the same scheduler step, whose reservations are not
        recorded here yet."""
        avail = len(self._free) - self._unallocated_reserved()
        return (self.pages_needed(max_total_tokens) + int(pending_pages)
                <= avail)

    # ---------------------------------------------------------- allocation
    def _take_page(self) -> int:
        if not self._free:
            raise RuntimeError(
                "KV page pool exhausted — admission accounting should have "
                "prevented this")
        p = self._free.pop()
        self.peak_used = max(self.peak_used, self.used_pages)
        return p

    def allocate(self, seq_id, n_tokens: int,
                 max_total_tokens: int = None) -> List[int]:
        """Create a sequence holding ``n_tokens`` of KV with a worst-case
        reservation of ``max_total_tokens`` (default ``n_tokens``).
        Returns the block table."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        self._tables[seq_id] = []
        self._resv[seq_id] = self.pages_needed(
            max_total_tokens if max_total_tokens is not None else n_tokens)
        if int(n_tokens) > 0:
            try:
                self.extend(seq_id, n_tokens)
            except RuntimeError:
                self.free(seq_id)  # atomic: no half-built sequence
                raise
        return list(self._tables[seq_id])

    def extend(self, seq_id, total_tokens: int) -> None:
        """Grow ``seq_id``'s table to cover ``total_tokens`` of KV."""
        table = self._tables[seq_id]
        need = self.pages_needed(total_tokens)
        while len(table) < need:
            table.append(self._take_page())

    def extend_write(self, seq_id, start: int, total_tokens: int) -> None:
        """Cover positions ``start .. total_tokens-1`` (a prompt chunk)
        before the step writes them. Without shared pages there is no
        copy-on-write seam, so this is :meth:`extend` over the range."""
        if int(total_tokens) > int(start):
            self.extend(seq_id, total_tokens)

    def free(self, seq_id) -> None:
        """Retire a sequence now: its pages go back to the free list."""
        table = self._tables.pop(seq_id)
        self._resv.pop(seq_id, None)
        self._free.extend(table)

    # ------------------------------------------------------------- queries
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
        """``[(k_pool, v_pool)]`` per layer, as the paged forward takes
        them."""
        return list(zip(self.k_pools, self.v_pools))
