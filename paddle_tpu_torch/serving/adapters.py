"""Batched multi-LoRA serving: stacked rank-r adapter weights that ride the
serving step as data.

Counterpart of ``paddle_tpu/serving/adapters.py``. An :class:`AdapterStore`
holds up to ``capacity`` named LoRA adapters for every projection site the
trunk exposes (``model.lora_sites()``), stacked along a leading adapter
axis, as :meth:`AdapterStore.arrays` shows them::

    A[site]: [capacity, n_layers, rank, in_dim ]
    B[site]: [capacity, n_layers, out_dim, rank]

Slot 0 is reserved as the zero-delta identity: its weights are all zeros,
so a request with no adapter (``adapter_id=None``, slot 0) computes
``base(x) + 0``, bit for bit a store-less step.

The stacks live on the engine's device, allocated once. :meth:`register`
and :meth:`unregister` write into that storage in place (``copy_`` and
``zero_``, never a new tensor), so a step captured as a CUDA graph, which
reads the stacks by address, sees a hot-swap at its next replay with no
recapture; the JAX store rebinds its arrays instead and passes them to
the compiled step as arguments.

The storage is layer-major (``[n_layers, capacity * rank, dim]`` for both
A and B), so one layer's slab of every slot is a contiguous matrix;
:meth:`arrays` returns permuted views of it in the JAX package's shapes.
That is what :func:`grouped_lora_delta` computes over: where the JAX step
gathers each grid row's whole ``[T, n_layers, rank, in]`` stacks
(``lora_delta``), the port multiplies the rows by every slot's A at once,
keeps each row's own slot's ``rank`` columns (exact zeros elsewhere) and
multiplies by every slot's B, two small products per site and layer that
read the stacks once whatever ``T`` is. Sites that read the same input
(q, k and v; gate and up) keep their A slabs side by side in one tensor
(``groups``), so :meth:`AdapterRows.apply_group` takes their A products
and the slot mask in one launch each: at a decode step's few rows these
products cost their launches, not their arithmetic.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["AdapterStore", "AdapterRows", "random_adapter", "lora_delta",
           "grouped_lora_delta"]


def lora_delta(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               layer: int) -> torch.Tensor:
    """The JAX package's per-row LoRA delta: ``delta[t] = B[t, layer] @
    (A[t, layer] @ x[t])`` where ``A``/``B`` are per-row gathered stacks
    (``[T, L, rank, in]`` / ``[T, L, out, rank]``), computed in the stacks'
    dtype and returned in ``x``'s. Rows whose stacks are zero (slot 0)
    give exact zeros. The step computes the same products with
    :func:`grouped_lora_delta`."""
    al, bl = A[:, layer], B[:, layer]
    h = torch.einsum("tri,ti->tr", al, x.to(al.dtype))
    return torch.einsum("tor,tr->to", bl, h).to(x.dtype)


def grouped_lora_delta(x: torch.Tensor, A_l: torch.Tensor,
                       B_l: torch.Tensor, keep: torch.Tensor,
                       base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``base + delta`` (``delta`` alone without ``base``) for rows ``x``
    ``[T, in]`` whose adapter slots ``keep`` selects: ``A_l`` ``[capacity
    * rank, in]`` and ``B_l`` ``[capacity * rank, out]`` are one layer's
    slabs of every slot, ``keep`` ``[T, capacity * rank]`` is True on each
    row's own slot's ``rank`` columns. Every row is multiplied by every
    slot's A, the other slots' columns are replaced by exact zeros, and
    the product with every slot's B sums the row's own ``rank`` terms (the
    zeros add nothing), so a slot-0 row's delta is exactly 0 and its
    ``base`` comes back bit for bit. Computed in the slabs' dtype, the
    delta returned in ``x``'s as in :func:`lora_delta`."""
    h = torch.where(keep, x.to(A_l.dtype) @ A_l.T, 0.0)
    return _b_product(h, B_l, x.dtype, base)


def _b_product(h: torch.Tensor, B_l: torch.Tensor, dtype: torch.dtype,
               base: Optional[torch.Tensor]) -> torch.Tensor:
    """``h @ B_l`` cast to ``dtype``, or with ``base`` ``base + h @ B_l``:
    in one ``addmm`` where ``base`` has the slabs' dtype (Llama's f32
    projections), else ``base`` plus the delta cast to ``dtype`` (GPT's
    bf16 projections under O2, as the JAX package adds them)."""
    if base is None or base.dtype != h.dtype:
        delta = (h @ B_l).to(dtype)
        return delta if base is None else base + delta
    return torch.addmm(base, h, B_l)


class AdapterStore:
    """Named rank-r LoRA (A, B) pairs, stacked per projection site.

    ``sites`` is an ordered sequence of ``(name, in_dim, out_dim)``
    triples, one per projection the trunk offers a delta at, shared across
    layers. :meth:`arrays` flattens ``[A, B]`` per site in this order.
    ``groups`` lists sites that read the same input (each group's A slabs
    share one tensor); a site in no group is a group of its own.
    ``device`` defaults to ``cuda`` (``RuntimeError`` without a card
    unless ``device="cpu"``)."""

    def __init__(self, sites: Sequence[Tuple[str, int, int]],
                 num_layers: int, rank: int = 4, capacity: int = 4,
                 dtype=torch.float32, device=None,
                 groups: Sequence[Sequence[str]] = ()):
        if capacity < 2:
            raise ValueError(
                f"capacity must be >= 2 (slot 0 is the reserved "
                f"zero-delta identity), got {capacity}")
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.sites = tuple((str(n), int(i), int(o)) for n, i, o in sites)
        if not self.sites:
            raise ValueError("at least one projection site is required")
        self.num_layers = int(num_layers)
        self.rank = int(rank)
        self.capacity = int(capacity)
        self.dtype = dtype
        self.device = resolve_device(device)
        L, cr = self.num_layers, self.capacity * self.rank
        dims = {name: (d_in, d_out) for name, d_in, d_out in self.sites}
        grouped = [tuple(g) for g in groups]
        flat = [n for g in grouped for n in g]
        if len(set(flat)) != len(flat) or not set(flat) <= set(dims) or any(
                len({dims[n][0] for n in g}) != 1 for g in grouped):
            raise ValueError(f"groups {grouped} must be disjoint sets of "
                             f"sites with one input width each")
        grouped += [(n,) for n, _, _ in self.sites if n not in flat]
        # layer-major storage: [L, capacity * rank, dim] for B, and for A
        # the group's sites side by side, [L, n_sites * capacity * rank,
        # in]; slabs[site] are the site's [L, capacity * rank, dim] views
        self.group_a: Dict[Tuple[str, ...], torch.Tensor] = {}
        self.slabs: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._A: Dict[str, torch.Tensor] = {}
        self._B: Dict[str, torch.Tensor] = {}
        for g in grouped:
            self.group_a[g] = torch.zeros((L, len(g) * cr, dims[g[0]][0]),
                                          dtype=dtype, device=self.device)
        for g, a_g in self.group_a.items():
            for i, name in enumerate(g):
                a = a_g[:, i * cr:(i + 1) * cr]
                b = torch.zeros((L, cr, dims[name][1]), dtype=dtype,
                                device=self.device)
                self.slabs[name] = (a, b)
        for name, d_in, d_out in self.sites:
            a, b = self.slabs[name]
            # the JAX shapes, as views of the same storage
            self._A[name] = a.view(L, self.capacity, self.rank,
                                   d_in).permute(1, 0, 2, 3)
            self._B[name] = b.view(L, self.capacity, self.rank,
                                   d_out).permute(1, 0, 3, 2)
        # slot 0 is the identity and is never in this map
        self._slots: Dict[str, int] = {}

    @classmethod
    def from_model(cls, model, rank: int = 4, capacity: int = 4,
                   dtype=torch.float32) -> "AdapterStore":
        """A store shaped for ``model`` by its ``lora_sites()``, on the
        model's device."""
        sites, num_layers = model.lora_sites()
        return cls(sites, num_layers, rank=rank, capacity=capacity,
                   dtype=dtype, device=model.device,
                   groups=model.lora_site_groups())

    # ------------------------------------------------------------ registry
    def register(self, name: str, weights: Dict[str, tuple]) -> int:
        """Install (or hot-swap) adapter ``name``: ``weights`` maps each
        site name to an ``(A, B)`` pair shaped ``[n_layers, rank, in_dim]``
        / ``[n_layers, out_dim, rank]``. Every site must be present. Every
        site is validated before any is written, and the write goes into
        the slot's existing storage. Returns the slot."""
        if name is None or name == "":
            raise ValueError("adapter name must be a non-empty string "
                             "(None means 'no adapter', slot 0)")
        missing = [s for s, _, _ in self.sites if s not in weights]
        if missing:
            raise ValueError(
                f"adapter {name!r} missing sites {missing}; provide an "
                "all-zero (A, B) pair for sites without a delta")
        slot = self._slots.get(name)
        if slot is None:
            used = set(self._slots.values())
            free = [s for s in range(1, self.capacity) if s not in used]
            if not free:
                raise ValueError(
                    f"adapter store full ({self.capacity - 1} slots, "
                    f"holding {sorted(self._slots)}); unregister one or "
                    "raise adapter_capacity")
            slot = free[0]
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        staged = []
        for site, d_in, d_out in self.sites:
            A, B = weights[site]
            A = np.asarray(A, np_dtype)
            B = np.asarray(B, np_dtype)
            want_a = (self.num_layers, self.rank, d_in)
            want_b = (self.num_layers, d_out, self.rank)
            if A.shape != want_a or B.shape != want_b:
                raise ValueError(
                    f"adapter {name!r} site {site!r}: expected A "
                    f"{want_a} / B {want_b}, got {A.shape} / {B.shape}")
            staged.append((site, A, B))
        for site, A, B in staged:
            self._A[site][slot].copy_(torch.from_numpy(A))
            self._B[site][slot].copy_(torch.from_numpy(B))
        self._slots[name] = slot
        return slot

    def unregister(self, name: str) -> None:
        """Zero the adapter's slot in place and free it: a stale index
        degrades to the identity delta, never another tenant's weights."""
        slot = self._slots.pop(name)
        for site, _, _ in self.sites:
            self._A[site][slot].zero_()
            self._B[site][slot].zero_()

    # ------------------------------------------------------------- lookups
    def slot(self, name: Optional[str]) -> int:
        """``name`` -> stacked-array index; ``None`` is the identity."""
        if name is None:
            return 0
        slot = self._slots.get(name)
        if slot is None:
            raise KeyError(
                f"adapter {name!r} not registered here (holding "
                f"{sorted(self._slots)})")
        return slot

    def holds(self, name: Optional[str]) -> bool:
        """True iff this store can serve ``name``; every store holds
        ``None``."""
        return name is None or name in self._slots

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._slots))

    def arrays(self) -> List[torch.Tensor]:
        """``[A, B]`` per site in the fixed site order, in the JAX
        package's shapes (views of the storage, whose addresses never
        change)."""
        out: List[torch.Tensor] = []
        for site, _, _ in self.sites:
            out.append(self._A[site])
            out.append(self._B[site])
        return out

    def __repr__(self) -> str:
        return (f"AdapterStore(sites={len(self.sites)}, "
                f"layers={self.num_layers}, rank={self.rank}, "
                f"capacity={self.capacity}, holding={list(self.names())})")


class AdapterRows:
    """One step's adapter operands: ``store``'s stacks and each grid row's
    slot (``slots`` ``[T]``, an integer tensor on the store's device). The
    trunk's paged forward calls :meth:`apply_group` (or :meth:`apply`) at
    every site of every layer."""

    def __init__(self, store: AdapterStore, slots: torch.Tensor):
        self.store = store
        col_slot = torch.arange(store.capacity * store.rank,
                                device=slots.device) // store.rank
        self.keep = slots.to(torch.int64)[:, None] == col_slot[None, :]
        self._keep_n = {1: self.keep}

    def apply(self, site: str, layer: int, x: torch.Tensor,
              base: torch.Tensor) -> torch.Tensor:
        """``base`` plus the LoRA delta of ``site`` at ``layer`` on rows
        ``x``."""
        a, b = self.store.slabs[site]
        return grouped_lora_delta(x, a[layer], b[layer], self.keep, base)

    def apply_group(self, sites: Tuple[str, ...], layer: int,
                    x: torch.Tensor, bases) -> Tuple[torch.Tensor, ...]:
        """Each of ``bases`` plus its site's delta at ``layer`` on rows
        ``x``, for ``sites`` that form one of the store's groups: one A
        product and one mask for the group, one ``addmm`` a site."""
        a = self.store.group_a[tuple(sites)][layer]
        n = len(sites)
        if n not in self._keep_n:
            self._keep_n[n] = self.keep.repeat(1, n)
        h = torch.where(self._keep_n[n], x.to(a.dtype) @ a.T, 0.0)
        cr = self.store.capacity * self.store.rank
        return tuple(
            _b_product(h[:, i * cr:(i + 1) * cr],
                       self.store.slabs[site][1][layer], x.dtype, base)
            for i, (site, base) in enumerate(zip(sites, bases)))


def random_adapter(store: AdapterStore, seed: int,
                   scale: float = 0.02) -> Dict[str, tuple]:
    """A seeded random weight dict shaped for ``store`` (numpy f32), drawn
    in the JAX package's order, so both packages give bit-equal weights;
    ``scale`` keeps the delta small enough that tiny models stay
    finite."""
    rng = np.random.default_rng(seed)
    out: Dict[str, tuple] = {}
    for site, d_in, d_out in store.sites:
        A = rng.standard_normal(
            (store.num_layers, store.rank, d_in)).astype(np.float32)
        B = rng.standard_normal(
            (store.num_layers, d_out, store.rank)).astype(np.float32)
        out[site] = (A * scale, B * scale)
    return out
