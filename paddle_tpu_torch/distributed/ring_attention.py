"""Ring attention: exact attention over a sequence split across the ranks
of a mesh axis (``paddle_tpu/distributed/ring_attention.py``).

The JAX package runs one program over the mesh: q/k/v ``[B, S, H, D]``
are sharded on S over ``sep``, and inside ``shard_map`` every device
streams the k/v blocks around the ring with ``ppermute``, running K1 on
each block and merging the blocks' log-sum-exps. The port runs one
process per rank, each holding its chunk ``[B, C, H, D]`` (``C = S / P``,
rank ``r`` the rows ``[r C, (r+1) C)``):

- **Forward** (:func:`ring_block_forward`). Step ``i`` holds the k/v
  block of rank ``(r - i) mod P`` and runs K1 (``ops/flash_attention.py``
  ``flash_fwd``) of the local q against it: the diagonal block causal
  (K1's causal mask is aligned to the bottom right, and the diagonal
  block has ``Sq = Sk = C``, so it is the plain lower triangle), past
  blocks whole, and under ``causal`` future blocks skipped without a
  launch. Each block's ``(O_i, LSE_i)`` is merged in f32 by the JAX rule:
  ``m = max(m, lse_i)``, ``acc = acc e^(m_old - m) + O_i e^(lse_i - m)``,
  ``l = l e^(m_old - m) + e^(lse_i - m)``, ``out = acc / l``, and the
  merged ``LSE = m + log l`` is kept for the backward. The first merged
  block starts the carry (``m = lse_i``, ``l = 1``), so no ``-inf``
  enters the merge: a skipped block is never merged, and K1 gives a row
  with no key an LSE of about -1e30, not ``-inf``. The k/v move one hop a
  step through ``collective.batch_isend_irecv`` (one permutation, staged
  through the host on gloo for CUDA tensors); the JAX scan's last hop
  feeds nothing, so there are ``P - 1``.
- **Backward** (:func:`ring_block_backward`), unlike the JAX package's,
  which recomputes through the einsum formulation's VJP and so forms a
  ``[C, C]`` score block a step: the kernels take an outside LSE, so
  ``Delta = rowsum(dO O)`` is formed once from the merged O
  (``flash_delta``), and each block runs K2 (``dQ += flash_dq``) and K3
  (``flash_dkv``) with the merged LSE, which gives the global softmax
  probabilities. A block's dK/dV accumulate in f32 as they travel with
  it, and one more hop brings them home to the rank that owns it.
- The block loops take their blocks through a *hop*: :class:`RingHop`
  (the ring's sends and receives) or :class:`ListHop` (one process
  holding every block, as the card's check of the loop and the CPU tests
  drive it).

Gradients are the true gradients of one loss that every rank computes
from the same gathered values (Megatron's convention, as the port's
``mp`` layers): :func:`split_sequence` gathers its gradient,
:func:`gather_sequence` takes this rank's block of it. A weight every
rank holds is used by each rank's chunk, so its gradient on a rank is
that chunk's share, summed over ``sep`` by ``fleet.distributed_model``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops import flash_attention as fa
from ..tensor import facade_io
from . import collective, topology

__all__ = ["ring_attention", "ring_attention_local", "ring_block_forward",
           "ring_block_backward", "RingHop", "ListHop", "split_sequence",
           "gather_sequence", "all_gather_sequence", "sep_group",
           "refuse_beside_sep", "hop_bytes"]

# bytes each rank sent around the ring so far (forward and backward
# hops): read and zeroed by the card's drills
hop_bytes = [0]


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, C]`` per-row values as ``[B, C, H, 1]``, to scale O."""
    return x.transpose(1, 2).unsqueeze(-1)


def _merge(acc, m, l, o, lse):
    """Fold one block's ``(O_i, LSE_i [B, H, C])`` into the f32 carry
    ``(acc, m, l)`` (module docstring); a carry of None starts it."""
    if acc is None:
        return o.float(), lse, torch.ones_like(lse)
    m_new = torch.maximum(m, lse)
    alpha = torch.exp(m - m_new)
    w = torch.exp(lse - m_new)
    return acc * _rows(alpha) + o.float() * _rows(w), m_new, l * alpha + w


def _skipped(causal: bool, src: int, rank: int) -> bool:
    return causal and src > rank


def ring_block_forward(q, hop, rank: int, world: int, causal: bool,
                       scale: float):
    """``(O [B, C, H, D] in q's dtype, LSE [B*H, C] f32)`` of the local
    queries ``q`` over every block, step ``i`` taking block ``(rank - i)
    mod world`` from ``hop.kv(i)`` (module docstring)."""
    B, C, H, _ = q.shape
    acc = m = l = None
    for i in range(world):
        k, v = hop.kv(i)
        src = (rank - i) % world
        if _skipped(causal, src, rank):
            continue
        o, lse = fa.flash_fwd(q, k, v, causal=causal and src == rank,
                              scale=scale)
        acc, m, l = _merge(acc, m, l, o, lse.view(B, H, C))
    out = (acc / _rows(l)).to(q.dtype)
    return out, (m + torch.log(l)).reshape(B * H, C)


def ring_block_backward(q, do, out, lse, hop, rank: int, world: int,
                        causal: bool, scale: float) -> torch.Tensor:
    """dQ of the local queries; each block's dK/dV are handed to
    ``hop.add_grads`` (module docstring). ``out`` and ``lse`` are the
    forward's merged ones."""
    delta = fa.flash_delta(out, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i in range(world):
        k, v = hop.kv(i)
        src = (rank - i) % world
        if _skipped(causal, src, rank):
            continue
        kw = dict(causal=causal and src == rank, scale=scale)
        dq += fa.flash_dq(q, k, v, do, lse, delta, **kw).float()
        hop.add_grads(*fa.flash_dkv(q, k, v, do, lse, delta, **kw))
    return dq.to(q.dtype)


class ListHop:
    """One process holding every rank's block: ``kv(i)`` is block ``(rank
    - i) mod P`` of ``ks``/``vs``, and ``add_grads`` adds into that block's
    entry of ``dks``/``dvs`` (f32, shared by the ranks' loops)."""

    def __init__(self, ks, vs, rank: int, dks=None, dvs=None):
        self.ks, self.vs, self.rank = ks, vs, rank
        self.dks, self.dvs = dks, dvs
        self._src = rank

    def kv(self, i: int):
        self._src = (self.rank - i) % len(self.ks)
        return self.ks[self._src], self.vs[self._src]

    def add_grads(self, dk, dv):
        self.dks[self._src] += dk.float()
        self.dvs[self._src] += dv.float()


def _pack(tensors):
    """One uint8 buffer holding ``tensors``, each on a 16-byte boundary
    (the bf16 kernels' alignment)."""
    parts = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        pad = (-b.numel()) % 16
        if pad:
            parts.append(b.new_zeros(pad))
    return torch.cat(parts)


def _unpack(buf, like):
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[off:off + n].view(t.dtype).view(t.shape))
        off += n + (-n) % 16
    return out


class RingHop:
    """The ring over ``group``: ``kv(0)`` is this rank's ``(k, v)``; each
    later ``kv(i)`` sends the block held to the next rank and receives the
    previous rank's. With ``grads`` (the backward) the block's f32 dK/dV
    travel with it, :meth:`add_grads` adding this rank's share, and
    :meth:`grads` makes one more hop, which brings this rank's own
    block's dK/dV home."""

    def __init__(self, k, v, group, grads: bool = False):
        self.group = group
        self.held = [k, v]
        self.grads_held = [torch.zeros(t.shape, dtype=torch.float32,
                                       device=t.device)
                           for t in self.held] if grads else []

    def _exchange(self, tensors):
        send = _pack(tensors)
        recv = torch.empty_like(send)
        collective.batch_isend_irecv([
            collective.P2POp(collective.isend, send, 1, self.group),
            collective.P2POp(collective.irecv, recv, -1, self.group)])
        hop_bytes[0] += send.numel()
        return _unpack(recv, tensors)

    def kv(self, i: int):
        if i > 0:
            got = self._exchange(self.grads_held + self.held)
            self.grads_held, self.held = got[:-2], got[-2:]
        return tuple(self.held)

    def add_grads(self, dk, dv):
        self.grads_held[0] += dk.float()
        self.grads_held[1] += dv.float()

    def grads(self):
        return tuple(self._exchange(self.grads_held))


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        rank, world = group.rank, group.nranks
        out, lse = ring_block_forward(q, RingHop(k, v, group), rank, world,
                                      causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.args
        hop = RingHop(k, v, group, grads=True)
        dq = ring_block_backward(q, do.contiguous(), out, lse, hop,
                                 group.rank, group.nranks, causal, scale)
        dk, dv = hop.grads()
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention_local(q, k, v, causal: bool = False,
                         scale: Optional[float] = None, group=None):
    """Attention of this rank's chunks ``[B, C, H, D]`` over the whole
    sequence split across ``group`` (rank ``r`` of it holding rows ``[r C,
    (r+1) C)``): this rank's output chunk, differentiable in q, k and v
    (module docstring). ``group`` defaults to the current mesh's ``sep``
    group."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    group = group or sep_group(True)
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), group, bool(causal), scale)


# ------------------------------------------------ the sequence split


def sep_group(enabled: bool = True, axis: str = "sep", mesh=None):
    """The current mesh's ``axis`` group when ``enabled`` and that axis is
    above 1, else None."""
    mesh = mesh or topology.get_mesh()
    if not enabled or topology.axis_size(axis, mesh) <= 1:
        return None
    return mesh.group(axis)


def refuse_beside_sep() -> None:
    """Sequence parallelism beside ``mp``, ``pp`` or ``sharding`` above 1
    is not ported (the models' ``sep`` paths and the reducer): raise."""
    for axis in ("mp", "pp", "sharding"):
        if topology.axis_size(axis) > 1:
            raise NotImplementedError(
                f"sequence parallelism beside {axis} above 1 is not ported")


def _block(x, group, dim):
    n = x.shape[dim] // group.nranks
    return x.narrow(dim, group.rank * n, n)


def _gather(x, group, dim):
    parts = []
    collective.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _sum_block(g, group, dim):
    g = g.contiguous().clone()
    collective.all_reduce(g, group=group)
    return _block(g, group, dim).contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.args = (group, dim, summed)
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, summed = ctx.args
        g = _sum_block(g, group, dim) if summed else \
            _block(g, group, dim).contiguous()
        return g, None, None, None


def split_sequence(x, group, dim: int = 1):
    """This rank's block of ``x`` along ``dim`` (the whole sequence every
    rank holds); its gradient is gathered. ``ValueError`` when the
    group's size does not divide the sequence, as the JAX package
    raises."""
    if x.shape[dim] % group.nranks:
        raise ValueError(
            f"sequence length {x.shape[dim]} not divisible by "
            f"{group.axis or 'sep'} degree {group.nranks}")
    if not x.requires_grad:
        return _block(x, group, dim).contiguous()
    return _Split.apply(x, group, dim)


def gather_sequence(x, group, dim: int = 1):
    """The ranks' blocks concatenated along ``dim`` (every rank computes
    on the whole); the gradient is this rank's block."""
    return _Gather.apply(x, group, dim, False)


def all_gather_sequence(x, group, dim: int = 1):
    """The ranks' blocks concatenated along ``dim`` for this rank's own
    computation (each rank attends to different rows of it): the
    gradient sums every rank's share, then takes this rank's block."""
    return _Gather.apply(x, group, dim, True)


@facade_io
def ring_attention(query, key, value, causal: bool = False,
                   scale: Optional[float] = None, axis: str = "sep",
                   mesh=None):
    """Exact attention over ``[B, S, H, D]`` inputs that every rank holds
    whole, with the sequence split over the mesh's ``axis`` (the JAX
    package's contract on its global arrays, as ``shard_map_fn`` takes
    them): this rank runs the ring on its chunk, and the output is
    gathered whole. Without an ``axis`` above 1 it is one-device
    attention, a custom ``scale`` folded into q as the JAX package folds
    it. ``ValueError`` when the degree does not divide the sequence."""
    q, k, v = query, key, value
    default = 1.0 / math.sqrt(q.shape[-1])
    scale = default if scale is None else float(scale)
    group = sep_group(True, axis, mesh)
    if group is None:
        from ..nn import functional as F

        if abs(scale - default) > 1e-12:
            q = q * (scale / default)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    q, k, v = (split_sequence(t, group) for t in (q, k, v))
    out = ring_attention_local(q, k, v, causal, scale, group)
    return gather_sequence(out, group)
