"""ZeRO: group-sharded data parallelism
(``paddle_tpu/distributed/sharding.py``).

The JAX package makes a ZeRO stage a layout: optimizer state (``os``),
gradients (``os_g``) and parameters (``p_g_os``) are sharded over the
``sharding`` mesh axis and XLA emits the collectives. The port runs one
process per rank, so it communicates itself, over ``group`` (default:
the mesh's ``sharding`` axis when above 1, else its ``dp`` axis, else
every rank; on a mesh whose ``sharding`` and ``dp`` axes are both above
1 the state is sharded over ``sharding`` and the gradients averaged over
both, each reduction over ``sharding`` followed by a sum over ``dp``):

- which block a rank owns follows the JAX rule exactly
  (``_shard_spec_for``): the largest dimension the group's size divides
  (the first of equals), rank r holding the r-th slice of it; a tensor
  with no such dimension is replicated. A port save and a JAX save of
  the same state at the same group size so write the same shard index
  records (``distributed/checkpoint``);
- ``os``: every rank keeps only its block of each accumulator (and of
  ``@master``). The gradients are averaged by ``DataParallel``'s reducer
  (``parallel._Reducer``: the same buckets, dtype and order); the
  optimizer updates this rank's block of each parameter in place, then
  every parameter is all-gathered (one ``all_gather`` a dtype);
- ``os_g``: as ``os``, but each bucket's gradients are reduce-scattered
  (this rank's blocks, rank-major in one flat buffer; the replicated
  ones all-reduced), divided by the group's size as the reducer divides,
  and the whole gradients freed. A bucket is reduced as soon as all its
  gradients have accumulated, in the buckets' order, so at most the
  buckets the backward has not finished hold whole gradients; the
  buckets follow ``DataParallel``'s (25 MB, the first 1 MB);
- ``p_g_os``: parameters are sharded too. Between steps a rank holds
  its block of each parameter alone (the parameter's own storage is
  resized to 0, its shape and identity kept). The model is cut into
  units, each child of a module list or sequential that owns parameters,
  and the root (everything else, a tied head's weight included): a unit
  is all-gathered before its forward and freed after it, gathered again
  when its output's gradient arrives (before its backward) and freed
  once its parameters' gradients have accumulated. A unit's forward run
  again inside the backward (recompute) keeps its parameters.

At a world size of 2 a sum of two floats is the same in any order, so a
reduce-scatter's block equals the same block of the all-reduce, and an
elementwise update on a block equals that block of the whole update:
each level's parameters then equal ``DataParallel``'s bit for bit.
Global-norm clipping at ``os`` clips the whole averaged gradients as
``DataParallel``'s step does (bit for bit); at ``os_g`` and ``p_g_os``
the squares are summed over this rank's blocks (a replicated gradient
counted on the group's first rank only) and all-reduced, another order
of the same sum.

The wrapper takes a Paddle ``Layer`` or a ``torch.nn.Module`` (the
port's GPT and Llama), as ``DataParallel`` does; the optimizer keeps
writing its state in place (``optimizer.py``), so ``jit.StaticFunction``
captures an ``os`` or ``os_g`` step. A ``p_g_os`` step re-allocates each
parameter's storage at every gather, which a CUDA graph cannot replay
(it bakes the addresses of one capture): it runs eagerly.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from ..nn.layer_base import Layer
from . import collective, topology
from .checkpoint import ShardedLeaf
from .parallel import (DataParallel, _Reducer, _torch_buffers,
                       _torch_params, _weak_grad_hooks, init_parallel_env)

__all__ = ["group_sharded_parallel", "shard_optimizer_state",
           "shard_model_params", "save_group_sharded_model",
           "zero_placement", "GroupShardedModel"]

LEVELS = ("os", "os_g", "p_g_os")


def _dist():
    import torch.distributed as dist

    return dist


def _shard_dim(shape, n: int) -> Optional[int]:
    """The JAX package's ``_shard_spec_for``: the largest dim ``n``
    divides (and at least ``n``), the first of equals; None: replicate."""
    order = sorted(range(len(shape)), key=lambda i: -int(shape[i]))
    for d in order:
        if shape[d] % n == 0 and shape[d] >= n:
            return d
    return None


class _Block:
    """Rank ``rank``'s block (of ``n``) of a tensor of ``shape``."""

    def __init__(self, shape, rank: int, n: int):
        self.shape = tuple(int(d) for d in shape)
        self.dim = _shard_dim(self.shape, n)
        self.rank, self.n = rank, n
        self.size = 0 if self.dim is None else self.shape[self.dim] // n

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    def of(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t`` (a view)."""
        if self.dim is None:
            return t
        return t.narrow(self.dim, self.rank * self.size, self.size)

    @property
    def local_shape(self):
        shape = list(self.shape)
        if self.dim is not None:
            shape[self.dim] = self.size
        return tuple(shape)

    def part(self, t: torch.Tensor, r: int) -> torch.Tensor:
        return t.narrow(self.dim, r * self.size, self.size)

    def index(self) -> List[List[int]]:
        idx = [[0, d] for d in self.shape]
        if self.dim is not None:
            a = self.rank * self.size
            idx[self.dim] = [a, a + self.size]
        return idx

    def leaf(self, local) -> ShardedLeaf:
        """``local`` as a :class:`ShardedLeaf` (a replicated one written
        by the group's first rank alone)."""
        return ShardedLeaf(local, self.shape, self.index(),
                           0 if self.sharded else self.rank)


def _group(group=None):
    if group is not None:
        return group
    mesh = topology.get_mesh()
    if mesh is not None:
        for axis in ("sharding", "dp"):
            if axis in mesh.axis_names and mesh.shape[axis] > 1:
                return mesh.group(axis)
        if "dp" in mesh.axis_names:
            return mesh.group("dp")
    return topology.world_group()


def _outer(group=None):
    """The mesh's ``dp`` group when ZeRO runs over its ``sharding`` axis
    (``group`` not given) and ``dp`` is above 1: the ranks of both axes
    see different data, so the gradients are summed over ``dp`` too."""
    mesh = topology.get_mesh()
    if group is not None or mesh is None:
        return None
    if all(a in mesh.axis_names and mesh.shape[a] > 1
           for a in ("sharding", "dp")):
        return mesh.group("dp")
    return None


def zero_placement(shape, group=None) -> ShardedLeaf:
    """The block of a tensor of ``shape`` this rank holds under ZeRO over
    ``group``: a placement for ``distributed.checkpoint.load_state_dict``
    (``shardings=``)."""
    g = _group(group)
    return _Block(shape, max(g.rank, 0), g.nranks).leaf(None)


# ------------------------------------------------------------ gathers
def _all_gather_blocks(pairs, group) -> None:
    """Every rank's block into each full tensor, in place: ``pairs`` of
    ``(full tensor, _Block)``, one ``all_gather`` a dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for full, blk in pairs:
        if blk.sharded:
            by_dtype.setdefault(full.dtype, []).append((full, blk))
    pg, n, trivial = collective._resolve(group)
    if trivial:
        return
    for items in by_dtype.values():
        me = items[0][1].rank
        local = torch.cat([blk.of(full).reshape(-1) for full, blk in items])
        parts = collective._gather_list(local, pg, n)
        for r, flat in enumerate(parts):
            if r == me:
                continue
            off = 0
            for full, blk in items:
                dst = blk.part(full, r)
                k = dst.numel()
                dst.copy_(flat[off:off + k].view(dst.shape))
                off += k


class _ShardReducer(_Reducer):
    """``DataParallel``'s reducer with each bucket reduce-scattered: this
    rank's blocks of the sharded gradients (rank-major in one flat
    buffer), the replicated ones all-reduced; both summed over ``outer``
    too when given and divided by the ranks summed over. A bucket is
    reduced as soon as each of its gradients has accumulated, the
    buckets in their order (the same on every rank), so its whole
    gradients are dropped during the backward. The blocks land in
    ``grads`` (one persistent tensor a parameter, written in place;
    added to when a step reduces twice)."""

    def __init__(self, params, group, bucket_mb, last_bucket_mb,
                 find_unused, blocks: List[_Block], outer=None,
                 on_reduced=None):
        super().__init__(params, group, bucket_mb, last_bucket_mb,
                         find_unused, outer)
        self.blocks = blocks
        self.grads: Dict[int, torch.Tensor] = {}
        self.fresh = True
        self.on_reduced = on_reduced
        self._next = 0  # the next bucket of this backward to reduce

    def prepare(self, outputs) -> None:
        self._next = 0  # a backward left unfinished reduced some buckets
        super().prepare(outputs)

    def _filled(self, bucket) -> bool:
        return all(id(self.params[i]) in self._ready
                   or id(self.params[i]) not in self._expected
                   for i in bucket)

    def _on_ready(self, p: torch.Tensor) -> None:
        if not self.sync or id(p) not in self._expected:
            return
        self._ready.add(id(p))
        while self._next < len(self.buckets) \
                and self._filled(self.buckets[self._next]):
            self._reduce_bucket(self.buckets[self._next])
            self._next += 1
        if len(self._ready) == len(self._expected):
            self._ready = set()
            self.reduce()

    @torch.no_grad()
    def reduce(self) -> None:
        """The buckets not reduced yet, then the step's bookkeeping."""
        for bucket in self.buckets[self._next:]:
            self._reduce_bucket(bucket)
        self._next = 0
        self.fresh = False
        self.reductions += 1
        if self.on_reduced is not None:
            self.on_reduced()

    @torch.no_grad()
    def _reduce_bucket(self, bucket) -> None:
        pg, n, trivial = collective._resolve(self.group)
        sharded = [i for i in bucket if self.blocks[i].sharded]
        whole = [i for i in bucket if not self.blocks[i].sharded]
        for i in bucket:
            p = self.params[i]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if sharded:
            blocks = [self.blocks[i] for i in sharded]
            flat = torch.cat([blk.part(self.params[i].grad, r)
                              .reshape(-1) for r in range(n)
                              for i, blk in zip(sharded, blocks)])
            if not trivial:
                flat = collective.reduce_scatter(flat, group=self.group)
                self.all_reduces += 1
                self.bytes_reduced += flat.numel() * flat.element_size() * n
            flat.div_(n * self._outer_sum(flat))
            off = 0
            for i, blk in zip(sharded, blocks):
                k = self.params[i].numel() // n
                got = flat[off:off + k].view(blk.local_shape)
                self._land(i, got)
                off += k
                self.params[i].grad = None
        if whole:
            flat = torch.cat([self.params[i].grad.reshape(-1)
                              for i in whole])
            if not trivial:
                collective._all_reduce_into(flat, "sum", pg, n)
                self.all_reduces += 1
                self.bytes_reduced += flat.numel() * flat.element_size()
            flat.div_(n * self._outer_sum(flat))
            off = 0
            for i in whole:
                g = self.params[i].grad
                k = g.numel()
                g.copy_(flat[off:off + k].view_as(g))
                off += k

    def _land(self, i: int, got: torch.Tensor) -> None:
        dst = self.grads.get(i)
        if dst is None:
            self.grads[i] = got.clone()
        elif self.fresh:
            dst.copy_(got)
        else:
            dst.add_(got)


# ------------------------------------------------------ p_g_os params
def _is_list(m) -> bool:
    return isinstance(m, (torch.nn.ModuleList, torch.nn.Sequential)) \
        or type(m).__name__ in ("LayerList", "Sequential")


def _children(m):
    if isinstance(m, Layer):
        return [c for c in m._sub_layers.values() if c is not None]
    return list(m.children())


def _units(model) -> List[tuple]:
    """``[(module or None for the root, [param tensors])]``: each child
    of a list or sequential container that owns parameters is a unit,
    the root holds the rest (module docstring)."""
    units, taken = [], set()

    def walk(m):
        for c in _children(m):
            if _is_list(m):
                ps = [p for p in _torch_params(c) if id(p) not in taken]
                if ps:
                    taken.update(id(p) for p in ps)
                    units.append((c, ps))
                    continue
            walk(c)

    walk(model)
    root = [p for p in _torch_params(model) if id(p) not in taken]
    return [(None, root)] + units


def _tensors(out):
    out = getattr(out, "_value", out)
    if isinstance(out, torch.Tensor):
        return [out] if out.requires_grad else []
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensors(o)]
    return []


class _Unit:
    def __init__(self, params, blocks, sharder):
        self.params = params
        self.blocks = blocks
        self.sharder = sharder
        self.gathered = True
        self.in_backward = False
        self.pending = set()

    @torch.no_grad()
    def gather(self) -> None:
        if self.gathered:
            return
        pairs = []
        for p, blk in zip(self.params, self.blocks):
            if blk.sharded:
                p.data.untyped_storage().resize_(
                    p.numel() * p.element_size())
                blk.of(p.data).copy_(self.sharder.shards[id(p)])
                pairs.append((p.data, blk))
        _all_gather_blocks(pairs, self.sharder.group)
        self.gathered = True
        self.sharder.gathers += 1

    def free(self) -> None:
        if not self.gathered:
            return
        for p, blk in zip(self.params, self.blocks):
            if blk.sharded:
                p.data.untyped_storage().resize_(0)
        self.gathered = False
        self.in_backward = False

    def pre_forward(self, *_):
        self.gather()

    def post_forward(self, outputs):
        if self.in_backward:  # recomputed inside the backward: keep
            return
        self.free()
        if torch.is_grad_enabled():
            self.pending = {id(p) for p, b in zip(self.params, self.blocks)
                            if b.sharded and p.requires_grad}
            for t in _tensors(outputs):
                t.register_hook(self._on_output_grad)

    def _on_output_grad(self, g):
        self.in_backward = True
        self.gather()
        return None

    def on_accumulated(self, p) -> None:
        self.pending.discard(id(p))
        if not self.pending and self.in_backward:
            self.free()


class _ParamSharder:
    """``p_g_os``'s parameter blocks and the units' hooks (module
    docstring)."""

    def __init__(self, model, group):
        self.group = group
        self.rank, self.n = max(group.rank, 0), group.nranks
        self.shards: Dict[int, torch.Tensor] = {}
        self.blocks: Dict[int, _Block] = {}
        self.gathers = 0
        self.units: List[_Unit] = []
        self._hooks = []
        for module, params in _units(model):
            blocks = []
            for p in params:
                blk = self.blocks.get(id(p))
                if blk is None:
                    blk = self.blocks[id(p)] = _Block(p.shape, self.rank,
                                                      self.n)
                    if blk.sharded:
                        self.shards[id(p)] = blk.of(p.detach()).clone()
                blocks.append(blk)
            unit = _Unit(params, blocks, self)
            self.units.append(unit)
            self._hooks += _weak_grad_hooks(
                unit, "on_accumulated", [p for p in params if p.requires_grad])
            if module is not None:
                self._hook_module(module, unit)
        for u in self.units:
            u.free()

    def _hook_module(self, module, unit) -> None:
        if isinstance(module, Layer):
            module.register_forward_pre_hook(
                lambda layer, inputs: unit.pre_forward())
            module.register_forward_post_hook(
                lambda layer, inputs, out: unit.post_forward(out))
        else:
            module.register_forward_pre_hook(
                lambda mod, inputs: unit.pre_forward())
            module.register_forward_hook(
                lambda mod, inputs, out: unit.post_forward(out))

    @property
    def root(self) -> _Unit:
        return self.units[0]

    def free_all(self) -> None:
        for u in self.units:
            u.free()

    def resident_bytes(self) -> int:
        """Bytes the parameters hold now: their own storage (0 while
        freed) and the blocks kept between steps."""
        seen, total = set(), 0
        for u in self.units:
            for p in u.params:
                if id(p) in seen:
                    continue
                seen.add(id(p))
                total += p.untyped_storage().nbytes()
                s = self.shards.get(id(p))
                if s is not None:
                    total += s.numel() * s.element_size()
        return total


# --------------------------------------------------------- the model
class GroupShardedModel(DataParallel):
    """The model under ZeRO at ``level`` over ``group``: ``DataParallel``
    with its gradients averaged (``os``: the same reducer) or
    reduce-scattered (``os_g``, ``p_g_os``), and summed over the mesh's
    ``dp`` axis too when ``group`` is its ``sharding`` axis by default
    and both are above 1; its parameters sharded at ``p_g_os`` (module
    docstring). Wraps a Paddle ``Layer`` or a
    ``torch.nn.Module``; parameters and buffers are broadcast from the
    group's first rank when it is built."""

    def __init__(self, layers, level: str, group=None,
                 comm_buffer_size_MB: int = 25,
                 last_comm_buffer_size_MB: int = 1,
                 find_unused_parameters: bool = False):
        if level not in LEVELS:
            raise ValueError(f"level must be os|os_g|p_g_os, got {level}")
        if not _dist().is_initialized():
            init_parallel_env()
        object.__setattr__(self, "_level", level)
        object.__setattr__(self, "_sharder", None)
        outer = _outer(group)
        object.__setattr__(self, "_outer", outer)
        if outer is not None:  # every data rank starts from one copy
            for t in _torch_params(layers) + _torch_buffers(layers):
                collective.broadcast(t, src=outer.ranks[0], group=outer)
        super().__init__(layers, comm_buffer_size_MB=comm_buffer_size_MB,
                         last_comm_buffer_size_MB=last_comm_buffer_size_MB,
                         find_unused_parameters=find_unused_parameters,
                         group=_group(group))

    def _make_reducer(self, params, group, bucket_mb, last_bucket_mb,
                      find_unused):
        if self._level == "os":
            return _Reducer(params, group, bucket_mb, last_bucket_mb,
                            find_unused, self._outer)
        if self._level == "p_g_os":  # after the broadcast of the weights
            object.__setattr__(self, "_sharder",
                               _ParamSharder(self._layers, group))
        params = [p for p in params if p.requires_grad]
        blocks = [_Block(p.shape, max(group.rank, 0), group.nranks)
                  for p in params]
        return _ShardReducer(
            params, group, bucket_mb, last_bucket_mb, find_unused, blocks,
            self._outer, on_reduced=None if self._sharder is None
            else self._sharder.free_all)

    def forward(self, *inputs, **kwargs):
        sharder = self._sharder
        if sharder is None:
            return super().forward(*inputs, **kwargs)
        sharder.root.pre_forward()
        out = self._layers(*inputs, **kwargs)
        sharder.root.post_forward(out)
        if torch.is_grad_enabled():
            self._reducer.prepare(out)
        return out

    def comm_stats(self) -> dict:
        out = super().comm_stats()
        if self._sharder is not None:
            out["gathers"] = self._sharder.gathers
        return out

    def resident_parameter_bytes(self) -> int:
        """Bytes the parameters hold now (``p_g_os``: the blocks between
        steps)."""
        if self._sharder is not None:
            return self._sharder.resident_bytes()
        return sum(p.untyped_storage().nbytes()
                   for p in _torch_params(self._layers))

    def _named_torch(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(p, "_value", p)
                for n, p in self._layers.named_parameters()}

    def state_dict(self, *args, **kwargs):
        """The wrapped model's state dict; at ``p_g_os`` each sharded
        parameter as this rank's block (a :class:`ShardedLeaf`)."""
        sd = super().state_dict(*args, **kwargs)
        if self._sharder is None:
            return sd
        named = self._named_torch()
        out = type(sd)()
        for k, v in sd.items():
            p = named.get(k)
            blk = None if p is None else self._sharder.blocks.get(id(p))
            if blk is not None and blk.sharded:
                out[k] = blk.leaf(self._sharder.shards[id(p)].clone())
            else:
                out[k] = v
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict, *args, **kwargs):
        """Load a state dict: at ``p_g_os`` a sharded parameter takes this
        rank's block (of a :class:`ShardedLeaf` at that index, or of a
        whole tensor) into its block."""
        if self._sharder is None:
            return super().set_state_dict(state_dict, *args, **kwargs)
        named = self._named_torch()
        for k, v in state_dict.items():
            p = named.get(k)
            if p is None:
                continue
            blk = self._sharder.blocks.get(id(p))
            if blk is not None and blk.sharded:
                self._sharder.shards[id(p)].copy_(_local_block(v, blk))
            else:
                p.copy_(getattr(v, "_value", v))
        return None


def _local_block(v, blk: _Block) -> torch.Tensor:
    """This rank's block of ``v``: a :class:`ShardedLeaf` holding that
    block, or a whole tensor."""
    if isinstance(v, ShardedLeaf):
        if v.index != blk.index():
            raise ValueError(f"block {v.index} is not this rank's "
                             f"{blk.index()}")
        v = v.local
    v = getattr(v, "_value", v)
    if tuple(v.shape) == blk.shape:
        v = blk.of(v)
    return v


# ------------------------------------------------------ the optimizer
class _ZeroState:
    """An optimizer's ZeRO state (``optimizer._zero``, module docstring):
    each parameter's block, where its gradient block comes from, and the
    gathers after the update."""

    def __init__(self, optimizer, group, level: str,
                 model: Optional[GroupShardedModel] = None):
        self.opt = optimizer
        self.group = group
        self.level = level
        self.rank, self.n = max(group.rank, 0), group.nranks
        self.model = model
        self.params = [getattr(p, "_value", p)
                       for p in optimizer._parameter_list]
        self.blocks = [_Block(p.shape, self.rank, self.n)
                       for p in self.params]
        reducer = None if model is None else model._reducer
        self.reducer = reducer if isinstance(reducer, _ShardReducer) else None
        self._ridx = {} if self.reducer is None else {
            id(p): i for i, p in enumerate(self.reducer.params)}

    def local(self, idx: int) -> torch.Tensor:
        """The tensor the step updates for parameter ``idx``."""
        p = self.params[idx]
        sharder = None if self.model is None else self.model._sharder
        if sharder is not None and id(p) in sharder.shards:
            return sharder.shards[id(p)]
        with torch.no_grad():
            return self.blocks[idx].of(p)

    def _grad(self, idx: int) -> Optional[torch.Tensor]:
        p = self.params[idx]
        blk = self.blocks[idx]
        if self.reducer is not None and blk.sharded:
            i = self._ridx.get(id(p))
            if i is None or self.reducer.fresh:
                return None
            return self.reducer.grads.get(i)
        return None if p.grad is None else blk.of(p.grad)

    def triples(self):
        out = []
        for idx, param in enumerate(self.opt._parameter_list):
            p = self.params[idx]
            if not p.requires_grad or not getattr(param, "trainable", True):
                continue
            g = self._grad(idx)
            if g is not None:
                out.append((idx, self.local(idx), g))
        return out

    def clip(self, grad_clip, triples):
        """Clip this rank's gradient blocks as the whole gradients would
        be (module docstring)."""
        from ..nn import clip as _clip

        if self.level == "os":  # whole averaged gradients, as DP clips
            params = self.opt._parameter_list
            whole = [(params[i], self.params[i].grad) for i, _, _ in triples]
            clipped = grad_clip(whole)
            return [(i, loc, self.blocks[i].of(getattr(g, "_value", g)))
                    for (i, loc, _), (_, g) in zip(triples, clipped)]
        if isinstance(grad_clip, _clip.ClipGradByValue):
            got = grad_clip([(self.opt._parameter_list[i], g)
                             for i, _, g in triples])
            return [(i, loc, getattr(g, "_value", g))
                    for (i, loc, _), (_, g) in zip(triples, got)]
        if not isinstance(grad_clip, _clip.ClipGradByGlobalNorm):
            raise NotImplementedError(
                f"{type(grad_clip).__name__} under ZeRO {self.level}: a "
                "per-parameter norm needs the whole gradient")
        sq = None
        params = self.opt._parameter_list
        for i, _, g in triples:
            if not _clip._clips(params[i], g):
                continue
            if not self.blocks[i].sharded and self.rank != 0:
                continue  # a replicated gradient counts once
            s = torch.sum(g.float() ** 2)
            sq = s if sq is None else sq + s
        if sq is None:
            return triples
        pg, n, trivial = collective._resolve(self.group)
        if not trivial:
            collective._all_reduce_into(sq, "sum", pg, n)
        factor = _clip._factor(torch.sqrt(sq), grad_clip.clip_norm)
        return [(i, loc, _clip._scaled(g, factor)
                 if _clip._clips(params[i], g) else g)
                for i, loc, g in triples]

    def after_step(self) -> None:
        """``os``, ``os_g``: every rank's updated blocks into every
        parameter (``p_g_os`` gathers them at the next use)."""
        if self.level == "p_g_os":
            return
        with torch.no_grad():
            _all_gather_blocks(
                [(p, blk) for p, blk in zip(self.params, self.blocks)
                 if p.requires_grad], self.group)

    def clear(self) -> None:
        if self.reducer is not None:
            self.reducer.fresh = True

    def any_rank(self, flag: torch.Tensor) -> torch.Tensor:
        """``flag`` (a 0-d bool) true on any rank of the group."""
        pg, n, trivial = collective._resolve(self.group)
        if trivial:
            return flag
        x = flag.to(torch.int32)
        collective._all_reduce_into(x, "max", pg, n)
        return x.bool()

    def sharded_state(self, sd: dict) -> dict:
        """``state_dict``'s tensors as this rank's blocks with their
        global index: a parameter-shaped accumulator as the parameter's
        block, any other (a 0-d power) replicated."""
        out = {}
        for key, val in sd.items():
            pkey, _, name = key.rpartition(".")
            if not pkey.startswith("pos:"):
                out[key] = val
                continue
            blk = self.blocks[int(pkey[4:])]
            if blk.sharded and tuple(val.shape) == blk.local_shape:
                out[key] = blk.leaf(val)
            else:  # replicated: the group's first rank writes it
                out[key] = ShardedLeaf(val, val.shape,
                                       [[0, d] for d in val.shape],
                                       self.rank)
        return out

    def local_state(self, idx: int, val):
        """This rank's block of a loaded accumulator (a
        :class:`ShardedLeaf` or a whole tensor)."""
        blk = self.blocks[idx]
        if isinstance(val, ShardedLeaf):
            if val.shape == blk.shape:
                return _local_block(val, blk)
            return val.local
        v = getattr(val, "_value", val)
        if isinstance(v, torch.Tensor) and tuple(v.shape) == blk.shape:
            return blk.of(v)
        return val


def shard_optimizer_state(optimizer, group=None, level: str = "os",
                          model: Optional[GroupShardedModel] = None):
    """Stage 1: every accumulator (and ``@master``) made and kept as this
    rank's block; the step updates the blocks and all-gathers the
    parameters (module docstring). With ``model`` (a
    :class:`GroupShardedModel`) the gradient blocks come from its
    reducer and, at ``p_g_os``, the parameter blocks from its shards."""
    group = _group(group if model is None else model._group)
    zero = _ZeroState(optimizer, group, level, model)
    for idx, accs in optimizer._accumulators.items():  # state made already
        blk = zero.blocks[idx]
        for name, v in list(accs.items()):
            if blk.sharded and tuple(v.shape) == blk.shape:
                accs[name] = blk.of(v).clone()
    optimizer._zero = zero
    return optimizer


def shard_model_params(model, group=None, **kwargs) -> GroupShardedModel:
    """Stage 3: the model's parameters sharded (module docstring)."""
    return GroupShardedModel(model, "p_g_os", group=group, **kwargs)


def group_sharded_parallel(model, optimizer, level: str = "os_g",
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size=None, segment_size=None,
                           sync_comm: bool = False):
    """reference: paddle.distributed.sharding.group_sharded_parallel
    (sharding/group_sharded.py): ``level`` ``os`` (ZeRO-1), ``os_g``
    (ZeRO-2) or ``p_g_os`` (ZeRO-3) over ``group``. Returns ``(model,
    optimizer)``, with ``scaler`` as a third item when given."""
    if level not in LEVELS:
        raise ValueError(f"level must be os|os_g|p_g_os, got {level}")
    if offload:
        raise NotImplementedError("group_sharded_parallel: offload")
    wrapped = GroupShardedModel(model, level, group=group)
    shard_optimizer_state(optimizer, level=level, model=wrapped)
    if scaler is not None:
        return wrapped, optimizer, scaler
    return wrapped, optimizer


def _whole(v, group) -> torch.Tensor:
    """The whole tensor of a :class:`ShardedLeaf` (every rank calls)."""
    if not isinstance(v, ShardedLeaf):
        return getattr(v, "_value", v)
    blk = None
    for d, ((a, b), size) in enumerate(zip(v.index, v.shape)):
        if b - a != size:
            blk = d
    if blk is None:
        return v.local
    parts: list = []
    collective.all_gather(parts, v.local.contiguous(), group=group)
    return torch.cat(parts, dim=blk)


def save_group_sharded_model(model, output, optimizer=None):
    """reference: distributed/sharding/group_sharded.py:179: the model's
    (and the optimizer's) state, whole, as ``model.pdmodel`` and
    ``model.pdopt`` in the directory ``output``. Every rank calls it
    (the blocks are gathered); the group's first rank writes."""
    from ..framework import io

    if os.path.isfile(output):
        raise AssertionError(f"Saving directory ({output}) should be a "
                             "directory, not a file")
    group = getattr(model, "_group", None) or _group()
    msd = {k: _whole(v, group) for k, v in model.state_dict().items()}
    osd = None
    if optimizer is not None:
        osd = {k: _whole(v, group) for k, v in optimizer.state_dict().items()}
    if max(group.rank, 0) != 0:
        return
    os.makedirs(output, exist_ok=True)
    io.save(msd, os.path.join(output, "model.pdmodel"))
    if osd is not None:
        io.save(osd, os.path.join(output, "model.pdopt"))
