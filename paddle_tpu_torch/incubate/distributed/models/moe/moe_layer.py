"""The MoE layer and its experts
(``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

The JAX package's design, kept: static-shape capacity dispatch. Each
top-k assignment's slot in its expert is its arrival order there (a
one-hot cumsum, ``_routing_plan``), assignments past the capacity drop,
the tokens are gathered into a dense ``[E, C, d]`` buffer, the experts
run on it, and each token sums its experts' outputs weighted by the
gate. A dropped assignment adds nothing.

Expert parallelism, on the mesh axis the ``moe_group`` names (an axis
name, or a group handle with its ``axis``, as the JAX package resolves
it): the JAX package runs the dispatch inside ``shard_map`` with
``all_to_all``; the port runs one process per rank, each with its own
tokens (in rank order, the JAX program's batch) and its own experts,
``[r E_l, (r+1) E_l)`` of the ``E`` it is given (the others are not
kept; the state-dict names stay the global ``experts.<e>.*``, so a
sharded checkpoint writes each expert once). A rank plans its tokens'
slots as the JAX shard does, lays the buffer out ``[ep, E_l, C, d]``,
sends block ``j`` to rank ``j`` (``collective.alltoall``, whose backward
is the reverse all-to-all), runs its experts as stacked batched products
over the ``ep * C`` rows each received, and sends the results back the
same way. The gate runs on this rank's tokens with the group's global
statistics (``gate/gshard_gate.py``).

Gradients follow the data-parallel convention (each rank's loss is the
mean over its own tokens, replicated weights averaged by
``DataParallel``): the gate's weights are replicated and averaged like
any; an expert's gradient arrives from every rank's loss through the
all-to-all's backward, so it is scaled by ``1 / ep`` to be the single
program's gradient of the mean loss, and the experts' parameters are
marked ``no_sync`` (``DataParallel`` neither broadcasts nor averages
them).

Determinism: a token's gradient gathers at most ``top_k`` rows back
from the buffer (the dispatch's backward adds them into zeros); a sum of
two floats from zero is exact in either order, so with ``top_k <= 2``
the backward is deterministic. Nothing here relies on it beyond that.
"""
from __future__ import annotations

import math as _pymath
from typing import Optional

import torch

from .....distributed import collective, topology
from .....nn import functional as F
from .....nn.layer.common import Linear
from .....nn.layer.container import LayerList
from .....nn.layer_base import Layer
from .....tensor import Tensor
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer", "ExpertLayer"]


class ExpertLayer(Layer):
    """A two-Linear FFN expert (the reference docs' ExpertLayer shape). A
    bank of them with one activation takes the expert-parallel path."""

    def __init__(self, d_model: int, d_hidden: int, activation: str = "gelu",
                 name=None, rank: int = 0, windex: int = 0,
                 num_expert: int = 1):
        super().__init__()
        self.htoh4 = Linear(d_model, d_hidden)
        self.h4toh = Linear(d_hidden, d_model)
        self._activation = activation

    def _act(self, x):
        if self._activation is None or self._activation == "identity":
            return x
        return getattr(F, self._activation)(x)

    def forward(self, x):
        return self.h4toh(self._act(self.htoh4(x)))


def _routing_plan(idx: torch.Tensor, tot_expert: int, capacity: int):
    """``idx`` ``[T, k]`` int (-1 dropped) -> ``(gather_idx [E*C]`` (each
    slot's source token), ``slot_valid [E*C]``, ``tok_slot [T*k]`` (each
    assignment's slot), ``tok_valid [T*k])``, the JAX package's plan."""
    T, k = idx.shape
    flat = idx.reshape(-1).to(torch.int64)
    valid = flat >= 0
    safe = flat.clamp(0, tot_expert - 1)
    oh = torch.where(valid[:, None],
                     torch.nn.functional.one_hot(safe, tot_expert), 0)
    pos = oh.cumsum(0).gather(1, safe[:, None])[:, 0] - 1
    valid = valid & (pos < capacity)
    n_slots = tot_expert * capacity
    slot = torch.where(valid, safe * capacity + pos, n_slots)  # overflow bin
    token = torch.arange(T * k, device=idx.device) // k
    tfs = torch.zeros(n_slots + 1, dtype=torch.int64, device=idx.device)
    tfs = tfs.index_add(0, slot, token + 1)[:n_slots]
    return (torch.clamp_min(tfs - 1, 0), tfs > 0,
            torch.clamp_max(slot, n_slots - 1), valid)


def _dispatch(x, gather_idx, slot_valid):
    return x[gather_idx] * slot_valid[:, None].to(x.dtype)


def _combine(flat, tok_slot, tok_valid, value, T, k):
    y = flat[tok_slot] * tok_valid[:, None].to(flat.dtype)
    return (y.reshape(T, k, -1) * value[..., None].to(y.dtype)).sum(1)


class _AllToAll(torch.autograd.Function):
    """Equal-split all-to-all along dim 0; its backward is the same
    all-to-all of the gradient (the exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective.alltoall(x.contiguous(), group=group)

    @staticmethod
    def backward(ctx, g):
        return collective.alltoall(g.contiguous(), group=ctx.group), None


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _ep_group(moe_group):
    """The expert-parallel group ``moe_group`` names (module docstring):
    None unless it names a mesh axis above 1."""
    axis = moe_group if isinstance(moe_group, str) else getattr(
        moe_group, "axis", None)
    mesh = topology.get_mesh()
    if not axis or topology.axis_size(axis, mesh) <= 1:
        return None
    return mesh.group(axis)


class MoELayer(Layer):
    """reference: moe_layer.py:261, the JAX package's constructor
    contract. ``experts``: all ``E`` experts (a list or ``LayerList``);
    ``gate``: a dict (``type`` naive/gshard/switch, ``top_k``) or a
    ``BaseGate``; ``moe_group``: the expert-parallel axis (module
    docstring); ``capacity_factor``: per-expert capacity ``C =
    ceil(factor * T * k / E)`` (None: ``C = T``, the layer drops nothing;
    gates may)."""

    def __init__(self, d_model: int, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval: int = 0,
                 recompute_ctx=None, capacity_factor: Optional[float] = None):
        super().__init__()
        self.d_model = d_model
        self.recompute_interval = recompute_interval
        self.recompute_ctx = recompute_ctx
        self.capacity_factor = capacity_factor
        self._ep = _ep_group(moe_group)
        self.world_size = 1 if self._ep is None else self._ep.nranks

        experts = list(experts)
        self.num_expert = len(experts)
        self.tot_expert = self.num_expert
        if isinstance(gate, dict) or gate is None:
            gate = dict(gate or {})
            self.top_k = gate.get("top_k", 2)
            kind = gate.get("type", "gshard")
            kinds = {"naive": NaiveGate, None: NaiveGate,
                     "gshard": GShardGate, "switch": SwitchGate}
            if kind not in kinds:
                raise AssertionError(
                    f"only naive/gshard/switch gates supported, got {kind}")
            gate = kinds[kind](d_model, num_expert=self.num_expert,
                               world_size=1, topk=self.top_k)
        elif isinstance(gate, BaseGate):
            self.top_k = gate.top_k
        else:
            raise TypeError("gate must be a dict or a moe.BaseGate instance")

        stackable = all(isinstance(e, ExpertLayer) for e in experts) \
            and len({e._activation for e in experts}) <= 1
        if self._ep is None:  # experts before the gate, as in the JAX layer
            self.experts = LayerList(experts)
            self.gate = gate
            return
        if not stackable:
            raise ValueError(
                "expert-parallel MoELayer needs a homogeneous ExpertLayer "
                "bank (stacked weights ride the mesh's expert axis); "
                "heterogeneous experts run with moe_group=None")
        ep = self.world_size
        if self.num_expert % ep:
            raise ValueError(f"num_expert {self.num_expert} not divisible "
                             f"by ep degree {ep}")
        n_local = self.num_expert // ep
        first = self._ep.rank * n_local
        self.experts = LayerList()
        for e in range(first, first + n_local):
            self.experts.add_sublayer(str(e), experts[e])
            for p in experts[e].parameters():
                p._value.no_sync = True
        self._local = list(range(first, first + n_local))
        self.gate = gate

    def _capacity(self, T: int) -> int:
        if self.capacity_factor is None:
            return T
        return min(T, _pymath.ceil(
            self.capacity_factor * T * self.top_k / self.tot_expert))

    def _forward_local(self, x, value, idx, T):
        E, C, k = self.tot_expert, self._capacity(T), self.top_k
        gi, sv, ts, tv = _routing_plan(idx, E, C)
        expert_in = _dispatch(x, gi, sv).reshape(E, C, -1)
        outs = [self.experts[e](Tensor._wrap(expert_in[e]))._value
                for e in range(E)]
        return _combine(torch.stack(outs).reshape(E * C, -1), ts, tv, value,
                        T, k)

    def _stacked(self):
        """The local experts' weights stacked ``[E_l, ...]``, their
        gradients scaled by ``1 / ep`` (module docstring)."""
        es = [self.experts[e] for e in self._local]
        w = [torch.stack([getattr(getattr(e, lin), name)._value
                          for e in es])
             for lin in ("htoh4", "h4toh") for name in ("weight", "bias")]
        return [_GradScale.apply(t, 1.0 / self.world_size) for t in w]

    def _forward_ep(self, x, value, idx, T):
        ep, E, k = self.world_size, self.tot_expert, self.top_k
        E_l, C, d = E // ep, self._capacity(T), x.shape[-1]
        act = self.experts[self._local[0]]._act  # one activation a bank
        w1, b1, w2, b2 = self._stacked()
        gi, sv, ts, tv = _routing_plan(idx, E, C)
        ein = _dispatch(x, gi, sv).reshape(ep, E_l, C, d)
        ein = _AllToAll.apply(ein, self._ep)  # [ep_src, E_l, C, d]
        ein = ein.transpose(0, 1).reshape(E_l, ep * C, d)
        h = act(torch.einsum("etd,edh->eth", ein, w1) + b1[:, None])
        eo = torch.einsum("eth,ehd->etd", h, w2) + b2[:, None]
        eo = eo.reshape(E_l, ep, C, d).transpose(0, 1)
        eo = _AllToAll.apply(eo, self._ep)  # [ep_dst, E_l, C, d]
        return _combine(eo.reshape(E * C, d), ts, tv, value, T, k)

    def forward(self, inp):
        """``inp`` ``[batch, seq, d_model]`` (this rank's tokens under
        expert parallelism) -> the same shape."""
        if len(inp.shape) != 3:
            raise ValueError("MoELayer input must be [batch, seq, d_model]")
        B, S, d = inp.shape
        x2d = Tensor._wrap(getattr(inp, "_value", inp).reshape(-1, d))
        self.gate._ep = self._ep  # the gate may be shared with another
        value, idx = self.gate(x2d)
        run = self._forward_local if self._ep is None else self._forward_ep
        out = run(x2d._value, value._value, idx._value.detach(), B * S)
        return Tensor._wrap(out.reshape(B, S, d))
