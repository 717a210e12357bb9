"""Pipeline-parallel execution over the ``pp`` group
(``paddle_tpu/distributed/fleet/pipeline_schedule.py``).

The JAX package compiles a schedule into one program: stacked
``[L, ...]`` block parameters sharded over ``pp``, a ``lax.scan`` over
ticks and ``ppermute`` between stages. The port runs one process per
stage and keeps the ticks: every stage walks the same timetable, works
on its microbatch of the tick (or idles), and the stages exchange what
they made through ``collective.batch_isend_irecv`` on the ``pp`` group,
one permutation a direction (activations to ``+1``, their gradients to
``-1``; a stage with nothing to send sends a placeholder, which its
receiver knows to drop from the same timetable). On gloo a CUDA tensor
goes through host memory there (``collective.py``).

- :class:`StackedPipelineBlocks` builds ``num_layers`` blocks from
  ``factory`` (all of them, so a seed gives the JAX package's weights)
  and keeps stage ``r``'s rows ``[r·L/P, (r+1)·L/P)`` of each stacked
  ``[L, ...]`` parameter; under VPP the rows are stacked device-major in
  ``layer_order`` first, as the JAX package stacks them. Its
  ``state_dict()`` gives those rows as blocks of the ``[L, ...]`` leaf
  (``checkpoint.ShardedLeaf``), so a save from the stages writes what a
  JAX pp-sharded save writes; ``set_state_dict`` (``Layer``'s) takes
  such blocks or the whole ``[L, ...]`` arrays. A block runs as the factory's template with
  the row's values (``torch.func.functional_call`` for a
  ``torch.nn.Module``, the cells' values swapped for a Paddle ``Layer``).
- :func:`pipeline_apply` (GPipe) and :func:`pipeline_apply_vpp`
  (interleaved, the JAX package's circular schedule: ``T = V·M + P - 1``
  ticks, stage ``r`` running chunk slot ``(t - r) // M`` on microbatch
  ``(t - r) % M``, the last stage's output parked on stage 0 until the
  microbatch's next round) are one ``autograd.Function``: the forward
  keeps each tick's input and no graph, the last stage's outputs are
  broadcast over the group so every stage returns the whole batch (the
  JAX package's masked ``psum``); the backward runs the ticks in reverse,
  recomputing each chunk from its input, and stage 0's input gradient is
  broadcast so every stage returns it.
- :func:`pipeline_train` runs a training timetable, ``"1F1B"`` (stage
  ``r`` runs ``P - r - 1`` warm-up forwards, then one forward and one
  backward in turn: at most ``P - r`` microbatches in flight) or
  ``"F-then-B"`` (every forward, then every backward), with ``prefix``
  fused into stage 0 and ``loss_fn`` into the last stage, each
  microbatch's loss weighted ``1/M``. Every stage's parameters accumulate
  their gradients; the prefix's and the loss's parameters (replicated on
  every stage) take the sum of their stages' contributions over the
  group. :func:`pipeline_1f1b_train` is its 1F1B.

The two raises are the JAX package's: layers not divisible by
``pp·vpp``, and VPP with fewer microbatches than stages.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ...nn.layer_base import Layer
from .. import collective, topology
from ..checkpoint import ShardedLeaf

__all__ = ["StackedPipelineBlocks", "pipeline_apply", "pipeline_apply_vpp",
           "pipeline_1f1b_train", "pipeline_train", "pipeline_forward",
           "timetable"]

_CODES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
          torch.int64, torch.int32, torch.bool, torch.int8, torch.uint8]
_HEADER = 11  # [has, dtype code, ndim, up to 8 dims]


def _v(t):
    return getattr(t, "_value", t)


def _like(ref, value):
    from ...tensor import Tensor

    return Tensor._wrap(value) if isinstance(ref, Tensor) else value


class _Link:
    """This stage's exchanges with its neighbours on the ``pp`` group
    (module docstring); with one stage a send comes straight back."""

    def __init__(self, group):
        self.group = group
        self.P = 1 if group is None else group.nranks
        self.r = 0 if group is None else group.rank

    def _perm(self, t: torch.Tensor, k: int, buf: torch.Tensor):
        ops = [collective.P2POp(collective.isend, t, k, group=self.group),
               collective.P2POp(collective.irecv, buf, -k, group=self.group)]
        return collective.batch_isend_irecv(ops)[0]

    def swap(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """``t`` to stage ``r + k`` (mod P); what stage ``r - k`` sent,
        of ``t``'s shape and dtype."""
        if self.P == 1:
            return t
        return self._perm(t.contiguous(), k, torch.empty_like(t))

    def shift(self, t: Optional[torch.Tensor], k: int,
              device) -> Optional[torch.Tensor]:
        """``t`` (None: a placeholder) to stage ``r + k``; what stage
        ``r - k`` sent (None for its placeholder), any shape: a header of
        shape and dtype goes first."""
        if self.P == 1:
            return t
        hdr = torch.zeros(_HEADER, dtype=torch.int64, device=device)
        if t is not None:
            hdr[:3 + t.dim()] = torch.tensor(
                [1, _CODES.index(t.dtype), t.dim(), *t.shape])
        got = self._perm(hdr, k, torch.empty_like(hdr)).tolist()
        send = t.contiguous() if t is not None else \
            torch.zeros(1, device=device)
        if got[0]:
            buf = torch.empty(got[3:3 + got[2]], dtype=_CODES[got[1]],
                              device=device)
        else:
            buf = torch.zeros(1, device=device)
        out = self._perm(send, k, buf)
        return out if got[0] else None

    def broadcast(self, t: Optional[torch.Tensor], stage: int,
                  device) -> torch.Tensor:
        """Stage ``stage``'s ``t`` on every stage (any shape)."""
        if self.P == 1:
            return t
        hdr = torch.zeros(_HEADER, dtype=torch.int64, device=device)
        if self.r == stage:
            hdr[:3 + t.dim()] = torch.tensor(
                [1, _CODES.index(t.dtype), t.dim(), *t.shape])
        src = self.group.ranks[stage]
        collective.broadcast(hdr, src=src, group=self.group)
        h = hdr.tolist()
        if self.r != stage:
            t = torch.empty(h[3:3 + h[2]], dtype=_CODES[h[1]], device=device)
        else:
            t = t.detach().contiguous()
        collective.broadcast(t, src=src, group=self.group)
        return t


def _pp_group():
    mesh = topology.get_mesh()
    if mesh is None or "pp" not in mesh.axis_names:
        return None
    return mesh.group("pp")


# ------------------------------------------------------------ the stack
class _StackRuntime:
    """What :class:`StackedPipelineBlocks` and a model's stacked trunk
    share: the rows, the chunk and the forward."""

    def _init_stack(self, num_layers: int, vpp: int) -> None:
        mesh = topology.get_mesh()
        self.num_layers = num_layers
        self.vpp = max(int(vpp), 1)
        self._pp = topology.axis_size("pp", mesh)
        if num_layers % max(self._pp * self.vpp, 1):
            raise ValueError(f"num_layers {num_layers} not divisible by "
                             f"pp*vpp {self._pp * self.vpp}")
        self._stage = mesh.coordinate()["pp"] if self._pp > 1 else 0
        self._group = _pp_group() if self._pp > 1 else None
        # interleaved VPP: stage r hosts chunks {r, r+P, ...}; the stacked
        # rows are ordered device-major (row -> original layer)
        self.layer_order = list(range(num_layers))
        if self.vpp > 1 and self._pp > 1:
            P, V = self._pp, self.vpp
            Lc = num_layers // (P * V)
            self.layer_order = [i for r in range(P) for v in range(V)
                                for i in range((v * P + r) * Lc,
                                               (v * P + r + 1) * Lc)]
        self.local_layers = num_layers // self._pp
        lo = self._stage * self.local_layers
        self.rows = self.layer_order[lo:lo + self.local_layers]

    def stacked_values(self) -> List[torch.Tensor]:
        return [_v(p) for p in self.stacked]

    def _chunk(self, x, vals: Sequence[torch.Tensor]):
        """The blocks of ``vals`` (each ``[n, ...]``: n rows) on ``x``."""
        for i in range(vals[0].shape[0]):
            x = self._run_block([v[i] for v in vals], x)
        return x

    def _slot(self, vals, slot: int) -> List[torch.Tensor]:
        n = self.local_layers // self.vpp
        return [v[slot * n:(slot + 1) * n] for v in vals]

    def _leaf_index(self, full_shape) -> list:
        lo = self._stage * self.local_layers
        return [[lo, lo + self.local_layers]] + [[0, d]
                                                 for d in full_shape[1:]]

    def stacked_leaf(self, p) -> ShardedLeaf:
        """This stage's rows of a stacked parameter as a block of the
        ``[L, ...]`` leaf (replica 0 on the first rank of its other mesh
        axes)."""
        v = _v(p).detach()
        full = (self.num_layers,) + tuple(v.shape[1:])
        mesh = topology.get_mesh()
        replica = 0
        if mesh is not None:
            coord = mesh.coordinate()
            replica = int(any(c for a, c in coord.items() if a != "pp"))
        return ShardedLeaf(v, full, self._leaf_index(full), replica)

    def forward(self, x, num_microbatches: Optional[int] = None):
        """All layers on ``x`` ``[B, ...]``: at pp 1 one after another;
        above, the pipelined schedule over ``num_microbatches`` (default
        ``max(pp, vpp)``) along dim 0, every stage returning the whole
        output."""
        if self._pp == 1:
            return _like(x, self._chunk(_v(x), self.stacked_values()))
        M = num_microbatches or max(self._pp, self.vpp)
        if self.vpp > 1:
            return pipeline_apply_vpp(self, x, M)
        return pipeline_apply(self, x, M)


def _swapped(cells, vals):
    """Facade cells' values replaced by ``vals`` while inside."""
    class _Swap:
        def __enter__(self):
            self.old = [c._value for c in cells]
            for c, v in zip(cells, vals):
                c._value = v

        def __exit__(self, *exc):
            for c, o in zip(cells, self.old):
                c._value = o
    return _Swap()


class StackedPipelineBlocks(_StackRuntime, Layer):
    """``num_layers`` homogeneous blocks from ``factory`` with stacked
    parameters, this stage's rows of each (module docstring)."""

    def __init__(self, factory: Callable, num_layers: int,
                 remat: bool = True, vpp: int = 1):
        Layer.__init__(self)
        self._init_stack(num_layers, vpp)
        self.remat = remat
        blocks = [factory() for _ in range(num_layers)]
        object.__setattr__(self, "template", blocks[0])
        names = [n for n, _ in blocks[0].named_parameters()]
        self._param_names = names
        self._torch_template = not isinstance(blocks[0], Layer)
        from ...tensor import Parameter

        self.stacked = []
        for name in names:
            rows = [_v(dict(blocks[i].named_parameters())[name]).detach()
                    for i in self.rows]
            p = Parameter(torch.stack(rows).clone(),
                          name=f"stacked_{name.replace('.', '_')}")
            self.add_parameter(f"s_{name.replace('.', '__')}", p)
            self.stacked.append(p)
        del blocks

    def _run_block(self, vals, x):
        if self._torch_template:
            return torch.func.functional_call(
                self.template, dict(zip(self._param_names, vals)), (x,))
        from ...tensor import Tensor

        cells = [p for _, p in self.template.named_parameters()]
        with _swapped(cells, vals):
            out = self.template(Tensor._wrap(x))
        return _v(out)

    def train(self):
        super().train()
        self.template.train()
        return self

    def eval(self):
        super().eval()
        self.template.eval()
        return self

    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True):
        """Each stacked parameter as this stage's rows of its ``[L, ...]``
        leaf (module docstring)."""
        sd = super().state_dict(destination, include_sublayers,
                                structured_name_prefix, use_hook)
        if self._pp == 1:
            return sd
        for p in self.stacked:
            for k, v in sd.items():
                if v is p:
                    sd[k] = self.stacked_leaf(p)
        return sd


# ---------------------------------------------------------- apply (AD)
class _Pipe(torch.autograd.Function):
    """The GPipe / circular-VPP forward and its reverse (module
    docstring)."""

    @staticmethod
    def forward(ctx, stack, M, x, *vals):
        link = _Link(stack._group)
        P, r, V = link.P, link.r, stack.vpp
        T = V * M + P - 1
        mb = x.chunk(M)
        zero = torch.zeros_like(mb[0])
        saved, outputs, wrap = {}, [None] * M, {}
        state = None
        with torch.no_grad():
            for t in range(T):
                if r == 0 and V > 1 and t >= 1:
                    ua = t - P  # the last stage's output arriving now
                    if 0 <= ua < V * M and ua // M < V - 1:
                        wrap[ua % M] = state
                u, y = t - r, None
                if 0 <= u < V * M:
                    v, m = divmod(u, M)
                    x_in = (mb[m] if v == 0 else wrap.pop(m)) if r == 0 \
                        else state
                    saved[(v, m)] = x_in
                    y = stack._chunk(x_in, stack._slot(vals, v))
                    if r == P - 1 and v == V - 1:
                        outputs[m] = y
                if t < T - 1:
                    state = link.swap(y if y is not None else zero, 1)
            out = torch.cat(outputs) if r == P - 1 else None
            out = link.broadcast(out, P - 1, x.device)
        ctx.stack, ctx.M, ctx.saved = stack, M, saved
        ctx.x_grad = x.requires_grad
        return out

    @staticmethod
    def backward(ctx, g):
        stack, M, saved = ctx.stack, ctx.M, ctx.saved
        vals = [_v(p) for p in stack.stacked]
        link = _Link(stack._group)
        P, r, V = link.P, link.r, stack.vpp
        T = V * M + P - 1
        gmb = g.contiguous().chunk(M)
        dvals = [torch.zeros_like(v) for v in vals]
        n = stack.local_layers // V
        dx, wrap_g = [None] * M, {}
        state = None
        zero = torch.zeros_like(gmb[0])
        for tau in range(T):
            t = T - 1 - tau
            if r == P - 1 and V > 1 and tau >= 1:
                u0 = t + 1  # stage 0's tick that sent this gradient
                if 0 <= u0 < V * M and u0 // M >= 1:
                    wrap_g[u0 % M] = state
            u, send = t - r, None
            if 0 <= u < V * M:
                v, m = divmod(u, M)
                if r == P - 1:
                    g_in = gmb[m] if v == V - 1 else wrap_g.pop(m)
                else:
                    g_in = state
                want_dx = r > 0 or v > 0 or ctx.x_grad
                x_in = saved.pop((v, m)).detach().requires_grad_(want_dx)
                rows = [d[v * n:(v + 1) * n].detach().requires_grad_()
                        for d in vals]
                with torch.enable_grad():
                    y = stack._chunk(x_in, rows)
                    got = torch.autograd.grad(
                        y, ([x_in] if want_dx else []) + rows, g_in)
                if want_dx:
                    send, got = got[0], got[1:]
                for d, gr in zip(dvals, got):
                    d[v * n:(v + 1) * n] += gr
                if r == 0 and v == 0:
                    dx[m], send = send, None
            if tau < T - 1:
                state = link.swap(send if send is not None else zero, -1)
        dxs = None
        if ctx.x_grad:
            full = torch.cat(dx) if r == 0 else None
            dxs = link.broadcast(full, 0, g.device)
        return (None, None, dxs, *dvals)


def _apply(stack, x, num_microbatches):
    xv = _v(x)
    M = int(num_microbatches)
    if xv.shape[0] % M:
        raise ValueError(f"batch {xv.shape[0]} not divisible by "
                         f"microbatches {M}")
    out = _Pipe.apply(stack, M, xv, *stack.stacked_values())
    return _like(x, out)


def pipeline_apply(stack, x, num_microbatches: int):
    """GPipe over the ``pp`` group (module docstring): ``x`` ``[B, ...]``
    in ``num_microbatches`` along dim 0; every stage returns the whole
    output."""
    return _apply(stack, x, num_microbatches)


def pipeline_apply_vpp(stack, x, num_microbatches: int):
    """The interleaved (circular) VPP forward (module docstring); needs
    ``num_microbatches >= pp``."""
    if int(num_microbatches) < stack._pp:
        raise ValueError(
            f"interleaved VPP needs num_microbatches >= pp ({stack._pp}); "
            f"got {num_microbatches} (the circular wrap re-enters stage 0 "
            "M ticks later)")
    return _apply(stack, x, num_microbatches)


# ---------------------------------------------------------- training
def timetable(P: int, M: int, schedule: str = "1F1B") -> List[list]:
    """``ticks[t][r]``: ``("F", m)``, ``("B", m)`` or None, each stage
    running its next op as soon as its input has arrived (sent at an
    earlier tick)."""
    if schedule not in ("1F1B", "F-then-B"):
        raise ValueError(f"schedule {schedule!r}: 1F1B or F-then-B")
    ops = []
    for r in range(P):
        if schedule == "F-then-B":
            ops.append([("F", m) for m in range(M)]
                       + [("B", m) for m in range(M)])
            continue
        warm = min(P - r - 1, M)
        seq = [("F", m) for m in range(warm)]
        for i in range(M - warm):
            seq += [("F", warm + i), ("B", i)]
        seq += [("B", m) for m in range(M - warm, M)]
        ops.append(seq)
    done: Dict[tuple, int] = {}
    pos, ticks, t = [0] * P, [], 0
    while any(pos[r] < len(ops[r]) for r in range(P)):
        row = [None] * P
        for r in range(P):
            if pos[r] == len(ops[r]):
                continue
            kind, m = ops[r][pos[r]]
            dep = ((r - 1, "F", m) if kind == "F" and r > 0 else
                   (r + 1, "B", m) if kind == "B" and r < P - 1 else None)
            if dep is None or done.get(dep, t) < t:
                row[r] = (kind, m)
        for r, op in enumerate(row):
            if op is not None:
                done[(r, op[0], op[1])] = t
                pos[r] += 1
        ticks.append(row)
        t += 1
    return ticks


def _modules_of(obj, seen=None, depth: int = 3) -> list:
    """The Layers and ``torch.nn.Module``s ``obj`` reaches: itself, a
    list's items, a partial's function and arguments, a bound method's
    object, a closure's cells (the JAX package's ``_find_layers``)."""
    seen = set() if seen is None else seen
    if obj is None or id(obj) in seen or depth < 0:
        return []
    seen.add(id(obj))
    if isinstance(obj, (Layer, torch.nn.Module)):
        return [obj]
    out = []
    if isinstance(obj, (list, tuple)):
        for o in obj:
            out += _modules_of(o, seen, depth)
        return out
    if isinstance(obj, functools.partial):
        return sum((_modules_of(o, seen, depth - 1)
                    for o in (obj.func, *obj.args)), [])
    if getattr(obj, "__self__", None) is not None:
        out += _modules_of(obj.__self__, seen, depth - 1)
    for cell in getattr(obj, "__closure__", None) or ():
        try:
            out += _modules_of(cell.cell_contents, seen, depth - 1)
        except ValueError:
            continue
    return out


def _params_of(obj, explicit=None) -> List[torch.Tensor]:
    if explicit is not None:
        return [_v(p) for p in explicit]
    out, seen = [], set()
    for m in _modules_of(obj):
        for p in m.parameters():
            p = _v(p)
            if id(p) not in seen and p.requires_grad:
                seen.add(id(p))
                out.append(p)
    return out


def _sum_over_stages(params, before, group) -> None:
    """The replicated parameters' new gradient contributions summed over
    the stages (module docstring)."""
    if group is None:
        return
    for p, b in zip(params, before):
        g = p.grad
        add = torch.zeros_like(p) if g is None else (
            g if b is None else g - b)
        add = add.contiguous()
        collective.all_reduce(add, group=group)
        with torch.no_grad():
            p.grad = add if b is None else b + add


def pipeline_train(stage_fn, x, y, loss_fn, num_microbatches: int,
                   prefix=None, group=None, schedule: str = "1F1B",
                   loss_params=None, prefix_params=None, grad_scale=None,
                   stack=None):
    """One stage's part of a training timetable (module docstring):
    ``stage_fn`` runs this stage's layers, ``prefix`` stage 0's input
    layers and ``loss_fn(out, label)`` the last stage's loss. Returns the
    mean microbatch loss on every stage; the gradients accumulate (the
    caller steps the optimizer). ``grad_scale`` (a loss scale) multiplies
    the fresh contributions."""
    link = _Link(group)
    P, r = link.P, link.r
    M = int(num_microbatches)
    xv, yv = _v(x), _v(y)
    if xv.shape[0] % M:
        raise ValueError(f"batch {xv.shape[0]} not divisible by "
                         f"microbatches {M}")
    xs, ys = xv.chunk(M), yv.chunk(M)
    dev = xv.device
    shared = [p for p in _params_of(prefix, prefix_params)
              + _params_of(loss_fn, loss_params)]
    shared = list({id(p): p for p in shared}.values())
    before = [None if p.grad is None else p.grad.clone() for p in shared]
    recv_f, recv_b, inflight, losses = {}, {}, {}, []
    in_flight_max = 0
    for row in timetable(P, M, schedule):
        op, out_f, out_b = row[r], None, None
        if op is not None and op[0] == "F":
            m = op[1]
            if r == 0:
                h = _v(prefix(_like(x, xs[m]))) if prefix is not None \
                    else xs[m]
            else:
                h = recv_f.pop(m).requires_grad_()
            out = _v(stage_fn(h))
            if r == P - 1:
                loss = _v(loss_fn(_like(x, out), _like(y, ys[m]))) / M
                losses.append(loss.detach())
                if grad_scale is not None:
                    loss = loss * _v(grad_scale)
                inflight[m] = (h, loss)
            else:
                inflight[m] = (h, out)
                out_f = out.detach()
            in_flight_max = max(in_flight_max, len(inflight))
        elif op is not None:
            m = op[1]
            h, out = inflight.pop(m)
            if r == P - 1:
                out.backward()
            else:
                torch.autograd.backward(out, recv_b.pop(m))
            if r > 0:
                out_b = h.grad
        if P > 1 and any(o is not None and o[0] == "F"
                         for o in row[:P - 1]):
            got = link.shift(out_f, 1, dev)
            if r > 0 and row[r - 1] is not None and row[r - 1][0] == "F":
                recv_f[row[r - 1][1]] = got
        if P > 1 and any(o is not None and o[0] == "B" for o in row[1:]):
            got = link.shift(out_b, -1, dev)
            if r < P - 1 and row[r + 1] is not None \
                    and row[r + 1][0] == "B":
                recv_b[row[r + 1][1]] = got
    total = torch.stack(losses).sum() if r == P - 1 else None
    total = link.broadcast(total, P - 1, dev) if P > 1 else total
    _sum_over_stages(shared, before, group)
    if stack is not None:
        stack._in_flight_max = in_flight_max
    return _like(x, total)


def pipeline_1f1b_train(stack, x, y, loss_fn, num_microbatches: int,
                        prefix=None, loss_params=None, prefix_params=None,
                        grad_scale=None):
    """1F1B over ``stack``'s stages (:func:`pipeline_train`): the mean
    microbatch loss, gradients accumulated on ``stack.stacked`` and the
    prefix's and loss's parameters."""
    if stack._pp <= 1:
        raise ValueError("pipeline_1f1b_train requires an active pp>1 mesh")
    vals = stack.stacked_values()
    return pipeline_train(
        lambda h: stack._chunk(h, vals), x, y, loss_fn, num_microbatches,
        prefix=prefix, group=stack._group, schedule="1F1B",
        loss_params=loss_params, prefix_params=prefix_params,
        grad_scale=grad_scale, stack=stack)


def pipeline_forward(model, x):
    """A segmented ``PipelineLayer``'s forward: ``x`` through every
    stage's entries, the last stage's output on every stage."""
    group = model.pp_group()
    link = _Link(group)
    P, r = link.P, link.r
    xv = _v(x)
    h = xv
    for s in range(P):
        if r == s:
            h = _v(model.stage_forward(_like(x, h)))
        if s < P - 1:
            got = link.shift(h if r == s else None, 1, xv.device)
            if r == s + 1:
                h = got
    return _like(x, link.broadcast(h if r == P - 1 else None, P - 1,
                                   xv.device))
