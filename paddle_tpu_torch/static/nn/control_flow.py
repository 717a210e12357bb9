"""Data-dependent control flow: ``cond``, ``while_loop``, ``case`` and
``switch_case`` (``paddle_tpu/static/nn/control_flow.py``).

The JAX package runs a branch in Python when the predicate is concrete
and lowers to ``lax.cond``/``lax.switch``/``lax.while_loop`` when it is
traced. The port has four regimes:

- **Concrete predicate** (the CPU, or an eager call on the card): the
  chosen Python branch or a Python loop, recorded by torch autograd as
  any eager code (the JAX package's ``:218-220`` and ``:246-258``).
- **Under capture on the card** (a ``StaticFunction``'s or an
  ``Executor``'s CUDA graph): conditional nodes of the graph
  (``ops/graph_cond.py``), the predicate read on the device at every
  replay and only the chosen branch run. ``cond``/``case``/``switch_case``
  are chains of IF nodes; their gradient is a ``torch.autograd.Function``
  whose backward recomputes each branch inside the matching IF node and
  takes ``torch.autograd.grad`` there, into gradient buffers zeroed
  before the nodes, so it equals the eager one (``lax.cond``'s AD). The
  tensors a branch reads (its captures, for the gradient) are found as
  the JAX package's ``_discover`` finds them: an observer of the Tensors
  each op reads. ``while_loop`` is one WHILE node; as under ``jax.jit``
  it is forward-only, its outputs detached (``:317-319``). Nothing here
  selects with ``torch.where``: that runs both branches, a NaN in the
  branch not taken poisons the gradient and in-place writes happen twice.
- **Inside a static Program, on a placeholder-derived predicate**: the
  construct records as one node of the program (``static/record.py``).
  At build time it runs as the concrete regime does; at every
  ``Executor.run`` the node calls the construct again on the fed values,
  in the regime of that run (eagerly on the CPU, conditional nodes in the
  Executor's graph on the card). The JAX package's tape records only the
  branch the build-time zeros took, so its Executor replays that branch
  for every feed; the port takes the fed predicate's branch.
- **Exporting** (a ``torch.export`` trace, as ``jit.save`` and
  ``onnx.export`` run it; :func:`exporting`): each construct becomes a
  higher-order op of the exported graph, as the JAX package lowers to
  ``lax.*`` under a trace (``:147-188``, ``:259-315``): ``cond`` is
  ``torch.cond``, ``case`` and ``switch_case`` are nested ``torch.cond``s
  (the JAX package's ``lax.switch``), ``while_loop`` is
  ``torch.while_loop`` (called as the operators
  ``torch.ops.higher_order.*``: ``torch.cond`` itself runs its branches
  through ``torch.compile`` under a non-strict export, which cannot trace
  the facade). The tensors the branches and bodies close over
  (parameters, a bound ``n``) become the op's extra inputs: the branch
  runs once on the trace's fake tensors with the tracer off to find them
  (:func:`_closure`), and a ``TorchFunctionMode`` hands each op of the
  traced branch its input in their place (:class:`_Lift`), so a closure
  is never baked in as a constant. A branch or body output is a clone
  (the ops reject an output that aliases an input, such as a carry
  handed back unchanged), and a carry keeps its dtype, shape and device
  across trips. The clone costs one copy of the outputs a trip.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map

from ... import tensor as _tensor
from ...ops import graph_cond as _gc
from ...tensor import Tensor

__all__ = ["cond", "while_loop", "case", "switch_case", "exporting"]


# --------------------------------------------------------------- helpers
def _val(x):
    return x._value if isinstance(x, Tensor) else x


def _pred_value(pred) -> bool:
    """The concrete bool of a predicate of one element."""
    v = _val(pred)
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(
                f"a predicate must hold one element, got shape "
                f"{tuple(v.shape)}")
        if isinstance(pred, Tensor):
            return bool(pred)
        return bool(v.reshape(()))
    return bool(v)


def exporting(*xs) -> bool:
    """Whether a ``torch.export`` trace is running, or a value among
    ``xs`` (Tensors or torch tensors) is one of its fake tensors: the
    exporting regime (module docstring)."""
    if torch.compiler.is_exporting():
        return True
    from torch._subclasses.fake_tensor import is_fake

    return any(isinstance(v, torch.Tensor) and is_fake(v)
               for v in (_val(x) for x in xs))


def _exported(*preds) -> bool:
    """The exporting regime applies: a predicate is a tensor of the
    trace (a Python value stays concrete under export too)."""
    return (any(isinstance(_val(p), torch.Tensor) for p in preds)
            and exporting(*preds))


def _captured(*preds) -> bool:
    return any(_gc.capturing(_val(p)) for p in preds)


def _recorded(*preds):
    """The open program's recorder when a predicate derives from one of
    its placeholders, else None."""
    rec = _tensor.program_recorder
    if rec is None or not rec.records():
        return None
    if any(isinstance(p, Tensor) and rec.derived(p) for p in preds):
        return rec
    return None


def _flatten(tree):
    """(leaves, rebuild): the Tensor and torch-tensor leaves of nested
    lists, tuples and dicts, and a function that puts new leaves back."""
    leaves: list = []

    def spec_of(x):
        if isinstance(x, (Tensor, torch.Tensor)):
            leaves.append(x)
            return ("L", len(leaves) - 1, isinstance(x, Tensor))
        if isinstance(x, (list, tuple)):
            return (type(x), [spec_of(v) for v in x])
        if isinstance(x, dict):
            return (dict, [(k, spec_of(v)) for k, v in x.items()])
        return ("S", x)

    spec = spec_of(tree)

    def rebuild(vals, s=spec):
        kind = s[0]
        if kind == "L":
            v = vals[s[1]]
            return Tensor._wrap(v) if s[2] else v
        if kind == "S":
            return s[1]
        if kind is dict:
            return {k: rebuild(vals, c) for k, c in s[1]}
        items = [rebuild(vals, c) for c in s[1]]
        return kind(items) if kind is not list else items

    return leaves, rebuild


def _structure(tree):
    leaves, _ = _flatten(tree)
    return [(tuple(_val(x).shape), _val(x).dtype) for x in leaves]


class _Observer:
    """The Tensors that ops read while it is installed (the JAX package's
    ``_CaptureObserver``), except ``exclude``, first-read order."""

    def __init__(self, exclude=()):
        self.exclude = {id(t) for t in exclude}
        self.cells: dict = {}

    def __call__(self, tensors):
        for t in tensors:
            if isinstance(t, Tensor) and id(t) not in self.exclude:
                self.cells.setdefault(id(t), t)

    def __enter__(self):
        _tensor.op_observers.append(self)
        return self

    def __exit__(self, *exc):
        _tensor.op_observers.remove(self)
        return False


class _Swapped:
    """Give ``cells`` the torch values ``vals`` for the block (the JAX
    package's ``_run_substituted``)."""

    def __init__(self, cells, vals):
        self.pairs = list(zip(cells, vals))

    def __enter__(self):
        self.old = [c._value for c, _ in self.pairs]
        for c, v in self.pairs:
            c._value = v

    def __exit__(self, *exc):
        for (c, _), v in zip(self.pairs, self.old):
            c._value = v
        return False


def _fresh(leaves) -> List[torch.Tensor]:
    """Output values that are new objects (a recorded node keys its
    outputs by identity; a branch may hand back a tensor it read)."""
    return [v.view_as(v) for v in (_val(x) for x in leaves)]


# ------------------------------------------------------ recorded regime
def _record_construct(rec, name: str, run_public: Callable,
                      inputs: Sequence[Tensor], build_out):
    """Record a construct as one node: ``run_public(*input Tensors)``
    runs it again at replay (on the values the replay feeds it, put into
    ``inputs``' cells for the call), and ``build_out`` is its build-time
    result."""
    inputs = list({id(c): c for c in inputs}.values())
    leaves, rebuild = _flatten(build_out)
    outs = _fresh(leaves)

    def replay(*vals):
        with _Swapped(inputs, vals):
            got, _ = _flatten(run_public(*inputs))
            return [_val(x) for x in got]

    rec.flow(replay, inputs, outs, name)
    return rebuild(outs)


def _discover_run(fn: Callable, exclude=()):
    """``fn()`` with the recorder paused, and the Tensors it read."""
    rec = _tensor.program_recorder
    with _Observer(exclude) as obs:
        if rec is not None:
            with rec.pause():
                out = fn()
        else:
            out = fn()
    leaves, _ = _flatten(out)
    for t in leaves:  # a branch that returns a capture reads it
        if isinstance(t, Tensor) and id(t) not in obs.exclude:
            obs.cells.setdefault(id(t), t)
    return out, list(obs.cells.values())


# ------------------------------------------------------ captured regime
class _CondGrad(torch.autograd.Function):
    """The outputs of captured IF nodes as views, so their gradient flows
    to the branches' captures through :meth:`backward`."""

    @staticmethod
    def forward(ctx, sel, plan, n_caps, *vals):
        ctx.plan = plan
        ctx.save_for_backward(sel, *vals[:n_caps])
        return tuple(o.view_as(o) for o in vals[n_caps:])

    @staticmethod
    def backward(ctx, *gouts):
        sel, *caps = ctx.saved_tensors
        grads = ctx.plan.backward(sel, caps, gouts)
        return (None, None, None, *grads, *([None] * len(gouts)))


class _BranchPlan:
    """The branches of a captured construct, for its backward."""

    def __init__(self, fns, cells):
        self.fns = fns
        self.cells = cells

    def backward(self, sel, caps, gouts):
        grads = [torch.zeros_like(c) for c in caps]

        def branch(fn):
            def run():
                leaves = [c.detach().requires_grad_(c.is_floating_point()
                                                    or c.is_complex())
                          for c in caps]
                with _Swapped(self.cells, leaves), torch.enable_grad():
                    outs, _ = _flatten(fn())
                    outs = [_val(o) for o in outs]
                    pairs = [(o, g if g is not None else torch.zeros_like(o))
                             for o, g in zip(outs, gouts)
                             if o.requires_grad]
                    wrt = [x for x in leaves if x.requires_grad]
                    if pairs and wrt:
                        gs = torch.autograd.grad(
                            [o for o, _ in pairs], wrt,
                            [g for _, g in pairs], allow_unused=True)
                        it = iter(gs)
                        for buf, x in zip(grads, leaves):
                            if x.requires_grad:
                                g = next(it)
                                if g is not None:
                                    buf.copy_(g)
                return []
            return run

        _gc.if_nodes(sel, [branch(fn) for fn in self.fns])
        return grads


def _captured_multiway(sel: torch.Tensor, fns: Sequence[Callable],
                       name: str):
    """``fns[sel]()`` as IF nodes of the graph being captured, with its
    gradient (module docstring)."""
    structs = []
    rebuilds = []

    def flat_branch(i, fn):
        def run():
            out = fn()
            leaves, rebuild = _flatten(out)
            structs.append((i, _structure(out), type(out)))
            rebuilds.append(rebuild)
            return [_val(x) for x in leaves]
        return run

    with _Observer() as obs, torch.no_grad():
        outs = _gc.if_nodes(sel.to(torch.int32),
                            [flat_branch(i, fn) for i, fn in enumerate(fns)])
    first = structs[0]
    for i, st, kind in structs[1:]:
        if st != first[1]:
            raise ValueError(
                f"{name}: branch 0 and branch {i} must return the same "
                f"structure/shapes/dtypes; got {first[1]} vs {st} (the "
                "reference raises the same constraint for merged block "
                "outputs)")
    cells = [c for c in obs.cells.values() if c._value.requires_grad]
    if cells and torch.is_grad_enabled() and outs:
        plan = _BranchPlan(list(fns), cells)
        outs = list(_CondGrad.apply(sel, plan, len(cells),
                                    *[c._value for c in cells], *outs))
    return rebuilds[0](outs)


# ----------------------------------------------------- exporting regime
class _Reads(TorchFunctionMode):
    """The torch tensors that ops read while it is installed and that no
    op of the block made (the block's closure: parameters, a bound),
    except ``exclude``, first-read order."""

    def __init__(self, exclude=()):
        super().__init__()
        self.skip = {id(t) for t in exclude}
        self.made: list = []  # held, so that no id is reused
        self.read: dict = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, torch.Tensor) and id(a) not in self.skip:
                self.read.setdefault(id(a), a)
        out = func(*args, **kwargs)
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor):
                self.made.append(o)
                self.skip.add(id(o))
        return out


class _Lift(TorchFunctionMode):
    """Give every op of the block, in place of each tensor of
    ``outer``, the matching one of ``inner`` (an input of the traced
    branch or body)."""

    def __init__(self, outer, inner):
        super().__init__()
        self.map = {id(o): i for o, i in zip(outer, inner)}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        def sub(a):
            return self.map.get(id(a), a) if isinstance(a, torch.Tensor) \
                else a
        return func(*tree_map(sub, args), **tree_map(sub, kwargs or {}))


def _closure(fn: Callable, args=()) -> List[torch.Tensor]:
    """The tensors ``fn(*args)`` reads from outside: the function runs
    once on the trace's fake tensors with the tracer switched off (it
    records nothing)."""
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing

    with disable_proxy_modes_tracing(), _Reads(args) as reads:
        fn(*args)
    return list(reads.read.values())


def _lifted(fn: Callable, n: int, ext: Sequence[torch.Tensor]):
    """``fn`` over its ``n`` arguments, then the values of ``ext``: what
    the traced subgraph calls (its closure becomes inputs)."""
    def run(*vals):
        with _Lift(ext, vals[n:]):
            return fn(*vals[:n])
    return run


def _new_values(leaves) -> List[torch.Tensor]:
    """The torch values of ``leaves`` as new tensors of the trace: each is
    cloned, since one that is an input of the op or a tensor read from
    outside would alias it."""
    out = []
    for x in leaves:
        v = _val(x)
        if not isinstance(v, torch.Tensor):
            raise TypeError(
                f"a branch or loop body returned {type(x).__name__}: under "
                "export every output leaf must be a Tensor")
        out.append(v.clone())
    return out


def _exported_multiway(sel: torch.Tensor, fns: Sequence[Callable],
                       name: str):
    """``fns[sel]()`` as nested ``torch.cond`` nodes: branch ``i`` is
    taken when ``sel == i``, the last one otherwise (module
    docstring)."""
    structs: dict = {}
    rebuilds: dict = {}

    def flat(i):
        def run():
            out = fns[i]()
            leaves, rebuild = _flatten(out)
            structs[i] = (_structure(out), type(out))
            rebuilds.setdefault(i, rebuild)
            return tuple(_new_values(leaves))
        return run

    def chain(i):
        if i == len(fns) - 1:
            return flat(i)()
        # the closure of this cond: the selector (the nested conds test
        # it) and every branch it may still take
        ext = _closure(lambda: [sel.reshape(())]
                       + [flat(j)() for j in range(i, len(fns))])
        _check_structs(structs, name)
        hit = (sel == i).reshape(())
        return tuple(torch.ops.higher_order.cond(
            hit, _lifted(flat(i), 0, ext),
            _lifted(lambda: chain(i + 1), 0, ext), tuple(ext)))

    outs = chain(0)
    return rebuilds[0](list(outs))


def _check_structs(structs, name) -> None:
    first = structs.get(0)
    for i, st in sorted(structs.items()):
        if st != first:
            raise ValueError(
                f"{name}: branch 0 and branch {i} must return the same "
                f"structure/shapes/dtypes; got {first[0]} vs {st[0]} (the "
                "reference raises the same constraint for merged block "
                "outputs)")


def _exported_while(cond, body, loop_vars, leaves, rebuild):
    """One ``torch.while_loop`` node over the flattened carry (module
    docstring)."""
    for v in leaves:
        if not isinstance(v, (Tensor, torch.Tensor)):
            raise TypeError(
                "while_loop under export: every loop_vars leaf must be a "
                f"Tensor (got {type(v).__name__}): a Python scalar would be "
                "a constant of the graph, not a carried value")
    n = len(leaves)
    init = [_val(x) for x in leaves]
    meta = [(v.shape, v.dtype) for v in init]

    def cond_t(*vals):
        r = _val(cond(*rebuild(list(vals))))
        return r.reshape(()).to(torch.bool)

    def body_t(*vals):
        out = body(*rebuild(list(vals)))
        out = list(out) if isinstance(out, (list, tuple)) else [out]
        got, _ = _flatten(out)
        if len(got) != n:
            raise ValueError(
                f"while_loop: body returned {len(got)} leaves, expected {n} "
                "(must match loop_vars structure)")
        new = _new_values(got)
        for k, (v, (shape, dt)) in enumerate(zip(new, meta)):
            if v.shape != shape or v.dtype != dt:
                raise ValueError(
                    f"while_loop: loop var {k} changed from "
                    f"{tuple(shape)} {dt} to {tuple(v.shape)} {v.dtype} in "
                    "the body; a carry keeps its shape and dtype")
        return tuple(new)

    ext = _closure(lambda *vs: (cond_t(*vs), body_t(*vs)), init)
    out = torch.ops.higher_order.while_loop(
        _lifted(cond_t, n, ext), _lifted(body_t, n, ext), tuple(init),
        tuple(ext))
    return rebuild(list(out))


def _same_structure(name, fns, i, a, j, b) -> None:
    sa, sb = _structure(a), _structure(b)
    if sa != sb or type(a) is not type(b):
        lo, hi = sorted((i, j))
        first, second = (sa, sb) if i < j else (sb, sa)
        raise ValueError(
            f"{name}: branch {lo} and branch {hi} must return the same "
            f"structure/shapes/dtypes; got {first} vs {second} (the "
            "reference raises the same constraint for merged block "
            "outputs)")


def _multiway(select_dev: Callable, choose: Callable, preds: Sequence,
              fns: Sequence[Callable], name: str, public: Callable):
    """Dispatch a multi-way construct on its regime (module docstring).
    ``select_dev(pred values)`` gives the branch index as a device
    tensor, ``choose(preds)`` the index of concrete predicates, and
    ``public(*preds)`` calls the construct again."""
    if _exported(*preds):
        return _exported_multiway(select_dev([_val(p) for p in preds]), fns,
                                  name)
    if _captured(*preds):
        return _captured_multiway(select_dev([_val(p) for p in preds]), fns,
                                  name)
    rec = _recorded(*preds)
    if rec is not None:
        k = choose(preds)
        out, caps = _discover_run(fns[k])
        for i, fn in enumerate(fns):
            if i != k:
                other, more = _discover_run(fn)
                caps += more
                _same_structure(name, fns, k, out, i, other)
        cells = [p for p in preds if isinstance(p, Tensor)] + caps
        n = sum(isinstance(p, Tensor) for p in preds)

        def run_public(*cells_now):
            return public(*cells_now[:n])

        return _record_construct(rec, name, run_public, cells, out)
    return fns[choose(preds)]()


def _warm_others(fns: Sequence[Callable], taken: int, preds) -> None:
    """In a ``StaticFunction``'s eager first call on the card, warm the
    branches it did not take (``ops/graph_cond.warm_up``)."""
    from ...jit import static_function as _sf

    if not _sf.warming():
        return
    dev = next((_val(p).device for p in preds
                if isinstance(_val(p), torch.Tensor) and _val(p).is_cuda),
               None)
    if dev is None:
        return
    for i, fn in enumerate(fns):
        if i != taken:
            _gc.warm_up(fn, dev)


# ------------------------------------------------------------------ cond
def cond(pred, true_fn: Optional[Callable] = None,
         false_fn: Optional[Callable] = None, name: Optional[str] = None,
         return_names=None):
    """``static/nn/control_flow.py:873``: ``true_fn()`` when ``pred``
    holds else ``false_fn()``; both return the same structure."""
    if true_fn is None and false_fn is None:
        return None
    true_fn = true_fn if true_fn is not None else (lambda: None)
    false_fn = false_fn if false_fn is not None else (lambda: None)
    if not callable(true_fn) or not callable(false_fn):
        raise TypeError("cond: true_fn and false_fn must be callable")

    def choose(preds):
        k = int(_pred_value(preds[0]))
        _warm_others([false_fn, true_fn], k, preds)
        return k

    def public(p):
        return cond(p, true_fn, false_fn, name)

    return _multiway(lambda v: v[0].reshape(()).to(torch.int32), choose,
                     [pred], [false_fn, true_fn], name or "cond", public)


# ------------------------------------------------------------------ case
def case(pred_fn_pairs, default: Optional[Callable] = None,
         name: Optional[str] = None):
    """``static/nn/control_flow.py:564``: the fn of the first true
    predicate; ``default`` (or the last pair's fn) when none holds."""
    if not isinstance(pred_fn_pairs, (list, tuple)) or not pred_fn_pairs:
        raise TypeError("case: pred_fn_pairs must be a non-empty list/tuple")
    pairs = []
    for item in pred_fn_pairs:
        if not isinstance(item, (list, tuple)) or len(item) != 2:
            raise TypeError(f"case: each entry must be a (pred, fn) pair, "
                            f"got {item!r}")
        p, f = item
        if not callable(f):
            raise TypeError("case: fn must be callable")
        pairs.append((p, f))
    if default is None:
        default = pairs[-1][1]  # the reference: the last fn is the default
        pairs = pairs[:-1]
        if not pairs:
            return default()
    elif not callable(default):
        raise TypeError("case: default must be callable")
    preds = [p for p, _ in pairs]
    fns = [f for _, f in pairs] + [default]

    def select(vals):
        stacked = torch.stack([v.reshape(()).to(torch.bool) for v in vals])
        first = torch.argmax(stacked.to(torch.int32)).to(torch.int32)
        return torch.where(stacked.any(), first,
                           torch.full_like(first, len(vals)))

    def choose(ps):
        k = next((i for i, p in enumerate(ps) if _pred_value(p)), len(ps))
        _warm_others(fns, k, ps)
        return k

    def public(*ps):
        return case(list(zip(ps, fns[:-1])), default=default, name=name)

    return _multiway(select, choose, preds, fns, name or "case", public)


# ----------------------------------------------------------- switch_case
def switch_case(branch_index, branch_fns, default: Optional[Callable] = None,
                name: Optional[str] = None):
    """``static/nn/control_flow.py:697``: the branch whose index equals
    ``branch_index``; ``default`` (or the largest index's fn) otherwise."""
    if isinstance(branch_fns, dict):
        items = list(branch_fns.items())
    elif isinstance(branch_fns, (list, tuple)):
        if branch_fns and callable(branch_fns[0]):
            items = list(enumerate(branch_fns))
        else:
            items = [tuple(it) for it in branch_fns]
    else:
        raise TypeError("switch_case: branch_fns must be a list/tuple/dict")
    keys = [int(k) for k, _ in items]
    if len(set(keys)) != len(keys):
        raise ValueError(f"switch_case: duplicate branch index in {keys}")
    items = sorted(((int(k), f) for k, f in items), key=lambda kv: kv[0])
    for _, f in items:
        if not callable(f):
            raise TypeError("switch_case: every branch fn must be callable")
    if default is None:
        default = items[-1][1]  # the reference: the largest index's fn
    elif not callable(default):
        raise TypeError("switch_case: default must be callable")
    fns = [f for _, f in items] + [default]

    def select(vals):
        bi = vals[0].reshape(()).to(torch.int64)
        sel = torch.full((), len(items), dtype=torch.int32, device=bi.device)
        for pos, (k, _) in enumerate(items):
            sel = torch.where(bi == k, torch.full_like(sel, pos), sel)
        return sel

    def choose(ps):
        v = _val(ps[0])
        key = int(v.reshape(()).item() if isinstance(v, torch.Tensor)
                  else v)
        k = next((pos for pos, (kk, _) in enumerate(items) if kk == key),
                 len(items))
        _warm_others(fns, k, ps)
        return k

    def public(bi):
        return switch_case(bi, dict(items), default=default, name=name)

    return _multiway(select, choose, [branch_index], fns,
                     name or "switch_case", public)


# ------------------------------------------------------------ while_loop
def while_loop(cond, body, loop_vars, is_test: bool = False,
               name: Optional[str] = None):
    """``static/nn/control_flow.py:401``: ``body(*loop_vars)`` while
    ``cond(*loop_vars)`` holds; returns the final loop vars."""
    if not callable(cond) or not callable(body):
        raise TypeError("while_loop: cond and body must be callable")
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise ValueError("while_loop: loop_vars must be a non-empty "
                         "list/tuple")
    loop_vars = list(loop_vars)
    leaves, rebuild = _flatten(loop_vars)
    if _exported(*leaves):
        return _exported_while(cond, body, loop_vars, leaves, rebuild)
    if _captured(*leaves):
        return _captured_while(cond, body, loop_vars, leaves, rebuild)
    rec = _recorded(*leaves)
    first = None
    if rec is None:
        first = cond(*loop_vars)
        rec = _recorded(first)
    if rec is not None:
        return _recorded_while(rec, cond, body, loop_vars, leaves, rebuild,
                               name or "while_loop")
    return _eager_while(cond, body, loop_vars, first)


def _eager_while(cond, body, loop_vars, first=None):
    """The concrete regime: a Python loop (the reference's dygraph path,
    ``control_flow.py:520``), differentiable through any trip count."""
    from ...jit import static_function as _sf

    if first is None:
        first = cond(*loop_vars)
    trips = 0
    while _pred_value(first):
        out = body(*loop_vars)
        out = list(out) if isinstance(out, (list, tuple)) else [out]
        if len(out) != len(loop_vars):
            raise ValueError(
                f"while_loop: body returned {len(out)} vars, expected "
                f"{len(loop_vars)}")
        loop_vars = out
        trips += 1
        first = cond(*loop_vars)
    if trips == 0 and _sf.warming():
        dev = _val(first).device if isinstance(_val(first),
                                               torch.Tensor) else None
        if dev is not None and dev.type == "cuda":
            _gc.warm_up(lambda: body(*loop_vars), dev)
    return loop_vars


def _recorded_while(rec, cond, body, loop_vars, leaves, rebuild, name):
    # fresh cells for the carry: an initial loop var may be the very cell
    # the body also reads through its closure (`s = x`, then `s + x`)
    fresh = [Tensor._wrap(_val(t)) if isinstance(t, Tensor) else t
             for t in leaves]
    lv = rebuild([_val(t) for t in fresh])
    lv_fresh = list(lv)
    out, caps = _discover_run(lambda: _eager_while(cond, body, lv_fresh),
                              exclude=[t for t in fresh
                                       if isinstance(t, Tensor)])
    cells = [t for t in leaves if isinstance(t, Tensor)]
    n = len(cells)

    def run_public(*cells_now):
        it = iter(cells_now[:n])
        vals = [Tensor._wrap(_val(next(it))) if isinstance(t, Tensor)
                else t for t in leaves]
        return while_loop(cond, body, rebuild([_val(v) for v in vals]),
                          name=name)

    return _record_construct(rec, name, run_public, cells + caps, out)


def _captured_while(cond, body, loop_vars, leaves, rebuild):
    """One WHILE node of the graph being captured; forward-only, the
    outputs detached (module docstring)."""
    for v in leaves:
        if not isinstance(v, (Tensor, torch.Tensor)):
            raise TypeError(
                "while_loop under capture: every loop_vars leaf must be a "
                f"Tensor (got {type(v).__name__}): a Python scalar would be "
                "a constant of the graph, not a carried value")
    for v in loop_vars:
        if not isinstance(v, (Tensor, torch.Tensor, list, tuple, dict)):
            raise TypeError(
                "while_loop under capture: every loop_vars leaf must be a "
                f"Tensor (got {type(v).__name__})")
    n = len(leaves)

    def cond_t(*vals):
        r = cond(*rebuild(list(vals)))
        return _val(r)

    def body_t(*vals):
        out = body(*rebuild(list(vals)))
        out = list(out) if isinstance(out, (list, tuple)) else [out]
        got, _ = _flatten(out)
        if len(got) != n:
            raise ValueError(
                f"while_loop: body returned {len(got)} leaves, expected {n} "
                "(must match loop_vars structure)")
        return [_val(x) for x in got]

    with torch.no_grad():
        bufs = _gc.while_node(cond_t, body_t, [_val(x) for x in leaves])
    return rebuild(bufs)
