"""The record of a static Program: its forward ops, replayed per feed.

Counterpart of the JAX package's tape nodes (``autograd/engine.py``
``make_node_for_outputs``, each node keeping its forward ``fn`` and its
input values) and of ``_replay_function``
(``incubate/autograd/__init__.py:233``), which rebuilds the function
placeholders -> fetches from them. The port's tape is torch autograd's,
which records backward and not forward, so a Program records its forward
itself while it is open (``program_guard``, or ``enable_static``), at the
port's two op entries:

- ``autograd.engine.apply_op``: one node an op, keeping its callable,
  attrs, ``differentiable`` flag, name and the amp state it ran under;
- ``tensor.facade_io``: one node a call, so a model written in torch
  whose ``forward`` is behind the facade (GPT, Llama) is one node.

A node's inputs are sources: a placeholder (``("ph", name)``), an output
of an earlier node (``("out", node, index)``), a ``Parameter``'s cell,
read live at replay so the optimizer's in-place updates are seen, or any
other value as it was (``("const", value)``: a constant, or a buffer the
code writes in place). Outputs are keyed by the identity of their torch
values, which the nodes keep alive. Nodes are kept in the order they ran,
which is an order of the graph: a replay runs the nodes a fetch needs in
that order, each through its entry again (``apply_op`` under the amp
state it was recorded in, the facade call on the new values), so K1-K3
launch inside the replay as they do in the eager forward.

Tensor control flow on a placeholder-derived predicate records as one
node (``static.nn.control_flow``), which dispatches on the fed predicate
when it runs. A value computed from a placeholder by something that goes
through neither entry (a host read such as ``.numpy()``, a raw torch
call on ``_value``) is a constant of the program: the tests feed new
values and require every fetch derived from a feed to change.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Sequence

import torch

from .. import amp
from .. import tensor as _tensor
from ..tensor import Parameter, Tensor

__all__ = ["Recorder", "Node", "replay_plan", "run_plan"]


class Node:
    """One recorded op, facade call or control-flow construct."""

    __slots__ = ("kind", "fn", "attrs", "differentiable", "name", "amp",
                 "inputs", "spec", "outputs", "derived", "order", "modules")

    def __init__(self, kind, fn, inputs, outputs, *, attrs=None,
                 differentiable=True, name="", spec=None, derived=False):
        self.kind = kind              # "op" | "call" | "flow"
        self.fn = fn
        self.attrs = attrs
        self.differentiable = differentiable
        self.name = name
        self.amp = amp.current_state()
        self.inputs = inputs          # sources
        self.spec = spec              # a call's argument tree
        self.outputs = outputs        # build-time torch values
        self.derived = derived        # reads a placeholder
        self.order = 0                # position in the record
        self.modules = ()             # a call's torch modules

    def __repr__(self):
        name = self.name or getattr(self.fn, "__name__", "?")
        return f"Node({self.kind}, {name})"


def _flatten(tree, leaves: List):
    """A call's arguments with every Tensor and torch tensor moved to
    ``leaves`` (a spec that rebuilds them)."""
    if isinstance(tree, Tensor):
        leaves.append(tree)
        return ("L", len(leaves) - 1, True)
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("L", len(leaves) - 1, False)
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_flatten(v, leaves) for v in tree])
    if isinstance(tree, dict):
        return ("dict", [(k, _flatten(v, leaves)) for k, v in tree.items()])
    return ("S", tree)


def _rebuild(spec, vals):
    kind = spec[0]
    if kind == "L":
        return vals[spec[1]]
    if kind == "S":
        return spec[1]
    if kind == "dict":
        return {k: _rebuild(s, vals) for k, s in spec[1]}
    items = [_rebuild(s, vals) for s in spec[1]]
    return items if kind == "list" else tuple(items)


def _out_values(out) -> List[torch.Tensor]:
    """The torch values of an op's or a call's outputs (nested tuples
    and lists of Tensors; anything else is not an output)."""
    vals: List[torch.Tensor] = []

    def go(x):
        if isinstance(x, Tensor):
            vals.append(x._value)
        elif isinstance(x, torch.Tensor):
            vals.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                go(v)
        elif isinstance(x, dict):
            for v in x.values():
                go(v)

    go(out)
    return vals


class Recorder:
    """The record of one Program (module docstring)."""

    def __init__(self, program):
        self.program = program
        self.nodes: List[Node] = []
        self._producer: Dict[int, tuple] = {}
        self._paused = 0
        self.modules: List[Any] = []  # the modules whose forward ran

    # ------------------------------------------------------ registry
    def records(self) -> bool:
        return self._paused == 0

    @contextlib.contextmanager
    def pause(self):
        """Record nothing in the block (a facade call's or a construct's
        inner ops)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def placeholder(self, name: str, t: Tensor) -> None:
        self._producer[id(t._value)] = ("ph", name, t._value)

    def source(self, x) -> tuple:
        """The source of an input (a Tensor or a torch tensor)."""
        v = x._value if isinstance(x, Tensor) else x
        hit = self._producer.get(id(v))
        if hit is not None:
            return hit[:2] if hit[0] == "ph" else ("out", hit[1], hit[2])
        if isinstance(x, Parameter):
            return ("cell", x)
        return ("const", v)

    def derived(self, x) -> bool:
        """Whether ``x`` was computed from a placeholder."""
        v = x._value if isinstance(x, Tensor) else x
        hit = self._producer.get(id(v))
        if hit is None:
            return False
        return hit[0] == "ph" or hit[1].derived

    def _add(self, node: Node) -> None:
        node.derived = any(s[0] == "ph" or (s[0] == "out" and s[1].derived)
                           for s in node.inputs)
        node.order = len(self.nodes)
        self.nodes.append(node)
        for i, v in enumerate(node.outputs):
            self._producer[id(v)] = ("out", node, i)

    # ------------------------------------------------------- entries
    def op(self, fn, attrs, differentiable, name, tensors, out) -> None:
        self._add(Node("op", fn, [self.source(t) for t in tensors],
                       _out_values(out), attrs=attrs,
                       differentiable=differentiable, name=name))

    def call(self, fn, args, kwargs):
        """Run the facade call ``fn(*args, **kwargs)`` and record it as
        one node (``tensor.facade_io``)."""
        leaves: List = []
        spec = _flatten((tuple(args), dict(kwargs)), leaves)
        with self.pause():
            vals = [x._value if isinstance(x, Tensor) else x for x in leaves]
            a, k = _rebuild(spec, vals)
            out = fn(*a, **k)
        wrapped = _tensor._wrap_tree(out) if any(
            isinstance(x, Tensor) for x in leaves) else out
        owners = [o for o in (getattr(fn, "__self__", None), *args)
                  if isinstance(o, torch.nn.Module)]
        for owner in owners:
            if all(m is not owner for m in self.modules):
                self.modules.append(owner)
        node = Node("call", fn, [self.source(x) for x in leaves],
                    _out_values(out), spec=spec,
                    name=getattr(fn, "__qualname__", "call"))
        node.modules = tuple(owners)
        self._add(node)
        return wrapped

    def flow(self, fn, inputs: Sequence, outputs: Sequence[torch.Tensor],
             name: str) -> None:
        """Record a control-flow construct: ``fn(*input values)`` returns
        the list of its output values."""
        self._add(Node("flow", fn, [self.source(x) for x in inputs],
                       list(outputs), name=name))


def replay_plan(fetch_sources: Sequence[tuple]) -> List[Node]:
    """The nodes the fetches need, in the order they were recorded."""
    need: Dict[int, Node] = {}
    stack = [s[1] for s in fetch_sources if s[0] == "out"]
    while stack:
        node = stack.pop()
        if id(node) in need:
            continue
        need[id(node)] = node
        stack.extend(s[1] for s in node.inputs if s[0] == "out")
    return sorted(need.values(), key=lambda n: n.order)


def run_plan(plan: Sequence[Node], fetch_sources: Sequence[tuple],
             feeds: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """Run ``plan`` (from :func:`replay_plan`) on ``feeds`` and return the
    fetches' values."""
    from ..autograd.engine import apply_op

    env: Dict[int, List[torch.Tensor]] = {}

    def value(src):
        kind = src[0]
        if kind == "ph":
            return feeds[src[1]]
        if kind == "out":
            return env[id(src[1])][src[2]]
        if kind == "cell":
            return src[1]._value
        return src[1]

    for node in plan:
        vals = [value(s) for s in node.inputs]
        with amp.restored_state(node.amp):
            if node.kind == "op":
                out = apply_op(node.fn, [Tensor._wrap(v) for v in vals],
                               node.attrs, node.differentiable, node.name)
            elif node.kind == "call":
                a, k = _rebuild(node.spec, vals)
                out = node.fn(*a, **k)
            else:
                out = node.fn(*vals)
        env[id(node)] = _out_values(out)
    return [value(s) for s in fetch_sources]
