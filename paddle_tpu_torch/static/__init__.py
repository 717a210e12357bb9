"""``paddle.static``: Program, Executor, data, program_guard
(``paddle_tpu/static/__init__.py``).

The JAX package collapses the reference's op-desc Program and its
InterpreterCore into its eager tape: ``static.data`` makes placeholder
leaves, the layer calls record tape nodes, and ``Executor.run`` replays
the subgraph placeholders -> fetches as one function compiled with
``jax.jit`` per feed signature. The port does the same over its own
record (:mod:`.record`): while a Program is open its ops are recorded,
and ``Executor.run`` replays them as one ``jit.StaticFunction`` per feed
signature, captured as one CUDA graph on the card and run eagerly on the
CPU. ``Optimizer.minimize`` inside a program registers the loss and the
optimizer, and a run is then one training step: the forward, the
gradients of the loss (``torch.autograd.grad`` over the optimizer's
parameters, added to their ``.grad``), ``optimizer.step()`` and
``clear_grad()``, all in the one graph.

A program builds under ``no_grad`` (``program_guard``,
``enable_static``): the build computes values and records ops; the
gradients are a run's. ``Executor(place)``: no place means the default
device (the card, or ``RuntimeError`` without one, unless
``set_device("cpu")``); ``"cpu"`` or ``CPUPlace()`` runs on the CPU.
Feeds go to that device.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import dtypes as _dtypes
from .. import tensor as _tensor
from ..jit.static_function import InputSpec, StaticFunction
from ..optimizer.optimizer import _value
from ..tensor import Parameter, Tensor
from . import record as _record

from .legacy import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy,
    ExponentialMovingAverage, Print, Variable, WeightNormParamAttr,
    accuracy, append_backward, auc, create_global_var, create_parameter,
    ctr_metric_bundle, deserialize_persistables, deserialize_program,
    device_guard, exponential_decay, gradients, load, load_from_file,
    load_program_state, name_scope, normalize_program, py_func, save,
    save_to_file, scope_guard, serialize_persistables, serialize_program,
    set_program_state,
)

__all__ = [
    "Program", "program_guard", "default_main_program",
    "default_startup_program", "data", "Executor", "InputSpec",
    "save_inference_model", "load_inference_model", "cpu_places",
    "cuda_places", "xpu_places", "global_scope",
    "append_backward", "gradients", "scope_guard", "name_scope",
    "BuildStrategy", "ExecutionStrategy", "CompiledProgram", "Print",
    "py_func", "WeightNormParamAttr", "ExponentialMovingAverage",
    "save", "load", "save_to_file", "load_from_file",
    "serialize_program", "serialize_persistables", "deserialize_program",
    "deserialize_persistables", "set_program_state", "normalize_program",
    "Variable", "create_global_var", "create_parameter", "device_guard",
    "load_program_state", "accuracy", "auc", "exponential_decay",
    "ctr_metric_bundle",
]


_programs: list = []  # weak references to every Program, oldest first


class Program:
    """The reference's Program (``fluid/framework.py:5222``): here its
    placeholders, its record of forward ops and, after ``minimize``, its
    training objective."""

    def __init__(self):
        self.placeholders: Dict[str, Tensor] = {}
        self.declared_shapes: Dict[str, tuple] = {}  # None dims kept
        self.loss: Optional[Tensor] = None
        self.optimizer = None
        self.random_seed = 0
        self._record = _record.Recorder(self)
        _programs[:] = [r for r in _programs if r() is not None]
        _programs.append(weakref.ref(self))

    def clone(self, for_test: bool = False) -> "Program":
        p = Program()
        p.placeholders = dict(self.placeholders)
        p.declared_shapes = dict(self.declared_shapes)
        p._record = self._record
        if not for_test:
            p.loss, p.optimizer = self.loss, self.optimizer
        return p

    def global_block(self):
        return self

    @property
    def var_names(self):
        return list(self.placeholders)

    def __jit_state__(self):
        """The objects a captured run's step reads and writes: the
        optimizer and the modules and Layers the record ran."""
        return [self.optimizer, *self._record.modules]

    # -- parameter snapshot (legacy save/load and serialization) -------
    def _program_parameters(self) -> list:
        """The optimizer's parameters, else those the loss reaches."""
        if self.optimizer is not None and self.optimizer._parameter_list:
            return list(self.optimizer._parameter_list)
        if self.loss is not None:
            return _collect_parameters(self.loss)
        return []

    def _param_key(self, i: int, p) -> str:
        name = getattr(p, "name", None)
        return name if name else f"param_{i}"

    def _param_state(self) -> dict:
        return {self._param_key(i, p): p.numpy()
                for i, p in enumerate(self._program_parameters())}

    def _set_param_state(self, state: dict) -> None:
        params = self._program_parameters()
        used = set()
        for i, p in enumerate(params):
            for key in (self._param_key(i, p), f"param_{i}"):
                if key in state:
                    with torch.no_grad():
                        p._value.copy_(torch.as_tensor(
                            np.asarray(state[key]), dtype=p._value.dtype))
                    used.add(key)
                    break
        unused = set(state) - used
        if unused:
            # the reference's set_program_state errors on unused keys
            raise ValueError(
                f"state dict keys not matched to any program parameter: "
                f"{sorted(unused)[:8]}{'...' if len(unused) > 8 else ''}")

    def _placeholder_spec(self) -> dict:
        return {name: {"shape": list(self.declared_shapes.get(
                           name, tuple(t.shape))),
                       "dtype": str(t.dtype)}
                for name, t in self.placeholders.items()}


_default_main = Program()
_default_startup = Program()
_guard_stack: List[tuple] = []
_declared_by_id: Dict[int, tuple] = {}  # placeholder id -> declared shape
_static_mode = False


def _sync_recorder() -> None:
    """Point the op entries at the open program's record: the innermost
    ``program_guard``'s, else the default program's under
    ``enable_static``, else none."""
    if _guard_stack:
        _tensor.program_recorder = _guard_stack[-1][0]._record
    elif _static_mode:
        _tensor.program_recorder = _default_main._record
    else:
        _tensor.program_recorder = None


_grad_before_static = True


def _enable_static() -> None:
    global _static_mode, _grad_before_static
    if not _static_mode:
        _grad_before_static = torch.is_grad_enabled()
    _static_mode = True
    torch.set_grad_enabled(False)  # as program_guard builds
    _sync_recorder()


def _disable_static() -> None:
    global _static_mode
    if _static_mode:
        torch.set_grad_enabled(_grad_before_static)
    _static_mode = False
    _sync_recorder()


class _NoRecord:
    """No program records while an Executor runs one."""

    def __enter__(self):
        self.rec = _tensor.program_recorder
        _tensor.program_recorder = None

    def __exit__(self, *exc):
        _tensor.program_recorder = self.rec
        return False


def default_main_program() -> Program:
    """``fluid/framework.py`` default_main_program."""
    return _guard_stack[-1][0] if _guard_stack else _default_main


def default_startup_program() -> Program:
    return _guard_stack[-1][1] if _guard_stack else _default_startup


class program_guard:
    """``static.program_guard``: ops record into ``main_program`` inside
    the block."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program or Program()

    def __enter__(self):
        # a build computes values, not gradients: the build-time forward
        # keeps no autograd graph (its accumulators would be bound to the
        # build's stream, not to the one an Executor's capture runs on)
        self._grad = torch.is_grad_enabled()
        torch.set_grad_enabled(False)
        _guard_stack.append((self.main, self.startup))
        _sync_recorder()
        return self

    def __exit__(self, *exc):
        _guard_stack.pop()
        _sync_recorder()
        torch.set_grad_enabled(self._grad)
        return False


def data(name: str, shape: Sequence[int], dtype="float32",
         lod_level: int = 0) -> Tensor:
    """``static/input.py`` data: a placeholder of the current program, on
    the default device. ``None``/-1 dims become 1 at build;
    ``Executor.run`` takes any size there (a signature each)."""
    from ..device import default_device

    concrete = [1 if (d is None or int(d) < 0) else int(d) for d in shape]
    dt = _dtypes.convert_dtype(dtype)
    # stop_gradient=False, as the JAX package's placeholder (there it
    # makes every op downstream record a tape node; the port's record
    # does not depend on it)
    t = Tensor(torch.zeros(concrete, dtype=dt, device=default_device()),
               stop_gradient=False)
    t.name = name
    prog = default_main_program()
    prog.placeholders[name] = t
    prog._record.placeholder(name, t)
    declared = tuple(
        None if (d is None or int(d) < 0) else int(d) for d in shape)
    prog.declared_shapes[name] = declared
    _declared_by_id[id(t)] = declared
    return t


def _collect_parameters(loss: Tensor,
                        trainable_only: bool = True) -> List[Parameter]:
    """Every trainable Parameter the loss reaches: the static
    ``minimize()`` contract (the reference trains every trainable var of
    the program when no parameter list is given). Read off the program's
    record when ``loss`` was recorded, else off torch autograd's graph."""
    return _collect_parameters_multi([loss], trainable_only)


def _collect_parameters_multi(fetches,
                              trainable_only: bool = True) -> list:
    seen, out = set(), []

    def add(p):
        v = p._value if isinstance(p, Tensor) else p
        if id(p) not in seen and (v.requires_grad or not trainable_only):
            seen.add(id(p))
            out.append(p)

    for rec in _recorders_of(fetches):
        srcs = [rec.source(f) for f in fetches]
        for node in _record.replay_plan(srcs):
            for s in node.inputs:
                if s[0] == "cell":
                    add(s[1])
            for m in node.modules:
                for p in m.parameters():
                    add(p)
        for s in srcs:
            if s[0] == "cell":
                add(s[1])
    if not out:
        for p in _autograd_leaves(fetches):
            add(p)
    return out


def _recorders_of(fetches) -> list:
    """The records of the live programs that recorded any of
    ``fetches``, newest first."""
    recs = []
    for ref in reversed(_programs):
        prog = ref()
        if prog is None:
            continue
        rec = prog._record
        if all(r is not rec for r in recs) and any(
                rec.source(f)[0] in ("out", "ph") for f in fetches):
            recs.append(rec)
    return recs


def _autograd_leaves(fetches) -> list:
    """The facade Parameters among the leaves of the fetches' autograd
    graph, by the identity of their torch values."""
    leaves, seen = [], set()
    stack = [f._value.grad_fn for f in fetches
             if isinstance(f, Tensor) and f._value.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        var = getattr(fn, "variable", None)
        if var is not None:
            leaves.append(var)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    by_value = {id(p._value): p for p in _live_parameters()}
    return [by_value[id(v)] for v in leaves if id(v) in by_value]


def _live_parameters():
    import gc

    return [o for o in gc.get_objects() if issubclass(type(o), Parameter)]


class Executor:
    """``fluid/executor.py:893``: ``run`` replays the recorded subgraph
    per (program, fetches, feed signature) as one captured step (module
    docstring)."""

    def __init__(self, place=None):
        from ..device import resolve_device, torch_device_name

        self.place = place
        name = None if place is None else torch_device_name(
            place if isinstance(place, str) else _place_name(place))
        self.device = resolve_device(name)
        self._cache: dict = {}

    def _resolve_fetch(self, program: Program, f):
        if isinstance(f, Tensor):
            return f
        if isinstance(f, str):
            if f in program.placeholders:
                return program.placeholders[f]
            raise ValueError(
                f"fetch_list name {f!r} is not a program placeholder; pass "
                "the Tensor object for intermediate variables (the record "
                "has no global name registry)")
        raise TypeError(f"bad fetch_list entry: {f!r}")

    def run(self, program: Optional[Program] = None, feed: dict = None,
            fetch_list: Sequence = None, return_numpy: bool = True):
        program = program or default_main_program()
        if isinstance(program, CompiledProgram):
            program = program._program
        feed = feed or {}
        fetch_list = [self._resolve_fetch(program, f)
                      for f in (fetch_list or [])]
        if not fetch_list and program.loss is None:
            return []  # a startup program: the parameters exist already
        rec = program._record
        train = program.loss is not None and program.optimizer is not None
        fetches = list(fetch_list)
        loss_idx = None
        if train:
            for i, f in enumerate(fetches):
                if f is program.loss:
                    loss_idx = i
                    break
            if loss_idx is None:
                fetches.append(program.loss)
                loss_idx = len(fetches) - 1
        srcs = [rec.source(f) for f in fetches]
        plan = _record.replay_plan(srcs)
        # every placeholder the fetches read must be fed: a missing feed
        # silently evaluating to the build-time zeros is how wrong numbers
        # escape unnoticed
        needed = {s[1] for s in srcs if s[0] == "ph"}
        for node in plan:
            needed.update(s[1] for s in node.inputs if s[0] == "ph")
        missing = [n for n in program.placeholders
                   if n in needed and n not in feed]
        if missing:
            raise KeyError(
                f"feed is missing required placeholder(s): {missing}")
        # sorted names: the feed dict's order cannot move a binding
        ph_names = sorted(n for n in feed if n in program.placeholders)
        vals = [self._feed_value(program, n, feed[n]) for n in ph_names]
        key = (id(program), tuple(id(f) for f in fetches), train,
               tuple(ph_names),
               tuple((tuple(v.shape), str(v.dtype)) for v in vals))
        step = self._cache.get(key)
        if step is None:
            step = self._cache[key] = self._make_step(
                program, plan, srcs, ph_names, train, loss_idx)
        with _NoRecord():
            outs = step(*vals)
        outs = outs[: len(fetch_list)]
        if return_numpy:
            return [o.numpy() for o in outs]
        return list(outs)

    def _feed_value(self, program: Program, name: str, v) -> torch.Tensor:
        ph = program.placeholders[name]
        if isinstance(v, Tensor):
            v = v._value
        t = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v)
        if t.dtype != ph._value.dtype and not (
                t.is_floating_point() != ph._value.is_floating_point()):
            t = t.to(ph._value.dtype)
        return t.to(self.device)

    def _make_step(self, program: Program, plan, srcs, ph_names, train,
                   loss_idx):
        opt = program.optimizer if train else None
        params = list(opt._parameter_list) if opt is not None else []
        values = [_value(p) for p in params]

        def executor_step(*feed_vals):
            feeds = dict(zip(ph_names, feed_vals))
            with torch.enable_grad() if train else torch.no_grad():
                outs = _record.run_plan(plan, srcs, feeds)
                if train:
                    live = [v for v in values if v.requires_grad]
                    grads = torch.autograd.grad(outs[loss_idx], live,
                                                allow_unused=True)
                    for v, g in zip(live, grads):
                        if g is not None:
                            v.grad = g if v.grad is None else v.grad + g
            if train:
                opt.step()
                opt.clear_grad()
            return [Tensor._wrap(o.detach()) for o in outs]

        executor_step.__name__ = f"executor_step_{len(self._cache)}"
        return StaticFunction(executor_step, observe=[program])

    def close(self):
        pass


def _place_name(place) -> str:
    kind = type(place).__name__.lower()
    if "cpu" in kind:
        return "cpu"
    idx = getattr(place, "get_device_id", lambda: 0)()
    return f"cuda:{idx}"


# ------------------------------------------------------------ inference io
def save_inference_model(path_prefix: str, feed_vars, fetch_vars, executor,
                         program: Optional[Program] = None, **kwargs):
    """``static/io.py`` save_inference_model: the placeholders -> fetches
    subgraph through ``jit.save`` (``torch.export``), with the
    placeholders' declared shapes (a ``None`` dim stays dynamic)."""
    from .. import jit
    from ..nn.layer_base import Layer

    feed_vars = list(feed_vars) if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = list(fetch_vars) if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    recs = [program._record] if program is not None else \
        _recorders_of(fetch_vars)
    if not recs:
        raise ValueError("save_inference_model: the fetches were not "
                         "recorded by a static Program")
    rec = recs[0]
    srcs = [rec.source(f) for f in fetch_vars]
    plan = _record.replay_plan(srcs)
    names = []
    for v in feed_vars:
        s = rec.source(v)
        if s[0] != "ph":
            raise ValueError(f"feed var {v.name!r} is not a placeholder")
        names.append(s[1])
    params = {}
    for node in plan:
        for s in node.inputs:
            if s[0] == "cell":
                params[id(s[1])] = s[1]

    class _Prog(Layer):
        def __init__(self):
            super().__init__()
            for i, p in enumerate(params.values()):
                setattr(self, f"p{i}", p)

        def forward(self, *xs):
            feeds = {n: (x._value if isinstance(x, Tensor) else x)
                     for n, x in zip(names, xs)}
            out = _record.run_plan(plan, srcs, feeds)
            res = tuple(Tensor._wrap(o) for o in out)
            return res if len(res) > 1 else res[0]

    specs = [InputSpec(_declared_by_id.get(id(v), tuple(v.shape)),
                       v.dtype) for v in feed_vars]
    jit.save(_Prog(), path_prefix, input_spec=specs)


def load_inference_model(path_prefix: str, executor, **kwargs):
    """``static/io.py`` load_inference_model: (the loaded program as a
    callable, feed names, fetch names), on the executor's device."""
    from .. import jit

    device = getattr(executor, "device", None)
    layer = jit.load(path_prefix, device=device) if device is not None \
        else jit.load(path_prefix)
    return layer, getattr(layer, "_feed_names", None), \
        getattr(layer, "_fetch_names", None)


# ---------------------------------------------------------------- places
def cpu_places(device_count: Optional[int] = None):
    return ["cpu"] * (device_count or 1)


def cuda_places(device_ids=None):
    """The cards, as ``gpu:N`` (none without a card)."""
    if not torch.cuda.is_available():
        return []
    ids = range(torch.cuda.device_count()) if device_ids is None \
        else device_ids
    return [f"gpu:{i}" for i in ids]


def xpu_places(device_ids=None):
    return []


_scope = {}


def global_scope():
    return _scope


# imported last: static.nn's layers build on the facade above
from . import nn  # noqa: F401,E402

__all__.append("nn")
