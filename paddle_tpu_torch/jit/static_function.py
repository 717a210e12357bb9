"""StaticFunction: a step captured as one CUDA graph per input signature.

Counterpart of ``paddle_tpu/jit/static_function.py``. The JAX package
traces the imperative step (forward, ``loss.backward()``, ``opt.step()``)
into one XLA program per input signature, its mutable state passed in
and out as slots. The port runs the same imperative code and captures it
on the card as one ``torch.cuda.CUDAGraph`` per signature, replayed on
every later call. What the JAX package carries into its program as data
stays in device cells that keep their storage, so each replay reads and
writes the same memory:

- parameters, optimizer accumulators and ``@master`` are written in
  place by the optimizer (``copy_``, never rebound);
- the learning rate is each optimizer's 0-d lr buffer, written before
  every replay (``Optimizer._write_lr``: the JAX ``lr_vals``);
- ``GradScaler``'s scale and counters are device cells it updates in
  place, and the ``_found_inf`` skip is a ``torch.where``;
- dropout seeds are slots of the program's seed buffer
  (``generator.SeedTape``): the capture records the host generator's
  draws, and before every replay they are drawn again in the same order
  and staged into the slots, so the host stream advances as the eager
  calls' would (the JAX package's key slot, ``_GenSlot``).

Per signature (tensor leaves by shape, dtype, device and
``stop_gradient``, other leaves by value, and the ``training`` flag of
every observed module, as the JAX key): the first call runs eagerly (the
warm-up: kernels build, accumulators are made lazily), on the side
stream the capture will use, so that any grad accumulator it leaves
alive is bound to the capture's stream; the second makes
every optimizer's state (``_materialize_accumulators``), copies its
tensor arguments into static buffers, captures the function into the
graph (in one memory pool per ``StaticFunction``, the cyclic collector
off for the span of the capture, the allocator's cache emptied before
it) and replays it once; every later call copies its arguments into the
static buffers and replays. Each call makes one update, as a call of the
JAX step does. A call returns clones of the graph's outputs (a caller may
keep every step's loss). Python side effects of the function happen once,
at the capture, as they happen once at a JAX trace.

Nothing falls back: a capture that fails (a host read of a device value
such as ``.item()``, ``bool(tensor)`` or ``.numpy()`` inside the
function, or an operation a graph cannot hold) raises a RuntimeError
naming the function; Python control flow on tensor values needs the
``dy2static`` pass, which is not ported yet. On CPU tensors the function
runs eagerly on every call (there is no graph), with the same signature
cache, counts and state-in-place contract.

Each captured program increments ``paddle_tpu_jit_compiles_total{fn,
source="fresh"}`` once (on the CPU, the call that would capture). A CUDA
graph cannot leave its process, so there is no persistent cache:
``set_compile_cache_dir``/``get_compile_cache_dir``/``clear_compile_cache``
keep their names and record a directory nothing reads, and every program
is ``"fresh"``.

An object the step reaches may say that the step cannot be captured
(``__jit_capture__()``, returning ``("eager", why)`` or ``("refuse",
why)``; None when it can be). ``DataParallel`` over a ``gloo`` group (two
ranks sharing a card) says ``"eager"``: a gloo collective is a host
operation no CUDA graph can hold, so every call of such a step runs
eagerly, on the card as on the CPU, and ``eager_reason`` says why.
``distributed.ps.SparseEmbedding`` says ``"refuse"``: its rows come from
the servers on the host at each call, and a replay would reuse the
captured pull, so the call raises a RuntimeError naming the function.

``cost_analysis`` stands where the JAX package reads XLA's cost analysis
of the compiled program: for a signature that has run, a dict of
``flops`` (the products that ``torch.utils.flop_counter``'s formulas
count over the signature's first, eager call, plus the flops the flash
kernels K1-K3 do on their launches' inputs, by the formulas of their
bounds, since a counter cannot see a kernel launched through ctypes;
``flops_counted`` and ``flops_kernels`` are the two parts) and
``peak_bytes`` (the device memory allocated at the peak of that call, on
the card; None on the CPU). Unlike XLA's, the count leaves out the
elementwise work (activations, norms, the optimizer's update). Before
any call it is None. Not ported: ``lower``, ``jit.save``/``load`` and
the ``dy2static`` AST pass (``BucketedFunction`` is in
:mod:`.bucketing`).
"""
from __future__ import annotations

import dis
import gc
import os
import time
import types
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .. import dtypes
from .. import generator as _generator
from ..metrics import get_registry
from ..nn.layer_base import Layer
from ..ops import embedding_grad as _eg
from ..ops import flash_attention as _fa
from ..ops import paged_attention as _pa
from ..optimizer.optimizer import Optimizer, _value
from ..tensor import Tensor

__all__ = ["StaticFunction", "InputSpec", "set_compile_cache_dir",
           "get_compile_cache_dir", "clear_compile_cache"]


class InputSpec:
    """``paddle.static.InputSpec``: a shape (``None`` for a dim that may
    vary: each value is one more signature), a dtype and a name."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = dtypes.convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


# ------------------------------------------------------- compile cache
_cache_dir_override: Optional[str] = None


def set_compile_cache_dir(path: Optional[str]) -> None:
    """Recorded for the JAX package's API; nothing is stored there, since
    a CUDA graph cannot leave its process (module docstring)."""
    global _cache_dir_override
    _cache_dir_override = None if path is None else str(path)


def get_compile_cache_dir() -> Optional[str]:
    """:func:`set_compile_cache_dir`'s value, else the
    ``PADDLE_TPU_COMPILE_CACHE`` environment variable, else None."""
    if _cache_dir_override is not None:
        return _cache_dir_override
    return os.environ.get("PADDLE_TPU_COMPILE_CACHE") or None


def clear_compile_cache(memory: bool = True, disk: bool = False) -> int:
    """There is no cache to clear: returns 0."""
    return 0


# ----------------------------------------------------------- discovery
def _scan_state(objs: Sequence[Any]):
    """The optimizers and modules reachable from ``objs`` (closures,
    ``observe``, call arguments), walking lists, tuples, sets, dicts, an
    optimizer's grad clip and any ``__jit_state__()``: the optimizers'
    lr buffers are written before each replay and their state made
    before the capture; the modules' ``training`` flags join the
    signature. A module is a ``torch.nn.Module`` or a Paddle ``Layer``
    with each of its sublayers (whose flags ``train()``/``eval()`` set
    one by one); a Layer's parameters and buffers are its state cells
    (:func:`_layer_cells`)."""
    seen: set = set()
    opts: List[Optimizer] = []
    modules: List[Any] = []
    capture: List[tuple] = []
    stack = list(objs)
    while stack:
        o = stack.pop()
        if o is None or id(o) in seen or isinstance(o, torch.Tensor):
            continue
        seen.add(id(o))
        say = getattr(o, "__jit_capture__", None)
        if say is not None and not isinstance(o, type):
            verdict = say()
            if verdict is not None:
                capture.append(verdict)
        if isinstance(o, Layer):
            modules.append(o)
            stack.extend(o.sublayers())
        elif isinstance(o, torch.nn.Module):
            modules.append(o)
        elif isinstance(o, Optimizer):
            opts.append(o)
            stack.append(o._grad_clip)
        elif isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
        if hasattr(o, "__jit_state__") and not isinstance(o, type):
            stack.extend(o.__jit_state__())
    return opts, modules, capture


def _closure_objects(fn: Callable) -> list:
    """Objects the function can reach: bound self, closure cells,
    defaults, and the module globals it loads (a module-level train step
    holds its model and optimizer as globals)."""
    objs = []
    f = fn
    if getattr(f, "__self__", None) is not None:
        objs.append(f.__self__)
        f = getattr(f, "__func__", f)
    for cell in getattr(f, "__closure__", None) or ():
        try:
            objs.append(cell.cell_contents)
        except ValueError:
            pass
    objs.extend(getattr(f, "__defaults__", None) or ())
    code = getattr(f, "__code__", None)
    glob = getattr(f, "__globals__", None)
    if code is not None and glob is not None:
        loaded = set()
        stack = [code]
        while stack:
            c = stack.pop()
            loaded.update(ins.argval for ins in dis.get_instructions(c)
                          if ins.opname in ("LOAD_GLOBAL", "LOAD_NAME"))
            stack.extend(k for k in c.co_consts
                         if isinstance(k, types.CodeType))
        objs.extend(glob[name] for name in loaded if name in glob)
    return objs


# ------------------------------------------------------ arg flattening
def _flatten_args(tree):
    """``(tensors, meta, spec)``: the torch tensor of every tensor leaf
    (facade ``Tensor`` or ``torch.Tensor``), its ``stop_gradient``, and a
    spec that rebuilds the structure; other leaves are static."""
    tensors: List[torch.Tensor] = []
    meta: List[bool] = []

    def go(x):
        if isinstance(x, Tensor):
            tensors.append(x._value)
            meta.append(bool(x.stop_gradient))
            return ("T", len(tensors) - 1)
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            meta.append(not x.requires_grad)
            return ("A", len(tensors) - 1)
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, [go(v) for v in x])
        if isinstance(x, dict):
            return ("dict", [(k, go(v)) for k, v in
                             sorted(x.items(), key=lambda kv: str(kv[0]))])
        return ("S", x)

    return tensors, meta, go(tree)


def _rebuild_args(spec, tensors):
    kind, payload = spec
    if kind == "T":
        return Tensor._wrap(tensors[payload])
    if kind == "A":
        return tensors[payload]
    if kind == "S":
        return payload
    if kind == "list":
        return [_rebuild_args(s, tensors) for s in payload]
    if kind == "tuple":
        return tuple(_rebuild_args(s, tensors) for s in payload)
    if kind == "dict":
        return {k: _rebuild_args(s, tensors) for k, s in payload}
    raise AssertionError(kind)


def _spec_key(spec, tensors, meta):
    kind, payload = spec
    if kind in ("T", "A"):
        t = tensors[payload]
        return (kind, tuple(t.shape), str(t.dtype), str(t.device),
                meta[payload])
    if kind == "S":
        try:
            hash(payload)
            return ("S", payload)
        except TypeError:
            return ("S", repr(payload))
    if kind in ("list", "tuple"):
        return (kind, tuple(_spec_key(s, tensors, meta) for s in payload))
    return ("dict", tuple((k, _spec_key(s, tensors, meta))
                          for k, s in payload))


def _flatten_out(out):
    tensors: List[torch.Tensor] = []

    def go(x):
        if isinstance(x, Tensor):
            tensors.append(x._value)
            return ("T", len(tensors) - 1, bool(x.stop_gradient))
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return ("A", len(tensors) - 1, not x.requires_grad)
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, [go(v) for v in x], None)
        if isinstance(x, dict):
            return ("dict", [(k, go(v)) for k, v in x.items()], None)
        return ("S", x, None)

    return tensors, go(out)


def _detached(out):
    """``out`` with every tensor detached: an eager call's outputs keep no
    autograd graph alive into a later capture."""
    tensors, spec = _flatten_out(out)
    return _rebuild_out(spec, [t.detach() for t in tensors])


def _rebuild_out(spec, tensors):
    """The outputs over ``tensors`` (new leaves: a step's outputs carry
    no autograd graph, as the JAX package's compiled outputs carry no
    tape)."""
    kind, payload, stop = spec
    if kind in ("T", "A"):
        t = tensors[payload]
        if not stop and t.is_floating_point():
            t.requires_grad_(True)
        return Tensor._wrap(t) if kind == "T" else t
    if kind == "S":
        return payload
    if kind == "list":
        return [_rebuild_out(s, tensors) for s in payload]
    if kind == "tuple":
        return tuple(_rebuild_out(s, tensors) for s in payload)
    return {k: _rebuild_out(s, tensors) for k, s in payload}


# ----------------------------------------------------------- programs
class _Program:
    """One signature's step: its calls, seed tape and, once captured,
    the graph with its static inputs and outputs."""

    def __init__(self):
        self.calls = 0
        self.built = False  # captured (on the CPU: called a second time)
        self.tape = _generator.SeedTape()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: List[torch.Tensor] = []
        self.outputs: List[torch.Tensor] = []
        self.out_spec = None
        self.first_seeds: Optional[Dict] = None
        self.flash_calls: Dict[str, int] = {}
        self.paged_calls = 0
        self.embedding_calls = 0
        self.capture_s: Optional[float] = None
        self.cost: Optional[dict] = None
        self._staging: Dict[torch.device, tuple] = {}

    def stage_seeds(self, values: Dict[torch.device, List[int]]) -> None:
        """Copy each device's seed values into its buffer's first slots
        through a pinned staging buffer; the copy is queued on the stream
        ahead of the replay. The staging buffer is rewritten only after
        its last copy finished (an event, at most one step behind)."""
        for dev, vals in values.items():
            if not vals:
                continue
            buf = self.tape.buffer(dev)
            stage = self._staging.get(dev)
            if stage is None:
                stage = (torch.empty(len(buf), dtype=torch.int32,
                                     pin_memory=True), torch.cuda.Event())
                self._staging[dev] = stage
            host, done = stage
            done.synchronize()
            n = len(vals)
            host[:n] = torch.tensor(vals, dtype=torch.int32)
            buf[:n].copy_(host[:n], non_blocking=True)
            done.record()


def _layer_cells(modules) -> List[torch.Tensor]:
    """The torch tensors of every parameter and buffer of the Paddle
    Layers among ``modules``: cells a step reads and writes in place (an
    optimizer's update, BatchNorm's running statistics), so a replay
    sees the last one's writes."""
    cells: Dict[int, torch.Tensor] = {}
    for m in modules:
        if isinstance(m, Layer):
            for t in (list(m._parameters.values())
                      + list(m._buffers.values())):
                if t is not None:
                    cells[id(t._value)] = t._value
    return list(cells.values())


def _device_of(tensors, opts, modules) -> torch.device:
    for t in tensors:
        if t.device.type == "cuda":
            return t.device
    for opt in opts:
        for p in opt._parameter_list:
            return _value(p).device
    for t in _layer_cells(modules):
        return t.device
    for m in modules:
        if isinstance(m, torch.nn.Module):
            for p in m.parameters():
                return p.device
    return tensors[0].device if tensors else torch.device("cpu")


class _FlopCount:
    """The flops of the products run inside it, by
    ``torch.utils.flop_counter``'s formulas. Unlike ``FlopCounterMode``,
    which runs an operation it has no formula for through its
    decomposition (other kernels, other roundings), every operation runs
    as it would outside: a counted call computes what an uncounted one
    does."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        count = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    count.total += int(formula(*args, **kwargs,
                                               out_val=out))
                return out

        self.total = 0
        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


# ------------------------------------------------------ StaticFunction
class StaticFunction:
    """The imperative ``function`` captured per input signature (module
    docstring). ``observe`` lists objects (models, optimizers) whose
    state the step uses beyond what the function's closure reaches.
    ``input_spec``, ``build_strategy``, ``property``, ``full_graph``,
    ``warmup``, ``dy2static``, ``cache_dir`` and ``cache_key_extra`` are
    taken for the JAX package's API: every signature's first call runs
    eagerly whatever ``warmup`` says, and there is no AST pass and no
    persistent cache."""

    def __init__(self, function: Callable, input_spec=None,
                 build_strategy=None, property=False, full_graph=True,
                 observe: Sequence[Any] = (), warmup: bool = True,
                 dy2static: bool = True, cache_dir: Optional[str] = None,
                 cache_key_extra: Optional[str] = None):
        self._fn = function
        self._input_spec = input_spec
        self._observe = list(observe)
        self._do_warmup = warmup
        self._scanned = False
        self._opts: List[Optimizer] = []
        self._modules: List[Any] = []
        self._cache: Dict[tuple, _Program] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        # why every call runs eagerly (module docstring), or None
        self.eager_reason: Optional[str] = None
        self.__name__ = getattr(function, "__name__", "static_fn")
        self.__doc__ = getattr(function, "__doc__", None)

    # -- introspection -------------------------------------------------
    def cost_analysis(self, key=None) -> Optional[dict]:
        """The cost of a signature's first call (module docstring): of
        ``key`` (a key of :meth:`capture_seconds`), else of the signature
        called last; None before any call."""
        if key is not None:
            prog = self._cache.get(key)
            return None if prog is None or prog.cost is None \
                else dict(prog.cost)
        for prog in reversed(list(self._cache.values())):
            if prog.cost is not None:
                return dict(prog.cost)
        return None

    def compile_counts(self) -> Dict[str, int]:
        """``signatures`` seen (``len(_cache)``), ``captured`` programs
        (on the CPU, the signatures called twice or more: their programs
        would be captured) and ``calls``."""
        return {"signatures": len(self._cache),
                "captured": sum(p.built for p in self._cache.values()),
                "calls": sum(p.calls for p in self._cache.values())}

    def capture_seconds(self) -> Dict[tuple, float]:
        """Wall seconds of each captured signature's capture (state,
        static inputs and the capture itself)."""
        return {k: p.capture_s for k, p in self._cache.items()
                if p.capture_s is not None}

    @property
    def dygraph_function(self):
        return self._fn

    def concrete_program_specified_input_spec(self, *a, **k):
        return None

    def rollback(self):
        return self._fn

    # -- call ----------------------------------------------------------
    def _scan(self, args, kwargs) -> None:
        self._opts, self._modules, capture = _scan_state(
            _closure_objects(self._fn) + self._observe + list(args)
            + list(kwargs.values()))
        for mode, why in capture:
            if mode == "refuse":
                raise RuntimeError(
                    f"to_static of the step {self.__name__!r} refused: "
                    f"{why}")
        eager = [why for mode, why in capture if mode == "eager"]
        self.eager_reason = "; ".join(eager) if eager else None
        self._scanned = True

    def _first_call(self, prog: _Program, device: torch.device, args,
                    kwargs):
        """A signature's first call, counted (``cost_analysis``)."""
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        counter = _FlopCount()
        _fa.flop_log = []
        try:
            with counter:
                if cuda and self.eager_reason is None:
                    out = self._warm_up(prog, device, args, kwargs)
                else:
                    with prog.tape.open("fill"):
                        out = _detached(self._fn(*args, **kwargs))
            kernels = sum(f for _, f in _fa.flop_log)
        finally:
            _fa.flop_log = None
        counted = counter.total
        prog.cost = {"flops": counted + kernels, "flops_counted": counted,
                     "flops_kernels": kernels,
                     "peak_bytes": (torch.cuda.max_memory_allocated(device)
                                    if cuda else None)}
        return out

    def __call__(self, *args, **kwargs):
        if _generator._tape is not None:
            # called from inside another step program: part of its step
            return self._fn(*args, **kwargs)
        if not self._scanned:
            self._scan(args, kwargs)
        tensors, meta, spec = _flatten_args((args, kwargs))
        key = (_spec_key(spec, tensors, meta),
               tuple(m.training for m in self._modules))
        prog = self._cache.get(key)
        if prog is None:
            prog = self._cache[key] = _Program()
        prog.calls += 1
        device = _device_of(tensors, self._opts, self._modules)
        if prog.calls == 1:
            return self._first_call(prog, device, args, kwargs)
        if device.type != "cuda" or self.eager_reason is not None:
            if device.type != "cuda" and not prog.built:
                self._materialize()
                self._count_compile()
                prog.built = True
            with prog.tape.open("fill"):
                out = self._fn(*args, **kwargs)
            return _detached(out)
        first = prog.graph is None
        if first:
            self._capture(prog, tensors, spec, meta, device)
        else:
            for buf, t in zip(prog.inputs, tensors):
                if buf is not t:
                    buf.copy_(t)
        for opt in self._opts:
            opt._write_lr()
        prog.stage_seeds(prog.first_seeds if first else prog.tape.run())
        prog.graph.replay()
        _fa.count_replays(prog.flash_calls)
        _pa.count_replays(prog.paged_calls)
        _eg.count_replays(prog.embedding_calls)
        return _rebuild_out(prog.out_spec,
                            [t.detach().clone() for t in prog.outputs])

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _warm_up(self, prog: _Program, device: torch.device, args, kwargs):
        """A signature's first call, eagerly, on the stream its capture
        will use: the autograd graph of an eager call binds each
        parameter's grad accumulator to the stream it ran on, and one
        still alive at the capture must be on the capture's stream (one
        on the default stream would pull it into the graph)."""
        current = torch.cuda.current_stream(device)
        side = self._side_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side), prog.tape.open("fill"):
            out = self._fn(*args, **kwargs)
        current.wait_stream(side)
        out = _detached(out)
        for t in _flatten_out(out)[0]:
            t.record_stream(current)
        return out

    def _materialize(self) -> None:
        for opt in self._opts:
            opt._materialize_accumulators()
            opt._write_lr()

    def _count_compile(self) -> None:
        get_registry().counter(
            "paddle_tpu_jit_compiles_total",
            "Step programs materialized into a StaticFunction signature "
            "cache, by source (the port captures a CUDA graph per "
            "signature: always \"fresh\")", labels=("fn", "source"),
        ).labels(fn=self.__name__, source="fresh").inc()

    def _capture(self, prog: _Program, tensors, spec, meta,
                 device: torch.device) -> None:
        t0 = time.perf_counter()
        for cell in _layer_cells(self._modules):
            if cell.device != device:
                raise RuntimeError(
                    f"capture of {self.__name__!r} on {device}: a Layer's "
                    f"parameter or buffer lies on {cell.device}")
        self._materialize()
        prog.inputs = []
        for t, stop in zip(tensors, meta):
            buf = t.detach().clone()
            if not stop and buf.is_floating_point():
                buf.requires_grad_(True)
            prog.inputs.append(buf)
        args, kwargs = _rebuild_args(spec, prog.inputs)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = self._side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        flash_before = dict(_fa.captured_launches)
        paged_before = _pa.captured_launches
        embedding_before = _eg.captured_launches
        graph = torch.cuda.CUDAGraph()
        # no cyclic collection inside the capture: a graph dropped in a
        # reference cycle and destroyed mid-capture invalidates it
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device), \
                    torch.cuda.graph(graph, pool=self._pool,
                                     stream=side), \
                    prog.tape.open("record"):
                out = self._fn(*args, **kwargs)
        except RuntimeError as e:
            raise RuntimeError(
                f"CUDA-graph capture of the step {self.__name__!r} failed. "
                "A captured function must not read a device value on the "
                "host (.item(), bool(tensor), .numpy(), float(tensor)) nor "
                "run an operation a graph cannot hold; Python control flow "
                "on tensor values needs the dy2static pass, which is not "
                "ported yet") from e
        finally:
            if gc_was_on:
                gc.enable()
        prog.graph = graph
        prog.outputs, prog.out_spec = _flatten_out(out)
        prog.first_seeds = prog.tape.recorded_values()
        prog.flash_calls = {k: _fa.captured_launches[k] - flash_before[k]
                            for k in _fa.KERNELS}
        prog.paged_calls = _pa.captured_launches - paged_before
        prog.embedding_calls = _eg.captured_launches - embedding_before
        prog.capture_s = time.perf_counter() - t0
        prog.built = True
        self._count_compile()
