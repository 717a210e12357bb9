"""``jit.save``, ``jit.load`` and ``TranslatedLayer``
(``paddle_tpu/jit/__init__.py:116-221``) on ``torch.export``.

The artifact has the JAX package's two files:

- ``<path>.pdmodel``: a pickle of ``{"exported": bytes, "out_spec",
  "param_names", "param_dtypes", "input_names"}``, where ``exported`` is
  the serialized ``torch.export.ExportedProgram`` (``torch.export.save``)
  in place of StableHLO. The program is ``pure(params, *xs)``: the
  parameters (the ``state_dict``'s names) are inputs, as in the JAX
  package, so the program holds no weights.
- ``<path>.pdiparams``: the pickled ``state_dict`` as numpy arrays, the
  JAX package's names and bytes for f32; a bf16 entry in
  ``framework/io.py``'s encoding (its 16-bit patterns in a payload
  tagged ``"bfloat16"``). It is read with ``framework/io.py``'s
  restricted unpickler, so a JAX-written file loads too.

``save`` takes a facade ``nn.Layer`` (its Parameters' values swapped for
the program's inputs during the trace), a torch module (the port's
models; ``torch.nn.utils.stateless`` reparametrization), either with a
``StaticFunction`` forward, or a ``StaticFunction`` or plain function
with its ``input_spec``. The trace runs in eval mode under ``no_grad``
and under the caller's ``amp.auto_cast`` state (an O2 model is exported
inside its ``auto_cast``, as the JAX package's bf16 programs are). A
``None`` dim of an ``InputSpec`` is a dynamic dim of the program
(``torch.export.Dim.AUTO``; its example size is 2). Flash attention is
the operator ``paddle_tpu_torch::flash_fwd`` (K1), so the graph holds
one node per attention call and a loaded program launches K1 on CUDA
tensors. As in the JAX package (``paddle_tpu/jit/__init__.py:128-133``)
the trace runs the forward through the dy2static pass (off when
``PADDLE_TPU_DY2STATIC=0``): Python ``if``/``while``/``for range`` on
tensor values and ``static.nn``'s constructs become ``torch.cond`` and
``torch.while_loop`` nodes of the program (the exporting regime of
``static/nn/control_flow.py``), whose bodies hold K1's operator like the
rest of the graph. A converted plain function, like a facade ``Layer``,
gets facade Tensors (the converters dispatch on them). A torch module's
forward (the port's models) is torch code and is traced as it is; a
``to_static`` forward or function is already converted. Control flow the
pass cannot convert (a host read such as ``bool(t)`` or ``t.item()``,
control flow under ``try``) stops the trace: ``ValueError`` naming the
source line.

``load`` (the card unless ``device="cpu"``) reads both files with
``framework/io.py``'s restricted unpickler, deserializes the program,
moves its baked-in devices to ``device``
(``torch.export.passes.move_to_device_pass``) and returns a
``TranslatedLayer``: a facade ``Layer`` whose Parameters are the stored
weights cast to the program's dtypes (as ``:185-196``), called with
facade or torch tensors or numpy arrays.
"""
from __future__ import annotations

import io as _io
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from .. import dtypes
from ..device import resolve_device, using_device
from ..nn.layer_base import Layer
from ..ops import flash_attention as _fa  # noqa: F401  (registers K1's op)
from ..tensor import Parameter, Tensor
from .dy2static import flag_device
from .static_function import InputSpec, StaticFunction, _flatten_out, \
    _rebuild_out

__all__ = ["save", "load", "TranslatedLayer"]

_PROGRAM_SUFFIX = ".pdmodel"
_PARAMS_SUFFIX = ".pdiparams"
# the size a dynamic dim of an InputSpec takes in the trace
_EXAMPLE_DIM = 2


def _example(spec, device):
    """(example tensor, dynamic-shape dict) of one input spec."""
    if isinstance(spec, InputSpec):
        shape = tuple(_EXAMPLE_DIM if d is None else int(d)
                      for d in spec.shape)
        dyn = {j: torch.export.Dim.AUTO
               for j, d in enumerate(spec.shape) if d is None} or None
        return torch.zeros(shape, dtype=spec.dtype, device=device), dyn
    t = getattr(spec, "_value", spec)
    t = torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor)
                        else t)
    return t.to(device), None


def _state(layer):
    """(names, tensors) the program takes as parameters."""
    if isinstance(layer, Layer):
        state = layer.state_dict()
        return list(state), [state[n]._value for n in state]
    if isinstance(layer, torch.nn.Module):
        state = layer.state_dict(keep_vars=True)
        return list(state), [state[n] for n in state]
    return [], []


class _Pure(torch.nn.Module):
    """``pure(params, *xs)``: the function with its parameters as inputs;
    its outputs flattened (the structure kept in ``out_spec``)."""

    def __init__(self, layer, fn, names, record, wrap):
        super().__init__()
        self._wrap = wrap
        # held outside the module tree: the program lifts no weights
        object.__setattr__(self, "_layer", layer)
        object.__setattr__(self, "_fn", fn)
        self._names = names
        # a function (the trace may run on a copy of this module)
        object.__setattr__(self, "_record", record)

    def forward(self, params, *xs):
        layer = self._layer
        if isinstance(layer, Layer):
            state = layer.state_dict()
            old = [state[n]._value for n in self._names]
            for n in self._names:
                state[n]._value = params[n]
            try:
                out = self._fn(*[Tensor._wrap(x) for x in xs])
            finally:
                for n, v in zip(self._names, old):
                    state[n]._value = v
        else:
            if self._wrap:
                xs = [Tensor._wrap(x) for x in xs]
            if isinstance(layer, torch.nn.Module):
                from torch.nn.utils.stateless import _reparametrize_module

                with _reparametrize_module(layer, params, tie_weights=True):
                    out = self._fn(*xs)
            else:
                out = self._fn(*xs)
        tensors, spec = _flatten_out(out)
        self._record(spec)
        return tuple(tensors)


def _chain(err: BaseException) -> list:
    chain, e = [], err
    while e is not None and len(chain) < 8:
        chain.append(e)
        e = e.__cause__ or e.__context__
    return chain


def _data_dependent(err: BaseException) -> bool:
    """Whether the trace stopped on a value it cannot know (Python
    control flow or a host read of a traced tensor)."""
    return any(type(e).__name__ in ("GuardOnDataDependentSymNode",
                                    "DataDependentOutputException",
                                    "DataDependentOutputError")
               or "data-dependent" in str(e).lower()
               or "data dependent" in str(e).lower() for e in _chain(err))


def _construct(err: BaseException, fn) -> str:
    """``file:line: source`` of the user code where the trace stopped:
    the deepest frame outside torch and the port's op and control-flow
    machinery (a converted function's line mapped back to its source)."""
    import linecache
    import traceback

    skip = (os.path.dirname(torch.__file__),
            *(os.path.join(os.path.dirname(os.path.dirname(__file__)), d)
              for d in ("tensor.py", "autograd", "ops", "jit", "static",
                        "nn", "amp.py")))
    orig = getattr(fn, "__dy2static_original__", None)
    where = None
    for e in reversed(_chain(err)):
        for fr in traceback.extract_tb(e.__traceback__):
            name = fr.filename
            if name.startswith("<dy2static:") and orig is not None:
                first = orig.__code__.co_firstlineno
                name = orig.__code__.co_filename
                where = (name, first + fr.lineno - 1)
            elif not name.startswith(skip) and not name.startswith("<"):
                where = (name, fr.lineno)
    if where is None:
        return getattr(fn, "__qualname__", repr(fn))
    line = linecache.getline(*where).strip()
    return f"{where[0]}:{where[1]}: {line}"


def _host_params(names, values) -> dict:
    """The ``.pdiparams`` dict: numpy arrays; bf16 in ``framework/io.py``'s
    encoding."""
    from ..framework.io import _TensorPayload, _host

    out = {}
    for n, v in zip(names, values):
        arr, tag = _host(v)
        out[n] = arr if tag is None else _TensorPayload(arr, True, tag)
    return out


def save(layer, path: str, input_spec: Optional[Sequence] = None, **config):
    """Export ``layer`` (module docstring) to ``path + ".pdmodel"`` and
    ``path + ".pdiparams"``."""
    fn = layer
    if isinstance(layer, (Layer, torch.nn.Module)):
        fn = layer.forward
    if isinstance(fn, StaticFunction):
        if input_spec is None:
            input_spec = fn._input_spec
        fn = fn.dygraph_function
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (a list of "
                         "InputSpec or example tensors)")
    converted = False
    module = isinstance(layer, torch.nn.Module)
    if os.environ.get("PADDLE_TPU_DY2STATIC") != "0" and not module:
        from .dy2static import ast_transform

        new = ast_transform(fn)
        converted = getattr(new, "__dy2static_original__", None) is not None
        fn = new
    names, values = _state(layer)
    device = values[0].device if values else resolve_device(None)
    examples = [_example(s, device) for s in input_spec]
    holder = {}

    def record(spec):
        holder["out_spec"] = spec

    pure = _Pure(layer if isinstance(layer, (Layer, torch.nn.Module))
                 else None, fn, names, record,
                 wrap=not module and (isinstance(layer, Layer) or converted))
    was_training = bool(getattr(layer, "training", False))
    if was_training:
        layer.eval()
    params = {n: v.detach() for n, v in zip(names, values)}
    try:
        with torch.no_grad(), using_device(device), flag_device(device):
            ep = torch.export.export(
                pure, (params, *[x for x, _ in examples]),
                dynamic_shapes=({n: None for n in names},
                                tuple(d for _, d in examples)),
                strict=False)
    except Exception as err:
        if _data_dependent(err):
            raise ValueError(
                "jit.save cannot export this forward: its Python control "
                "flow at " + _construct(err, fn) + " depends on tensor "
                "values and the dy2static pass did not convert it (a host "
                "read such as bool(t) or t.item(), or control flow it "
                f"leaves as it is): {err}") from err
        raise
    finally:
        if was_training:
            layer.train()
    ep.example_inputs = None  # they hold the weights: stored once, below
    buf = _io.BytesIO()
    torch.export.save(ep, buf)
    input_names = [getattr(s, "name", None) or f"x{i}"
                   for i, s in enumerate(input_spec)]
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path + _PROGRAM_SUFFIX, "wb") as f:
        pickle.dump({"exported": buf.getvalue(), "out_spec": holder["out_spec"],
                     "param_names": names,
                     "param_dtypes": [dtypes.dtype_name(v.dtype)
                                      for v in values],
                     "input_names": input_names}, f)
    with open(path + _PARAMS_SUFFIX, "wb") as f:
        pickle.dump(_host_params(names, values), f)


def load_params(path: str) -> dict:
    """A ``.pdiparams`` file as ``{name: torch.Tensor}`` on the CPU."""
    from ..framework.io import _from_saved, _Unpickler

    with open(path, "rb") as f:
        raw = _from_saved(_Unpickler(f).load(), "cpu")
    return {n: (v._value if isinstance(v, Tensor)
                else torch.from_numpy(np.ascontiguousarray(v)))
            for n, v in raw.items()}


class TranslatedLayer(Layer):
    """A loaded program as a Layer (module docstring)."""

    def __init__(self, exported, prog: dict, params: dict, device):
        super().__init__()
        self._exported = exported
        self._program = exported.module()
        self._out_spec = prog["out_spec"]
        self._param_names = list(prog["param_names"])
        self._input_names = list(prog["input_names"])
        self._device = device
        for name, dt in zip(self._param_names, prog["param_dtypes"]):
            value = params[name].to(device=device,
                                    dtype=dtypes.convert_dtype(dt))
            self.add_parameter(name.replace(".", "__"), Parameter(value))

    def forward(self, *inputs):
        params = {n: self._parameters[n.replace(".", "__")]._value
                  for n in self._param_names}
        xs = [x._value if isinstance(x, Tensor)
              else torch.as_tensor(x) for x in inputs]
        with torch.no_grad():
            out = self._program(params, *[x.to(self._device) for x in xs])
        return _rebuild_out(self._out_spec, list(out))


def load(path: str, device=None) -> TranslatedLayer:
    """``paddle.jit.load``: the program at ``path`` on ``device`` (the
    card by default; ``RuntimeError`` without one unless ``"cpu"``)."""
    from torch.export.passes import move_to_device_pass

    from ..framework.io import _Unpickler

    device = resolve_device(device)
    with open(path + _PROGRAM_SUFFIX, "rb") as f:
        prog = _Unpickler(f).load()  # plain containers, bytes and strings
    ep = torch.export.load(_io.BytesIO(prog["exported"]))
    ep = move_to_device_pass(ep, str(device))
    return TranslatedLayer(ep, prog, load_params(path + _PARAMS_SUFFIX),
                           device)
