"""The eager tape: torch autograd behind Paddle's API
(``paddle_tpu/autograd/engine.py``).

The JAX package records its own ``GradNode`` graph; here every op runs
plain torch, so torch autograd records the graph and walks it. What stays
of the engine is the glue:

- :func:`apply_op`, the one way an op of :mod:`..ops` runs: it unwraps
  the inputs, casts them by the amp rule under the JAX package's op name
  (:func:`..amp.cast_inputs`, as ``_amp_cast`` does there), calls the
  torch function and wraps the outputs. An op the JAX package marks not
  differentiable gives outputs with ``stop_gradient=True``.
- :func:`inplace_rebind`, the in-place write of an op ending in ``_``
  and of ``__setitem__``. With grad on, the result is computed out of
  place and rebound into the cell, so a graph that saved the old value
  keeps it (the JAX tape's immutable arrays do the same; an in-place
  torch write would trip the version counter instead). Under ``no_grad``
  a trainable leaf that is no view (:func:`writes_in_place`) is written
  in place, so a module, an optimizer or a captured CUDA graph holding
  its storage sees the write, and it stays trainable; every other value
  is rebound, since it may share storage with another cell (a reshape or
  a slice is a torch view). No other cell holds a trainable leaf's
  storage as its own value: the constructors copy, and an op that hands
  back an input unchanged hands back a view of it. A view taken of a
  trainable leaf does see a later in-place write to it, as a torch view
  does; a JAX array would not.
- :func:`backward` and :func:`grad`, ``torch.autograd.backward`` and
  ``torch.autograd.grad`` with the JAX package's errors: a non-scalar
  output needs its gradient given, an output with no graph cannot be
  differentiated, and an input the outputs do not reach raises unless
  ``allow_unused``.
- Grad mode is torch's (thread-local, as the JAX package's).
- ``FLAGS_check_nan_inf`` (``framework/flags.py``) makes
  :func:`apply_op` sweep each op's floating outputs and raise
  ``FloatingPointError`` on a NaN or Inf, with the JAX package's message;
  the sweep reads the outputs on the host, so it skips while a CUDA graph
  is being captured (the JAX sweep skips tracers).
  ``FLAGS_benchmark`` synchronizes the card after each op.

A graph freed by a backward raises on a second one only where torch
saved a tensor for it (``x * x`` does, ``x + 1`` does not); the JAX tape
raises in both.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .. import amp
from ..tensor import Tensor, unwrap

__all__ = ["apply_op", "inplace_rebind", "writes_in_place", "backward",
           "grad",
           "is_grad_enabled", "set_grad_enabled", "no_grad", "enable_grad"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


# FLAGS_check_nan_inf / FLAGS_benchmark (framework/flags.py)
check_nan_inf_enabled = False
benchmark_sync_enabled = False


def _nan_inf_sweep(outs, name: str) -> None:
    seq = outs if isinstance(outs, (tuple, list)) else (outs,)
    for i, o in enumerate(seq):
        if (isinstance(o, torch.Tensor) and o.is_floating_point()
                and not (o.is_cuda
                         and torch.cuda.is_current_stream_capturing())
                and not bool(torch.isfinite(o).all())):
            raise FloatingPointError(
                f"NaN/Inf detected in output {i} of op {name!r} "
                f"(FLAGS_check_nan_inf sweep)")


def _benchmark_sync(outs) -> None:
    seq = outs if isinstance(outs, (tuple, list)) else (outs,)
    for o in seq:
        if (isinstance(o, torch.Tensor) and o.is_cuda
                and not torch.cuda.is_current_stream_capturing()):
            torch.cuda.synchronize(o.device)
            return


def set_grad_enabled(mode: bool):
    """Switch grad mode on or off from here on (also usable as a context
    manager, which restores it)."""
    return torch.set_grad_enabled(bool(mode))


def _wrap_out(out, differentiable: bool, vals):
    if isinstance(out, torch.Tensor):
        if not differentiable and out.requires_grad:
            out = out.detach()
        elif any(out is v for v in vals):  # e.g. a cast to its own dtype
            out = out.view_as(out)
        return Tensor._wrap(out)
    return out


def apply_op(fn: Callable, tensors: Sequence[Tensor], attrs: dict = None,
             differentiable: bool = True, name: str = ""):
    """Run one op: ``fn(*values, **attrs)`` on the tensors' torch values
    (amp-cast under ``name``); a tuple or list of outputs comes back as a
    tuple of Tensors."""
    vals = [t._value for t in tensors]
    if amp._state.get() is not None:
        vals = amp.cast_inputs(name, *vals)
    outs = fn(*vals, **attrs) if attrs else fn(*vals)
    if check_nan_inf_enabled:
        _nan_inf_sweep(outs, name)
    if benchmark_sync_enabled:
        _benchmark_sync(outs)
    if isinstance(outs, (tuple, list)):
        return tuple(_wrap_out(o, differentiable, vals) for o in outs)
    return _wrap_out(outs, differentiable, vals)


def writes_in_place(v: torch.Tensor) -> bool:
    """Whether an in-place op writes into ``v`` itself: under
    ``no_grad``, and only a trainable leaf that is no view (module
    docstring)."""
    return (not torch.is_grad_enabled() and v.requires_grad and v.is_leaf
            and v._base is None)


def inplace_rebind(x: Tensor, out: Tensor) -> Tensor:
    """Give ``x`` the value of ``out`` (module docstring): in place when
    :func:`writes_in_place` and shape and dtype allow, else by
    rebinding. A trainable leaf given a value with no graph to it (a
    fill, an ``assign`` of a constant) stays a trainable leaf, as the JAX
    package's cell keeps its ``stop_gradient`` when no node was
    recorded: written in place when it can be, else a new leaf."""
    old, new = x._value, out._value
    same = old.shape == new.shape and old.dtype == new.dtype
    if writes_in_place(old) and same:
        if new.data_ptr() != old.data_ptr():
            old.copy_(new)
        return x
    if (old.requires_grad and old.is_leaf and not new.requires_grad
            and new.is_floating_point()):
        if same and old._base is None:
            with torch.no_grad():
                old.copy_(new)
        else:
            x._value = new.detach().requires_grad_(True)
        return x
    x._value = new
    return x


def _check_outputs(outputs, grads):
    for i, t in enumerate(outputs):
        if not t._value.requires_grad:
            raise RuntimeError(
                f"Tensor {t.name} has stop_gradient=True and no grad node; "
                "backward() on it is meaningless")
        if (grads is None or grads[i] is None) and t._value.numel() != 1:
            raise RuntimeError(
                "grad can be implicitly created only for tensors with a "
                f"single element; got shape {t.shape}. Pass grad_tensor "
                "explicitly.")


def _grad_values(outputs, grads):
    if grads is None:
        return None
    return [None if g is None else
            torch.as_tensor(unwrap(g), device=o._value.device)
            for o, g in zip(outputs, grads)]


def backward(tensors: Sequence[Tensor], grad_tensors=None,
             retain_graph: bool = False) -> None:
    """Accumulate the gradients of ``tensors`` into every leaf's
    ``.grad``."""
    tensors = [tensors] if isinstance(tensors, Tensor) else list(tensors)
    if isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors]
    _check_outputs(tensors, grad_tensors)
    torch.autograd.backward([t._value for t in tensors],
                            _grad_values(tensors, grad_tensors),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph: bool = False, only_inputs: bool = True,
         allow_unused: bool = False):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, without touching any ``.grad``. With ``create_graph`` the
    gradients carry their own graph and can be differentiated again. An
    input the outputs do not reach (or one with ``stop_gradient=True``)
    raises ``RuntimeError`` unless ``allow_unused``, which gives None."""
    del only_inputs
    outputs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    inputs = [inputs] if isinstance(inputs, Tensor) else list(inputs)
    if isinstance(grad_outputs, Tensor):
        grad_outputs = [grad_outputs]
    _check_outputs(outputs, grad_outputs)
    wanted = [i for i, t in enumerate(inputs) if t._value.requires_grad]
    got = torch.autograd.grad(
        [t._value for t in outputs], [inputs[i]._value for i in wanted],
        _grad_values(outputs, grad_outputs), retain_graph=retain_graph,
        create_graph=create_graph, allow_unused=True) if wanted else ()
    results = [None] * len(inputs)
    for i, g in zip(wanted, got):
        results[i] = None if g is None else Tensor._wrap(g)
    for t, g in zip(inputs, results):
        if g is None and not allow_unused:
            raise RuntimeError(
                f"One of the differentiated tensors ({t.name}) appears unused "
                "in the graph; pass allow_unused=True to get None for it.")
    return results
