"""PyLayer: user-defined autograd ops (``paddle_tpu/autograd/py_layer.py``),
on ``torch.autograd.Function``.

A subclass defines static ``forward(ctx, *args)`` and ``backward(ctx,
*grads)`` over Tensors. ``apply`` binds keyword arguments to positions
(``torch.autograd.Function.apply`` takes none), runs ``forward`` inside
one torch Function made for the subclass, and routes the backward's
gradients to the Tensor arguments in order; other arguments get none.
Tensors given to ``ctx.save_for_backward`` are saved through torch's
``save_for_backward``, so an output saved there makes no reference cycle.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict

import torch

from ..tensor import Tensor, unwrap

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    """What ``forward`` leaves for ``backward``
    (``paddle_tpu/autograd/py_layer.py:34``)."""

    def __init__(self):
        self._saved = ()
        self.materialize_grads = True
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved


_functions: Dict[type, type] = {}


def _torch_function(layer: type) -> type:
    fn = _functions.get(layer)
    if fn is not None:
        return fn

    def forward(tctx, *args):
        ctx = PyLayerContext()
        tctx.pctx = ctx
        tctx.tensor_at = [i for i, a in enumerate(args)
                          if isinstance(a, torch.Tensor)]
        wrapped = [Tensor._wrap(a) if isinstance(a, torch.Tensor) else a
                   for a in args]
        outs = layer.forward(ctx, *wrapped)
        tctx.is_tuple = isinstance(outs, (tuple, list))
        saved = list(ctx._saved)
        tctx.saved_at = [i for i, s in enumerate(saved)
                         if isinstance(s, (Tensor, torch.Tensor))]
        tctx.save_for_backward(*[unwrap(saved[i]) for i in tctx.saved_at])
        ctx._saved = saved
        if tctx.is_tuple:
            return tuple(unwrap(o) for o in outs)
        return unwrap(outs)

    def backward(tctx, *grads):
        ctx = tctx.pctx
        saved = list(ctx._saved)
        for i, t in zip(tctx.saved_at, tctx.saved_tensors):
            saved[i] = Tensor._wrap(t)
        ctx._saved = tuple(saved)
        gins = layer.backward(ctx, *[None if g is None else Tensor._wrap(g)
                                     for g in grads])
        if not isinstance(gins, (tuple, list)):
            gins = (gins,)
        result = [None] * (len(tctx.needs_input_grad))
        for i, g in zip(tctx.tensor_at, gins):
            result[i] = None if g is None else unwrap(g)
        return tuple(result)

    fn = type(f"{layer.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    _functions[layer] = fn
    return fn


class PyLayer:
    """Subclass and define ``forward(ctx, *args)`` and ``backward(ctx,
    *grads)`` over Tensors (``paddle_tpu/autograd/py_layer.py:49``)."""

    @staticmethod
    def forward(ctx: PyLayerContext, *args: Any, **kwargs: Any):
        raise NotImplementedError

    @staticmethod
    def backward(ctx: PyLayerContext, *grads: Any):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        if kwargs:
            bound = inspect.signature(cls.forward).bind(None, *args, **kwargs)
            bound.apply_defaults()
            args = bound.args[1:]
        outs = _torch_function(cls).apply(*[unwrap(a) for a in args])
        if isinstance(outs, tuple):
            return tuple(Tensor._wrap(o) if isinstance(o, torch.Tensor) else o
                         for o in outs)
        return Tensor._wrap(outs) if isinstance(outs, torch.Tensor) else outs
