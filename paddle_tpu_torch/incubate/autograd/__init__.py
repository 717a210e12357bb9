"""``paddle.incubate.autograd`` of the port
(``paddle_tpu/incubate/autograd``): the functional transforms
(``vjp``, ``jvp``, ``Jacobian``, ``Hessian``) and the primitive API's
``forward_grad`` and ``grad``.

The tape is torch autograd's. A transform calls the user's function on
fresh leaves that take a gradient (facade Tensors over them) and
differentiates what it returns: ``vjp`` and ``Jacobian`` by reverse
mode; ``jvp``, ``forward_grad`` and ``Hessian`` by the double-vjp form
(the gradient of a vjp with respect to its cotangent), since the port's
tape records no forward function to replay (the JAX package replays
its own tape under ``jax.jvp``). ``is_batched`` maps the function over
the first axis, one sample at a time, as ``jax.vmap`` does there.

Flash attention's backward (K2, K3) has no derivative of its own, as
JAX's ``custom_vjp`` has no forward rule: a ``jvp``, ``forward_grad`` or
``Hessian`` through attention raises a RuntimeError that says so
(``ops/flash_attention.py`` ``FlashAttentionFunction``).
``enable_prim``/``disable_prim`` are the JAX package's no-op switches.
"""
from __future__ import annotations

from typing import Callable

import torch

from ...ops._apply import ensure_tensor
from ...tensor import Tensor

__all__ = ["vjp", "jvp", "Jacobian", "Hessian", "forward_grad", "grad",
           "enable_prim", "disable_prim", "prim_enabled"]

_prim_state = {"enabled": False}


def enable_prim():
    """The JAX package's switch, kept for the API: the primitive
    decomposition is torch autograd's own."""
    _prim_state["enabled"] = True


def disable_prim():
    _prim_state["enabled"] = False


def prim_enabled() -> bool:
    return _prim_state["enabled"]


def _values(xs):
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    return [ensure_tensor(x)._value for x in xs]


def _pure(func: Callable):
    """``func`` over torch tensors: facade Tensors in, torch values out
    (a tuple for several outputs)."""
    def pure(*vals):
        out = func(*[Tensor._wrap(v) for v in vals])
        if isinstance(out, (list, tuple)):
            return tuple(getattr(o, "_value", o) for o in out)
        return getattr(out, "_value", out)

    return pure


def _leaves(vals):
    return [v.detach().requires_grad_(True) for v in vals]


def _grads(outs, ins, cts, create_graph=False):
    """``torch.autograd.grad`` with zeros for inputs no output reaches;
    the graph is kept for the next row."""
    got = torch.autograd.grad(outs, ins, cts, retain_graph=True,
                              create_graph=create_graph, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, ins)]


def _wrap_outs(outs):
    if isinstance(outs, tuple):
        return tuple(Tensor._wrap(o.detach()) for o in outs)
    return Tensor._wrap(outs.detach())


def vjp(func: Callable, xs, v=None):
    """reference: functional.py:22 -- ``(func(xs), v^T J)``; ``v``
    defaults to ones."""
    with torch.enable_grad():
        ins = _leaves(_values(xs))
        outs = _pure(func)(*ins)
        outs_l = list(outs) if isinstance(outs, tuple) else [outs]
        cts = ([torch.ones_like(o) for o in outs_l] if v is None
               else _values(v))
        grads = _grads(outs_l, ins, cts)
    grads_t = [Tensor._wrap(g) for g in grads]
    return _wrap_outs(outs), (grads_t if len(grads_t) > 1 else grads_t[0])


def _double_vjp(outs, ins, tangents):
    """J t for outputs ``outs`` of leaves ``ins``: the gradient of
    ``u -> u^T J`` with respect to ``u``, at cotangent ``t``."""
    us = [torch.zeros_like(o, requires_grad=True) for o in outs]
    g = torch.autograd.grad(outs, ins, us, retain_graph=True,
                            create_graph=True, allow_unused=True)
    pairs = [(gi, ti) for gi, ti in zip(g, tangents) if gi is not None]
    if not pairs:
        return [torch.zeros_like(o) for o in outs]
    return _grads([p for p, _ in pairs], us, [t for _, t in pairs])


def jvp(func: Callable, xs, v=None):
    """reference: functional.py:80 -- ``(func(xs), J v)``; ``v`` defaults
    to ones."""
    with torch.enable_grad():
        ins = _leaves(_values(xs))
        outs = _pure(func)(*ins)
        outs_l = list(outs) if isinstance(outs, tuple) else [outs]
        tangents = ([torch.ones_like(x) for x in ins] if v is None
                    else _values(v))
        jv = _double_vjp(outs_l, ins, tangents)
    jv_t = [Tensor._wrap(j.detach()) for j in jv]
    return _wrap_outs(outs), (tuple(jv_t) if isinstance(outs, tuple)
                              else jv_t[0])


def _jacobian(pure, x):
    """``d pure(x) / d x`` as ``[out size, in size]``."""
    with torch.enable_grad():
        (xx,) = _leaves([x])
        out = pure(xx).reshape(-1)
        rows = [_grads([out[i]], [xx], None)[0].reshape(-1)
                for i in range(out.numel())]
    return (torch.stack(rows) if rows
            else x.new_zeros((0, x.numel())))


class Jacobian:
    """reference: functional.py:171 -- a lazy Jacobian, ``J[:]`` the whole
    ``[out, in]`` matrix (``[B, out, in]`` with ``is_batched``, the
    function applied to one sample at a time)."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        self._vals = _values(xs)
        self._pure = _pure(func)
        self._is_batched = is_batched
        self._mat = None

    @property
    def shape(self):
        return tuple(self._materialize().shape)

    def _materialize(self):
        if self._mat is None:
            if len(self._vals) != 1:
                raise ValueError("Jacobian expects a single xs tensor; "
                                 "concatenate inputs first (reference "
                                 "behavior)")
            x = self._vals[0]
            if self._is_batched:
                self._mat = torch.stack([_jacobian(self._pure, xb)
                                         for xb in x])
            else:
                self._mat = _jacobian(self._pure, x)
        return self._mat

    def __getitem__(self, idx):
        return Tensor._wrap(self._materialize()[idx])

    def numpy(self):
        return self._materialize().detach().cpu().numpy()


def _hessian(scalar, x):
    """The Hessian of ``scalar`` at ``x`` as ``[n, n]``."""
    with torch.enable_grad():
        (xx,) = _leaves([x])
        (g,) = torch.autograd.grad(scalar(xx), xx, create_graph=True)
        g = g.reshape(-1)
        if not g.requires_grad:  # a function linear in x
            return x.new_zeros((g.numel(), g.numel()))
        rows = [_grads([g[i]], [xx], None)[0].reshape(-1)
                for i in range(g.numel())]
    return torch.stack(rows)


class Hessian:
    """reference: functional.py:260 -- the Hessian of a scalar function,
    ``[n, n]`` (``[B, n, n]`` with ``is_batched``, one sample at a
    time)."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        self._vals = _values(xs)
        self._pure = _pure(func)
        self._is_batched = is_batched
        self._mat = None

    def _materialize(self):
        if self._mat is None:
            x = self._vals[0]
            if self._is_batched:
                self._mat = torch.stack([
                    _hessian(lambda xx: self._pure(xx[None]).reshape(()), xb)
                    for xb in x])
            else:
                self._mat = _hessian(
                    lambda xx: self._pure(xx).reshape(()), x)
        return self._mat

    @property
    def shape(self):
        return tuple(self._materialize().shape)

    def __getitem__(self, idx):
        return Tensor._wrap(self._materialize()[idx])

    def numpy(self):
        return self._materialize().detach().cpu().numpy()


def forward_grad(outputs, inputs, grad_inputs=None):
    """reference: primapi.py:25 -- ``J t`` of tape outputs with respect to
    tape inputs (``t`` defaults to ones), by the double-vjp form over
    the recorded graph, which it leaves in place."""
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    outs = [t._value for t in outputs]
    ins = [t._value for t in inputs]
    tangents = ([torch.ones_like(x) for x in ins] if grad_inputs is None
                else _values(grad_inputs))
    with torch.enable_grad():
        jv = _double_vjp(outs, ins, tangents)
    res = [Tensor._wrap(j.detach()) for j in jv]
    return res if len(res) > 1 else res[0]


def grad(outputs, inputs, grad_outputs=None):
    """reference: primapi.py:108 -- reverse mode, the graph kept."""
    from ...autograd import engine

    outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    res = engine.grad(outs, ins, grad_outputs=grad_outputs,
                      retain_graph=True, allow_unused=True)
    return res if len(res) > 1 else res[0]
