"""Activation functionals (``paddle_tpu/nn/functional/activation.py``).

Each takes the JAX package's signature, facade or torch tensors
(``tensor.facade_io``), and casts its input by the amp rule under the
JAX package's op name. The in-place forms (``relu_``, ``tanh_``,
``softmax_``) write a facade tensor as the facade's in-place ops do
(``autograd.engine.inplace_rebind``) and a torch tensor in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ... import dtypes
from ...amp import cast_inputs
from ...autograd.engine import inplace_rebind
from ...generator import device_generator
from ...ops.math import clip_tensor
from ...tensor import Tensor, facade_io
from .common import as_torch

__all__ = [
    "celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
    "log_softmax", "maxout", "mish", "prelu", "relu", "relu_", "relu6",
    "rrelu", "selu", "sigmoid", "silu", "softmax", "softmax_", "softplus",
    "softshrink", "softsign", "swish", "tanh", "tanh_", "tanhshrink",
    "thresholded_relu",
]


def _unary(name, fn):
    """A functional ``f(x, *attrs)``: ``fn`` on x amp-cast under
    ``name``."""
    def call(x, *args, **kwargs):
        (a,) = cast_inputs(name, as_torch(x))
        return fn(a, *args, **kwargs)
    return call


def _in_place(fn, x, *args):
    if isinstance(x, Tensor):
        return inplace_rebind(x, fn(x, *args))
    return x.copy_(fn(x, *args))


@facade_io
def relu(x, name=None):
    return _unary("relu", torch.relu)(x)


def relu_(x, name=None):
    return _in_place(relu, x)


@facade_io
def relu6(x, name=None):
    # jax.nn.relu6's gradient: only where 0 < x < 6 (none at 0 and 6)
    return _unary("relu6", lambda a: torch.where(
        (a > 0.0) & (a < 6.0), a, a.clamp(0.0, 6.0).detach()))(x)


@facade_io
def sigmoid(x, name=None):
    return _unary("sigmoid", torch.sigmoid)(x)


@facade_io
def log_sigmoid(x, name=None):
    return _unary("log_sigmoid", tF.logsigmoid)(x)


@facade_io
def tanh(x, name=None):
    return _unary("tanh", torch.tanh)(x)


def tanh_(x, name=None):
    return _in_place(tanh, x)


@facade_io
def tanhshrink(x, name=None):
    return _unary("tanhshrink", lambda a: a - torch.tanh(a))(x)


@facade_io
def gelu(x, approximate: bool = False, name=None):
    """erf GELU, or the tanh form with ``approximate=True``."""
    return _unary("gelu", lambda a: tF.gelu(
        a, approximate="tanh" if approximate else "none"))(x)


@facade_io
def silu(x, name=None):
    """``x * sigmoid(x)``; in the O2 dtype under ``auto_cast`` (``silu`` is
    on neither amp list)."""
    return _unary("silu", tF.silu)(x)


@facade_io
def swish(x, name=None):
    return _unary("swish", tF.silu)(x)


@facade_io
def mish(x, name=None):
    return _unary("mish", lambda a: a * torch.tanh(tF.softplus(a)))(x)


@facade_io
def elu(x, alpha: float = 1.0, name=None):
    return _unary("elu", lambda a: torch.where(
        a > 0, a, alpha * torch.expm1(a)))(x)


@facade_io
def celu(x, alpha: float = 1.0, name=None):
    return _unary("celu", lambda a: torch.where(
        a > 0, a, alpha * torch.expm1(a / alpha)))(x)


@facade_io
def selu(x, scale: float = 1.0507009873554804934193349852946,
         alpha: float = 1.6732632423543772848170429916717, name=None):
    return _unary("selu", lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(a)))(x)


@facade_io
def leaky_relu(x, negative_slope: float = 0.01, name=None):
    return _unary("leaky_relu", lambda a: torch.where(
        a >= 0, a, negative_slope * a))(x)


@facade_io
def prelu(x, weight, data_format: str = "NCHW", name=None):
    """``where(x > 0, x, w * x)``, one slope or one per channel (axis 1
    for ``NC*`` layouts, else the last)."""
    a, w = cast_inputs("prelu", as_torch(x), as_torch(weight))
    if w.numel() == 1:
        wb = w.reshape(())
    else:
        shape = [1] * a.dim()
        shape[1 if data_format[1] == "C" else a.dim() - 1] = w.numel()
        wb = w.reshape(shape)
    return torch.where(a > 0, a, wb * a)


@facade_io
def rrelu(x, lower: float = 1.0 / 8.0, upper: float = 1.0 / 3.0,
          training: bool = False, name=None):
    """Training draws each negative slope from U(lower, upper) (a
    generator on x's device seeded from the global one); inference
    uses their mean."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)
    (a,) = cast_inputs("rrelu", as_torch(x))
    slopes = torch.empty_like(a).uniform_(
        lower, upper, generator=device_generator(a.device))
    return torch.where(a >= 0, a, slopes * a)


@facade_io
def hardtanh(x, min: float = -1.0, max: float = 1.0, name=None):
    return _unary("hardtanh", lambda a: clip_tensor(a, min, max))(x)


@facade_io
def hardshrink(x, threshold: float = 0.5, name=None):
    return _unary("hardshrink", lambda a: torch.where(
        a.abs() > threshold, a, 0.0).to(a.dtype))(x)


@facade_io
def softshrink(x, threshold: float = 0.5, name=None):
    return _unary("softshrink", lambda a: torch.where(
        a > threshold, a - threshold,
        torch.where(a < -threshold, a + threshold, 0.0)).to(a.dtype))(x)


@facade_io
def hardsigmoid(x, slope: float = 0.1666667, offset: float = 0.5,
                name=None):
    return _unary("hardsigmoid", lambda a: clip_tensor(
        slope * a + offset, 0.0, 1.0))(x)


@facade_io
def hardswish(x, name=None):
    return _unary("hardswish", lambda a: a * clip_tensor(a + 3.0, 0.0, 6.0)
                  / 6.0)(x)


@facade_io
def softplus(x, beta: float = 1.0, threshold: float = 20.0, name=None):
    return _unary("softplus", lambda a: torch.where(
        beta * a > threshold, a, torch.logaddexp(beta * a, torch.zeros(
            (), dtype=a.dtype, device=a.device)) / beta))(x)


@facade_io
def softsign(x, name=None):
    return _unary("softsign", tF.softsign)(x)


@facade_io
def thresholded_relu(x, threshold: float = 1.0, value: float = 0.0,
                     name=None):
    return _unary("thresholded_relu", lambda a: torch.where(
        a > threshold, a, value).to(a.dtype))(x)


def _with_dtype(dtype):
    dt = dtypes.convert_dtype(dtype)
    return (lambda a: a) if dt is None else (lambda a: a.to(dt))


@facade_io
def softmax(x, axis: int = -1, dtype=None, name=None):
    cast = _with_dtype(dtype)
    return _unary("softmax", lambda a: torch.softmax(cast(a), axis))(x)


def softmax_(x, axis: int = -1, dtype=None, name=None):
    return _in_place(softmax, x, axis, dtype)


@facade_io
def log_softmax(x, axis: int = -1, dtype=None, name=None):
    cast = _with_dtype(dtype)
    return _unary("log_softmax", lambda a: torch.log_softmax(cast(a),
                                                             axis))(x)


@facade_io
def glu(x, axis: int = -1, name=None):
    return _unary("glu", lambda a: tF.glu(a, axis))(x)


@facade_io
def maxout(x, groups: int, axis: int = 1, name=None):
    def fn(a):
        ax = axis % a.dim()
        c = a.shape[ax]
        shape = a.shape[:ax] + (c // groups, groups) + a.shape[ax + 1:]
        return a.reshape(shape).amax(ax + 1)
    return _unary("maxout", fn)(x)


@facade_io
def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1, name=None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g`` (a
    generator on x's device seeded from the global one); ``hard`` gives
    the one-hot of the argmax with the soft sample's gradient."""
    (a,) = cast_inputs("gumbel_softmax", as_torch(x))
    u = torch.empty(a.shape, dtype=torch.float32, device=a.device).uniform_(
        1e-20, 1.0, generator=device_generator(a.device))
    g = -torch.log(-torch.log(u)).to(a.dtype)
    y = torch.softmax((a + g) / temperature, axis)
    if hard:
        idx = y.argmax(axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y
