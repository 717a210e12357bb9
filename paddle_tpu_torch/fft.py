"""``paddle.fft`` (``paddle_tpu/fft.py``) on ``torch.fft``.

The JAX package computes each transform with one ``jnp.fft`` call, outside
any Pallas kernel, so the port's counterpart is the library call: one
``torch.fft`` function per op, an op of the tape (``apply_op``), so the
gradients are torch autograd's. An integer input is made inexact first as
JAX's x64 mode does (int64 to float64, other integers to float32), so a
transform of float64 data is complex128 in both packages. ``hfftn`` and
``ihfftn`` are the JAX package's compositions (a forward ``fftn`` over the
leading axes then ``hfft`` on the last; ``ihfft`` on the last then
``ifftn`` over the leading ones), all axes sharing the norm, as
``scipy.fft`` defines them.

A real loss's gradient with respect to a complex leaf is the conjugate of
the JAX package's (torch's convention against JAX's); real-input
gradients agree.
"""
from __future__ import annotations

import torch

from .ops._apply import inexact, unary
from .tensor import Tensor

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2", "hfft2", "ihfft2",
    "fftn", "ifftn", "rfftn", "irfftn", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_NORMS = ("backward", "ortho", "forward")


def _check_norm(norm):
    if norm not in _NORMS:
        raise ValueError(
            f"Unexpected norm: {norm}. Norm should be forward, backward "
            f"or ortho")


def _resolved(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a lazy conjugation applied (``ihfft`` returns a view with
    the conjugate bit set, which numpy cannot read)."""
    return t.resolve_conj() if t.is_conj() else t


def _factory(torch_fn, name, is_nd=False, default_axes=None):
    if is_nd:
        def op(x, s=None, axes=default_axes, norm="backward", name=None):
            _check_norm(norm)
            return unary(lambda a: _resolved(torch_fn(
                inexact(a), s=s, dim=axes, norm=norm)), x, name=op.__name__)
    else:
        def op(x, n=None, axis=-1, norm="backward", name=None):
            _check_norm(norm)
            return unary(lambda a: _resolved(torch_fn(
                inexact(a), n=n, dim=axis, norm=norm)), x, name=op.__name__)
    op.__name__ = name
    op.__doc__ = f"``paddle.fft.{name}``: ``torch.fft.{name}``."
    return op


fft = _factory(torch.fft.fft, "fft")
ifft = _factory(torch.fft.ifft, "ifft")
rfft = _factory(torch.fft.rfft, "rfft")
irfft = _factory(torch.fft.irfft, "irfft")
hfft = _factory(torch.fft.hfft, "hfft")
ihfft = _factory(torch.fft.ihfft, "ihfft")

fft2 = _factory(torch.fft.fft2, "fft2", is_nd=True, default_axes=(-2, -1))
ifft2 = _factory(torch.fft.ifft2, "ifft2", is_nd=True,
                 default_axes=(-2, -1))
rfft2 = _factory(torch.fft.rfft2, "rfft2", is_nd=True,
                 default_axes=(-2, -1))
irfft2 = _factory(torch.fft.irfft2, "irfft2", is_nd=True,
                  default_axes=(-2, -1))
fftn = _factory(torch.fft.fftn, "fftn", is_nd=True)
ifftn = _factory(torch.fft.ifftn, "ifftn", is_nd=True)
rfftn = _factory(torch.fft.rfftn, "rfftn", is_nd=True)
irfftn = _factory(torch.fft.irfftn, "irfftn", is_nd=True)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """``paddle.fft.hfft2``: :func:`hfftn` over two axes."""
    return hfftn(x, s=s, axes=axes, norm=norm)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """``paddle.fft.ihfft2``: :func:`ihfftn` over two axes."""
    return ihfftn(x, s=s, axes=axes, norm=norm)


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    """``paddle.fft.hfftn``: C2R Hermitian N-D (module docstring)."""
    _check_norm(norm)

    def f(a):
        a = inexact(a)
        ax = axes if axes is not None else tuple(range(a.ndim))
        *lead, last = ax
        n_last = None if s is None else s[-1]
        if lead:
            s_lead = None if s is None else list(s[:-1])
            a = torch.fft.fftn(a, s=s_lead, dim=tuple(lead), norm=norm)
        return torch.fft.hfft(a, n=n_last, dim=last, norm=norm)

    return unary(f, x, name="hfftn")


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    """``paddle.fft.ihfftn``: R2C Hermitian N-D (module docstring)."""
    _check_norm(norm)

    def f(a):
        a = inexact(a)
        ax = axes if axes is not None else tuple(range(a.ndim))
        *lead, last = ax
        n_last = None if s is None else s[-1]
        out = torch.fft.ihfft(a, n=n_last, dim=last, norm=norm)
        if lead:
            s_lead = None if s is None else list(s[:-1])
            out = torch.fft.ifftn(out, s=s_lead, dim=tuple(lead), norm=norm)
        return _resolved(out)

    return unary(f, x, name="ihfftn")


def _freq(fn, n, d, dtype):
    from . import dtypes

    v = fn(int(n), d=float(d), dtype=torch.float64)
    # from the host values: a new Tensor goes to the default device
    return Tensor(v.to(dtypes.convert_dtype(dtype or "float32")).numpy(),
                  stop_gradient=True)


def fftfreq(n, d=1.0, dtype=None, name=None):
    """``paddle.fft.fftfreq`` (float32 unless ``dtype``)."""
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    """``paddle.fft.rfftfreq`` (float32 unless ``dtype``)."""
    return _freq(torch.fft.rfftfreq, n, d, dtype)


def fftshift(x, axes=None, name=None):
    """``paddle.fft.fftshift``."""
    return unary(lambda a: torch.fft.fftshift(a, dim=axes), x,
                 name="fftshift")


def ifftshift(x, axes=None, name=None):
    """``paddle.fft.ifftshift``."""
    return unary(lambda a: torch.fft.ifftshift(a, dim=axes), x,
                 name="ifftshift")
