"""Random ops (``paddle_tpu/ops/random.py``).

Each draw takes a fresh ``torch.Generator`` on its device, seeded from
the global generator (``generator.device_generator``), so a run repeats
after ``paddle.seed``; an op given ``seed=`` nonzero draws from that
seed alone. The streams are torch's, not JAX's threefry: tests hold them
by shape, dtype, range and moments, not by value. Ops that take no
tensor draw on the default device; ``uniform_`` and ``exponential_``
write their tensor in place, as initialisers do.
"""
from __future__ import annotations

import torch

from .. import dtypes
from ..device import default_device
from ..generator import device_generator
from ..tensor import Tensor
from ._apply import ensure_tensor

__all__ = [
    "uniform", "uniform_", "normal", "gaussian", "standard_normal", "randn",
    "rand", "randint", "randint_like", "randperm", "bernoulli", "poisson",
    "multinomial", "exponential_", "rand_like", "normal_like",
]

_wrap = Tensor._wrap


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy().reshape(-1))
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s._value) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _gen(device, seed=0):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return device_generator(device)


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    dev = default_device()
    out = torch.empty(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                      device=dev)
    return _wrap(out.uniform_(min, max, generator=_gen(dev, seed)))


@torch.no_grad()
def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    v = x._value
    v.uniform_(min, max, generator=_gen(v.device, seed))
    return x


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype="float32", name=None):
    dev = default_device()
    out = torch.empty(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                      device=dev)
    return _wrap(out.normal_(mean, std, generator=_gen(dev, seed)))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean._value if isinstance(mean, Tensor) else mean
        s = std._value if isinstance(std, Tensor) else std
        ref = m if isinstance(m, torch.Tensor) else s
        out_shape = torch.broadcast_shapes(
            getattr(m, "shape", ()), getattr(s, "shape", ()))
        z = torch.randn(out_shape, generator=_gen(ref.device),
                        device=ref.device)
        return _wrap(m + s * z)
    return gaussian(shape, mean, std)


def standard_normal(shape, dtype="float32", name=None):
    return gaussian(shape, 0.0, 1.0, dtype=dtype)


def randn(shape, dtype="float32", name=None):
    return standard_normal(shape, dtype)


def rand(shape, dtype="float32", name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def _like(x, dtype):
    v = ensure_tensor(x)._value
    return v, dtypes.convert_dtype(dtype) or v.dtype


def rand_like(x, dtype=None, name=None):
    v, dt = _like(x, dtype)
    out = torch.empty(v.shape, dtype=dt, device=v.device)
    return _wrap(out.uniform_(0.0, 1.0, generator=_gen(v.device)))


def normal_like(x, mean=0.0, std=1.0, name=None):
    v, dt = _like(x, None)
    out = torch.empty(v.shape, dtype=dt, device=v.device)
    return _wrap(out.normal_(mean, std, generator=_gen(v.device)))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = default_device()
    return _wrap(torch.randint(low, high, _shape(shape),
                               generator=_gen(dev),
                               dtype=dtypes.convert_dtype(dtype), device=dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    """Integers of ``[low, high)`` in ``dtype`` (default: ``x``'s, which
    may be floating)."""
    if high is None:
        low, high = 0, low
    v, dt = _like(x, dtype)
    ints = torch.randint(low, high, v.shape, generator=_gen(v.device),
                         device=v.device)
    return _wrap(ints.to(dt))


def randperm(n, dtype="int64", name=None):
    dev = default_device()
    return _wrap(torch.randperm(n, generator=_gen(dev), device=dev).to(
        dtypes.convert_dtype(dtype)))


def bernoulli(x, name=None):
    v = ensure_tensor(x)._value.detach()
    return _wrap(torch.bernoulli(v, generator=_gen(v.device)))


def poisson(x, name=None):
    v = ensure_tensor(x)._value.detach()
    return _wrap(torch.poisson(v, generator=_gen(v.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    v = ensure_tensor(x)._value.detach()
    return _wrap(torch.multinomial(v, num_samples, replacement,
                                   generator=_gen(v.device)))


@torch.no_grad()
def exponential_(x, lam=1.0, name=None):
    v = x._value
    v.exponential_(lam, generator=_gen(v.device))
    return x
