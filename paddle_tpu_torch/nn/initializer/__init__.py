"""Parameter initializers (``paddle_tpu/nn/initializer``).

Each initializer is a callable ``(shape, dtype, device=None) ->
torch.Tensor``: a new tensor on ``device`` (the default device when
None). A random one draws through its own ``torch.Generator`` on that
device, seeded from the port's global generator
(``generator.device_generator``), so ``paddle.seed(n)`` makes the same
draws again. Draws are made in f32 and cast to ``dtype``.

The values are not the JAX package's: its initializers draw from
threefry keys, these from torch's generators. Parity between the two
packages comes from carrying weights across (``Layer.set_state_dict``,
``models.load_reference_state_dict``), never from drawing them again.
The distributions, their fans and gains are the JAX package's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import dtypes
from ...device import resolve_device
from ...generator import device_generator

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "Bilinear", "calculate_gain",
    "set_global_initializer",
]

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Initializers ``Layer.create_parameter`` uses for a weight (a bias)
    whose ``ParamAttr`` names none, ahead of the layer's own default;
    ``None`` removes them."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def global_initializer(is_bias: bool):
    return _global_bias_init if is_bias else _global_weight_init


class Initializer:
    def __call__(self, shape, dtype, device=None) -> torch.Tensor:
        raise NotImplementedError


def _place(shape, dtype, device):
    return (tuple(int(s) for s in shape), dtypes.convert_dtype(dtype)
            or torch.float32, resolve_device(device))


def _normal(shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=device_generator(device),
                       device=device, dtype=torch.float32)


def _uniform(shape, low, high, device) -> torch.Tensor:
    u = torch.rand(shape, generator=device_generator(device),
                   device=device, dtype=torch.float32)
    return u * (high - low) + low


def _fan_in_out(shape):
    """Paddle's fans: a ``[in, out]`` fc weight, a ``[out, in/g, k...]``
    conv weight (times its receptive field)."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[0] * receptive if len(shape) == 2 else shape[1] * receptive
    fan_out = shape[1] * receptive if len(shape) == 2 else shape[0] * receptive
    return fan_in, fan_out


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return gains[nonlinearity]


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        return (self.mean + self.std * _normal(shape, device)).to(dtype)


class TruncatedNormal(Initializer):
    """Normal truncated at 2 std, drawn by the inverse CDF of a uniform
    over ``[Phi(-2), Phi(2)]``."""

    def __init__(self, mean: float = 0.0, std: float = 1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        lo = 0.5 * (1 + math.erf(-2.0 / math.sqrt(2.0)))
        u = _uniform(shape, lo, 1.0 - lo, device)
        z = math.sqrt(2.0) * torch.erfinv(2 * u - 1)
        return (self.mean + self.std * z.clamp(-2.0, 2.0)).to(dtype)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        return _uniform(shape, self.low, self.high, device).to(dtype)


class _Fans(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0,
                 name=None):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = _fan_in_out(shape)
        return (self._fan_in if self._fan_in is not None else fi,
                self._fan_out if self._fan_out is not None else fo)


class XavierNormal(_Fans):
    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        fi, fo = self._fans(shape)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (std * _normal(shape, device)).to(dtype)


class XavierUniform(_Fans):
    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        fi, fo = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit, device).to(dtype)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu", name=None):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _scale(self, shape):
        fi = self._fan_in if self._fan_in is not None else \
            _fan_in_out(shape)[0]
        return calculate_gain(self.nonlinearity, self.negative_slope), fi


class KaimingNormal(_Kaiming):
    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        gain, fi = self._scale(shape)
        return (gain / math.sqrt(fi) * _normal(shape, device)).to(dtype)


class KaimingUniform(_Kaiming):
    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        gain, fi = self._scale(shape)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit, device).to(dtype)


class Assign(Initializer):
    """A given value (a Tensor, an array or a list) of the parameter's
    shape."""

    def __init__(self, value, name=None):
        v = getattr(value, "_value", value)
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        self.value = np.asarray(v)

    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        if tuple(self.value.shape) != shape:
            raise ValueError(f"Assign initializer shape {self.value.shape} "
                             f"!= parameter shape {shape}")
        return torch.as_tensor(self.value).to(device=device, dtype=dtype)


class Orthogonal(Initializer):
    """The first rows and columns of a Haar-random orthogonal matrix of
    side ``max(rows, cols)`` (QR of a normal matrix, signs fixed by R's
    diagonal), times ``gain``."""

    def __init__(self, gain: float = 1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        if len(shape) < 2:
            raise ValueError("Orthogonal initializer needs >= 2 dims")
        rows, cols = shape[0], int(np.prod(shape[1:]))
        n = max(rows, cols)
        q, r = torch.linalg.qr(_normal((n, n), device))
        q = q * torch.sign(torch.diagonal(r))[None, :]
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    """Identity-preserving conv init: a 1 at each kernel's centre, channel
    i to channel i within each group."""

    def __init__(self, groups: int = 1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        if len(shape) not in (3, 4, 5):
            raise ValueError(
                "Dirac initializer needs conv weight of rank 3/4/5")
        out_c, in_c = shape[0], shape[1]
        value = np.zeros(shape, dtype=np.float32)
        min_c = min(out_c // self.groups, in_c)
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min_c):
                value[(g * (out_c // self.groups) + i, i) + centers] = 1.0
        return torch.from_numpy(value).to(device=device, dtype=dtype)


class Bilinear(Initializer):
    """Bilinear up-sampling kernel for a transposed conv: each ``[k, k]``
    slice of a ``[c_out, c_in, k, k]`` weight is the separable bilinear
    interpolation kernel."""

    def __init__(self, name=None):
        pass

    def __call__(self, shape, dtype, device=None):
        shape, dtype, device = _place(shape, dtype, device)
        if len(shape) != 4:
            raise ValueError("the length of shape must be 4.")
        if shape[2] != shape[3]:
            raise ValueError("shape[2] must be equal to shape[3].")
        size = shape[3]
        f = np.ceil(size / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        k1d = 1 - np.abs(np.arange(size) / f - c)
        kernel = np.outer(k1d, k1d).astype(np.float32)
        value = np.ascontiguousarray(np.broadcast_to(kernel, shape))
        return torch.from_numpy(value).to(device=device, dtype=dtype)


ConstantInitializer = Constant
NormalInitializer = Normal
UniformInitializer = Uniform
