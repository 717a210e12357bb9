"""``paddle.quantization`` (``paddle_tpu/quantization/__init__.py``):
``QuantConfig`` with QAT and PTQ over fake-quant ops, and the KV-page
quantizer of the serving engine (:mod:`.observers`).

Fake quantization is ``q * s / qmax`` with ``q = clip(round(x / s *
qmax), -qmax, qmax)`` and ``s = max(scale, 1e-9)`` (round half to even,
as ``jnp.round``), in the input's dtype; its gradient is straight
through inside the range ``|x| <= s`` and zero outside, none for the
scale (:class:`_FakeQuant`, the JAX package's ``custom_vjp``). The
observers and quanters are facade Layers whose statistics are host
floats (one host read a call), as there.

The default QAT/PTQ mapping wraps what the JAX package's wraps: the
facade ``nn.Linear`` and ``nn.Conv2D``, and the torch ``Linear`` of
``models/_modules.py``, from which the port's GPT and Llama build the
projections that the JAX models build from ``nn.Linear``
(:class:`QuantedTorchLinear`, whose quanters see the ``[out, in]``
weight: per-tensor absmax scales and elementwise rounding give the
transpose of the JAX package's values).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Type

import torch

from ..autograd.engine import apply_op
from ..nn.layer_base import Layer
from ..ops._apply import ensure_tensor
from ..tensor import Tensor
from .observers import (KV_QMAX, KV_SCALE_FLOOR, dequantize_kv,
                        kv_absmax_scales, quantize_kv)

__all__ = [
    "QuantConfig", "QAT", "PTQ", "BaseObserver", "BaseQuanter",
    "AbsmaxObserver", "FakeQuanterWithAbsMaxObserver", "QuantedLinear",
    "QuantedConv2D", "QuantedTorchLinear", "Quantization", "quanter",
    "quanters", "observers", "KV_QMAX", "KV_SCALE_FLOOR",
    "kv_absmax_scales", "quantize_kv", "dequantize_kv",
]


# ----------------------------------------------------------- fake-quant (STE)
class _FakeQuant(torch.autograd.Function):
    """Fake quantization with the straight-through gradient (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, scale, qmax: float):
        s = torch.clamp_min(scale, 1e-9)
        q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
        ctx.save_for_backward(x, s)
        return q * s / qmax

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * (x.abs() <= s).to(g.dtype), None, None


def _fake_quant(x: torch.Tensor, scale: float, qmax: float) -> torch.Tensor:
    s = torch.full((), scale, dtype=torch.float32, device=x.device)
    return _FakeQuant.apply(x, s, qmax)


def _absmax(t: Tensor) -> float:
    return float(t._value.detach().abs().max())


# ------------------------------------------------------------------- base API
class BaseObserver(Layer):
    """Collects statistics and yields scales."""

    def __init__(self, quant_bits: int = 8):
        super().__init__()
        self.quant_bits = quant_bits
        self.qmax = float(2 ** (quant_bits - 1) - 1)

    def scales(self) -> Tensor:
        raise NotImplementedError

    def quantize(self, x):
        """Fake-quantize with the observed scale (after calibration)."""
        s = float(self.scales()._value)
        return apply_op(lambda v: _fake_quant(v, s, self.qmax),
                        [ensure_tensor(x)], name="fake_quant")


class BaseQuanter(BaseObserver):
    """An observer that also fake-quantizes in its forward (QAT)."""


class _Factory:
    """Configs hold a factory so each layer gets its own instance."""

    def __init__(self, cls, *args, **kwargs):
        self.cls, self.args, self.kwargs = cls, args, kwargs

    def _instance(self):
        return self.cls(*self.args, **self.kwargs)


def _instantiate(spec):
    if spec is None:
        return None
    if isinstance(spec, _Factory):
        return spec._instance()
    if isinstance(spec, type):
        return spec()
    return copy.deepcopy(spec)  # a template instance: one copy a layer


# ------------------------------------------------------------------ observers
class AbsmaxObserver(BaseObserver):
    """Running max(|x|) over calibration batches; the forward passes its
    input through."""

    def __init__(self, quant_bits: int = 8):
        super().__init__(quant_bits)
        self._max = 1e-9

    def forward(self, x):
        xt = ensure_tensor(x)
        self._max = max(self._max, _absmax(xt))
        return xt

    def scales(self) -> Tensor:
        return Tensor._wrap(torch.tensor(self._max, dtype=torch.float32))


# ------------------------------------------------------------------- quanters
class FakeQuanterWithAbsMaxObserver(BaseQuanter):
    """Moving-average absmax (in training) and the fake-quant forward."""

    def __init__(self, moving_rate: float = 0.9, quant_bits: int = 8):
        super().__init__(quant_bits)
        self.moving_rate = moving_rate
        self._state = 1.0
        self._accum = 1.0
        self._scale = 1e-9

    def forward(self, x):
        xt = ensure_tensor(x)
        if self.training:
            r = self.moving_rate
            self._accum = r * self._accum + _absmax(xt)
            self._state = r * self._state + 1.0
            self._scale = self._accum / self._state
        s = max(self._scale, 1e-9)
        return apply_op(lambda v: _fake_quant(v, s, self.qmax), [xt],
                        name="fake_quant")

    def scales(self) -> Tensor:
        return Tensor._wrap(torch.tensor(max(self._scale, 1e-9),
                                         dtype=torch.float32))


# -------------------------------------------------------------------- config
class QuantConfig:
    """Which layers get which quanters: by instance, by name prefix, by
    type, else the global pair; and the QAT layer mapping."""

    def __init__(self, activation=None, weight=None):
        self._global_activation = activation
        self._global_weight = weight
        self._layer_cfg: Dict[int, dict] = {}
        self._name_cfg: Dict[str, dict] = {}
        self._type_cfg: Dict[Type, dict] = {}
        # the defaults, which add_qat_layer_mapping extends
        self._qat_layer_mapping = _default_mapping()

    def add_layer_config(self, layers, activation=None, weight=None):
        layers = layers if isinstance(layers, (list, tuple)) else [layers]
        for layer in layers:
            self._layer_cfg[id(layer)] = {"activation": activation,
                                          "weight": weight}

    def add_name_config(self, names, activation=None, weight=None):
        names = names if isinstance(names, (list, tuple)) else [names]
        for n in names:
            self._name_cfg[n] = {"activation": activation, "weight": weight}

    def add_type_config(self, layer_types, activation=None, weight=None):
        layer_types = layer_types if isinstance(layer_types, (list, tuple)) \
            else [layer_types]
        for t in layer_types:
            self._type_cfg[t] = {"activation": activation, "weight": weight}

    def add_qat_layer_mapping(self, source: Type, target: Type):
        self._qat_layer_mapping[source] = target

    def _config_for(self, layer, name: str) -> Optional[dict]:
        if id(layer) in self._layer_cfg:
            return self._layer_cfg[id(layer)]
        for prefix, cfg in self._name_cfg.items():
            if name == prefix or name.startswith(prefix + "."):
                return cfg
        for t, cfg in self._type_cfg.items():
            if isinstance(layer, t):
                return cfg
        if self._global_activation is not None \
                or self._global_weight is not None:
            return {"activation": self._global_activation,
                    "weight": self._global_weight}
        return None


# ------------------------------------------------------------- quanted layers
class QuantedLinear(Layer):
    """QAT/PTQ wrapper of the facade ``nn.Linear``."""

    def __init__(self, source: Layer, weight_quanter, act_quanter):
        super().__init__()
        self.source = source
        self.weight_quanter = weight_quanter
        self.activation_quanter = act_quanter

    def forward(self, x):
        from ..nn import functional as F

        w = self.source.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        return F.linear(x, w, self.source.bias)


class QuantedConv2D(Layer):
    """QAT/PTQ wrapper of the facade ``nn.Conv2D``."""

    def __init__(self, source: Layer, weight_quanter, act_quanter):
        super().__init__()
        self.source = source
        self.weight_quanter = weight_quanter
        self.activation_quanter = act_quanter

    def forward(self, x):
        from ..nn import functional as F

        src = self.source
        w = src.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        return F.conv2d(x, w, src.bias, stride=src._stride,
                        padding=src._padding, dilation=src._dilation,
                        groups=src._groups)


class QuantedTorchLinear(torch.nn.Module):
    """QAT/PTQ wrapper of ``models/_modules.py``'s ``Linear`` (a torch
    module): the quanters run on facade views of its weight and input,
    then the source's own product (``F.linear`` over the weight's
    transpose)."""

    def __init__(self, source: torch.nn.Module, weight_quanter, act_quanter):
        super().__init__()
        self.source = source
        # facade Layers, kept out of the module tree (host statistics)
        object.__setattr__(self, "weight_quanter", weight_quanter)
        object.__setattr__(self, "activation_quanter", act_quanter)

    def forward(self, x):
        from ..nn import functional as F

        w = self.source.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(Tensor._wrap(w))._value
        if self.activation_quanter is not None:
            wrapped = isinstance(x, Tensor)
            x = self.activation_quanter(x if wrapped else Tensor._wrap(x))
            x = x if wrapped else x._value
        return F.linear(x, w.t(), self.source.bias)

    def train(self, mode: bool = True):
        super().train(mode)
        for q in (self.weight_quanter, self.activation_quanter):
            if q is not None:
                q.train() if mode else q.eval()
        return self


def _default_mapping():
    from .. import nn
    from ..models import _modules

    return {nn.Linear: QuantedLinear, nn.Conv2D: QuantedConv2D,
            _modules.Linear: QuantedTorchLinear}


def _set_child(model, name: str, child) -> None:
    if isinstance(model, Layer):
        model.add_sublayer(name, child)
    else:
        setattr(model, name, child)


# ------------------------------------------------------------------ QAT / PTQ
class Quantization:
    def __init__(self, config: QuantConfig):
        self._config = config

    def _convert_layers(self, model, prefix: str = ""):
        cfg = self._config
        mapping = cfg._qat_layer_mapping
        for name, child in list(model.named_children()):
            path = f"{prefix}.{name}" if prefix else name
            self._convert_layers(child, prefix=path)
            lcfg = cfg._config_for(child, path)
            target = next((tgt for src_t, tgt in mapping.items()
                           if type(child) is src_t), None)
            if lcfg is None or target is None:
                continue
            wq = _instantiate(lcfg.get("weight"))
            aq = _instantiate(lcfg.get("activation"))
            if wq is None and aq is None:
                continue
            _set_child(model, name, target(child, wq, aq))
        return model

    def convert(self, model, inplace: bool = False):
        """The deploy form: each wrapped layer's weight replaced by its
        fake-quantized value, the wrappers and observers dropped."""
        _model = model if inplace else copy.deepcopy(model)
        for name, child in list(_model.named_children()):
            if isinstance(child, (QuantedLinear, QuantedConv2D)):
                src = child.source
                if child.weight_quanter is not None:
                    src.weight._value = child.weight_quanter.quantize(
                        src.weight)._value
                _set_child(_model, name, src)
            elif isinstance(child, QuantedTorchLinear):
                src = child.source
                if child.weight_quanter is not None:
                    with torch.no_grad():
                        src.weight.copy_(child.weight_quanter.quantize(
                            Tensor._wrap(src.weight.detach()))._value)
                _set_child(_model, name, src)
            else:
                self.convert(child, inplace=True)
        return _model


class QAT(Quantization):
    def quantize(self, model, inplace: bool = False):
        assert model.training, (
            "Quantization-Aware Training should work on training models. "
            "Please set training mode by model.train().")
        _model = model if inplace else copy.deepcopy(model)
        return self._convert_layers(_model)


class PTQ(Quantization):
    def quantize(self, model, inplace: bool = False):
        assert not model.training, (
            "Post-Training Quantization should not work on training models. "
            "Please set evaluation mode by model.eval().")
        _model = model if inplace else copy.deepcopy(model)
        return self._convert_layers(_model)


def quanter(class_name: str):
    """Class decorator registering a quanter under ``class_name`` in this
    module (so a config can name it)."""

    def decorator(cls):
        import sys

        setattr(sys.modules[__name__], class_name, cls)
        if class_name not in __all__:
            __all__.append(class_name)
        return cls

    return decorator


from . import observers, quanters  # noqa: E402,F401
