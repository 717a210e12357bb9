"""``nn.Layer``, the base class of every Paddle layer of the port
(``paddle_tpu/nn/layer_base.py``).

A Layer holds facade ``Parameter``s (``tensor.py``: cells over
``torch.Tensor`` leaves), buffers (facade ``Tensor``s) and sublayers, in
registries kept in declaration order, and names them as Paddle does
(``encoder.layers.0.self_attn.q_proj.weight``). Its forward calls the
port's functionals and ops, so torch autograd is its tape and the amp
rule casts at the JAX package's op boundaries.

Every write into a parameter or a buffer is in place: ``set_state_dict``
copies into the cell's storage (``copy_``), ``astype``/``to`` swap the
storage under the same torch tensor (``.data``), and nothing rebinds a
cell. An optimizer, and a CUDA graph that captured a step, hold those
tensors and see every write.

Parameters are made on ``device.default_device()``: the card, or a
``RuntimeError`` without one unless ``paddle.set_device("cpu")`` was
called. Nothing falls back to the CPU.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .. import dtypes
from ..device import default_device
from ..tensor import Parameter, Tensor, _from_numpy

__all__ = ["Layer"]

_layer_name_counts: dict = collections.defaultdict(int)


def _unique_layer_name(prefix: str) -> str:
    idx = _layer_name_counts[prefix]
    _layer_name_counts[prefix] += 1
    return f"{prefix}_{idx}"


class HookRemoveHelper:
    def __init__(self, container: dict, key: int):
        self._container = container
        self._key = key

    def remove(self):
        self._container.pop(self._key, None)


def _source_value(src, device) -> torch.Tensor:
    """A state-dict entry (a Tensor, a torch tensor, a numpy array, bf16
    by its bit pattern, or a list) as a torch tensor on ``device``."""
    src = getattr(src, "_value", src)
    if isinstance(src, torch.Tensor):
        return src.detach().to(device)
    return _from_numpy(np.asarray(src), None, device)


@torch.no_grad()
def _retype(t: Tensor, fn) -> None:
    """Give the cell ``fn(value)`` under the same torch tensor (its
    storage swapped through ``.data``), grad included."""
    v = t._value
    v.data = fn(v.data)
    if v.grad is not None:
        v.grad = fn(v.grad)


class Layer:
    """Base class of the Paddle layers (module docstring)."""

    def __init__(self, name_scope: Optional[str] = None,
                 dtype: str = "float32"):
        prefix = name_scope or self.__class__.__name__.lower()
        object.__setattr__(self, "_full_name", _unique_layer_name(prefix))
        object.__setattr__(self, "_parameters", collections.OrderedDict())
        object.__setattr__(self, "_sub_layers", collections.OrderedDict())
        object.__setattr__(self, "_buffers", collections.OrderedDict())
        object.__setattr__(self, "_non_persistable_buffer_names", set())
        object.__setattr__(self, "_forward_pre_hooks",
                           collections.OrderedDict())
        object.__setattr__(self, "_forward_post_hooks",
                           collections.OrderedDict())
        object.__setattr__(self, "_hook_id", 0)
        object.__setattr__(self, "training", True)
        object.__setattr__(self, "_dtype",
                           dtypes.convert_dtype(dtype) or torch.float32)

    # ------------------------------------------------------------ registry
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning parameters")
            params[name] = value
            if layers:
                layers.pop(name, None)
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning sublayers")
            layers[name] = value
            if params:
                params.pop(name, None)
            self.__dict__.pop(name, None)
        elif buffers is not None and name in buffers:
            buffers[name] = (value if value is None or isinstance(value, Tensor)
                             else Tensor(value))
        else:
            if params is not None and name in params:
                if value is None:
                    params.pop(name)
                    object.__setattr__(self, name, None)
                    return
                raise TypeError("cannot assign non-Parameter to parameter "
                                f"attribute {name!r}")
            if layers is not None and name in layers and value is None:
                layers.pop(name)
                object.__setattr__(self, name, None)
                return
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for registry in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(registry)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for registry in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(registry)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        extra = []
        for registry in ("_parameters", "_sub_layers", "_buffers"):
            extra += list(self.__dict__.get(registry) or ())
        return list(super().__dir__()) + extra

    # ---------------------------------------------------------- parameters
    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False,
                         default_initializer=None) -> Optional[Parameter]:
        """A new Parameter of ``shape`` on the default device, made by the
        first of: the ``ParamAttr``'s initializer, the global one
        (``initializer.set_global_initializer``), ``default_initializer``,
        zeros for a bias, ``XavierUniform`` for a weight. ``attr=False``
        gives None (no parameter)."""
        from . import initializer as I
        from .param_attr import ParamAttr

        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtypes.convert_dtype(dtype) or self._dtype
        init = (attr.initializer if attr is not None else None) \
            or I.global_initializer(is_bias) or default_initializer \
            or (I.Constant(0.0) if is_bias else I.XavierUniform())
        value = init(tuple(int(s) for s in shape), dtype, default_device())
        p = Parameter(value, trainable=attr is None or attr.trainable,
                      name=attr.name if attr is not None and attr.name
                      else None)
        if attr is not None:
            p.optimize_attr["learning_rate"] = attr.learning_rate
            p.regularizer = attr.regularizer
            p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter or None")
        if parameter is None:
            self._parameters.pop(name, None)
            object.__setattr__(self, name, None)
        else:
            self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer") -> "Layer":
        if not isinstance(sublayer, Layer):
            raise TypeError("add_sublayer expects a Layer")
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        """Non-parameter state (BatchNorm's running statistics) that
        ``state_dict`` carries unless ``persistable=False``."""
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = Tensor(tensor)
        self._buffers[name] = tensor
        if persistable:
            self._non_persistable_buffer_names.discard(name)
        else:
            self._non_persistable_buffer_names.add(name)

    # ----------------------------------------------------------- traversal
    def named_sublayers(self, prefix: str = "", include_self: bool = False,
                        layers_set=None) -> Iterator:
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, layer in self._sub_layers.items():
            if layer is None or id(layer) in layers_set:
                continue
            yield from layer.named_sublayers(
                prefix=prefix + ("." if prefix else "") + name,
                include_self=True, layers_set=layers_set)

    def sublayers(self, include_self: bool = False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_children(self):
        seen = set()
        for name, layer in self._sub_layers.items():
            if layer is not None and id(layer) not in seen:
                seen.add(id(layer))
                yield name, layer

    def children(self):
        for _, l in self.named_children():
            yield l

    def _named(self, registry: str, prefix: str, include_sublayers: bool):
        seen = set()
        layers = [(prefix, self)]
        if include_sublayers:
            layers += [(prefix + ("." if prefix else "") + n, l)
                       for n, l in self.named_sublayers()]
        for lp, layer in layers:
            for name, t in getattr(layer, registry).items():
                if t is None or id(t) in seen:
                    continue
                seen.add(id(t))
                yield lp + ("." if lp else "") + name, t

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True):
        return self._named("_parameters", prefix, include_sublayers)

    def parameters(self, include_sublayers: bool = True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True):
        return self._named("_buffers", prefix, include_sublayers)

    def buffers(self, include_sublayers: bool = True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def apply(self, fn: Callable) -> "Layer":
        for layer in self.children():
            layer.apply(fn)
        fn(self)
        return self

    def full_name(self) -> str:
        return self._full_name

    # ----------------------------------------------------------- state dict
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True):
        """``{structured name: cell}`` of the parameters and persistable
        buffers, in declaration order; the cells themselves, not
        copies."""
        dest = destination if destination is not None \
            else collections.OrderedDict()
        for name, p in self._parameters.items():
            if p is not None:
                dest[structured_name_prefix + name] = p
        for name, b in self._buffers.items():
            if b is not None and name not in \
                    self._non_persistable_buffer_names:
                dest[structured_name_prefix + name] = b
        if include_sublayers:
            for name, layer in self._sub_layers.items():
                if layer is not None:
                    layer.state_dict(dest, True,
                                     structured_name_prefix + name + ".")
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy each entry into the cell of that name, in place and in the
        cell's dtype (numpy arrays welcome, bf16 ones by bit pattern).
        Returns ``(missing_keys, unexpected_keys)``; a shape mismatch
        raises ``ValueError``."""
        from ..distributed.checkpoint import ShardedLeaf

        own = self.state_dict()
        missing, matched = [], set()
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            if isinstance(target, ShardedLeaf):
                # this rank's block of a global leaf (a pipeline stage's
                # rows): from a block at that index, or the whole leaf
                if isinstance(src, ShardedLeaf):
                    if src.index != target.index:
                        raise ValueError(f"{name}: block {src.index} is not "
                                         f"this rank's {target.index}")
                    src = src.local
                elif tuple(getattr(src, "shape", ())) == target.shape:
                    src = src[tuple(slice(a, b) for a, b in target.index)]
                dst = target.local
            else:
                dst = target._value
            src = _source_value(src, dst.device)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape mismatch for {name}: got "
                                 f"{tuple(src.shape)}, expected "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
            matched.add(name)
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # --------------------------------------------------------------- modes
    def train(self):
        for layer in self.sublayers(include_self=True):
            object.__setattr__(layer, "training", True)
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            object.__setattr__(layer, "training", False)
        return self

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    # --------------------------------------------------------- dtype/device
    def _transform(self, fn):
        for layer in self.sublayers(include_self=True):
            for d in (layer._parameters, layer._buffers):
                for t in d.values():
                    if t is not None:
                        _retype(t, fn)
        return self

    def astype(self, dtype):
        """Cast every floating parameter and buffer in place."""
        dt = dtypes.convert_dtype(dtype)
        return self._transform(
            lambda v: v.to(dt) if v.is_floating_point() else v)

    def to(self, device=None, dtype=None, blocking=None):
        """Move every parameter and buffer to ``device`` (Paddle's or
        torch's name), then cast floating ones to ``dtype``; in place."""
        if device is not None:
            from ..device import torch_device_name

            dev = torch.device(torch_device_name(device))
            self._transform(lambda v: v.to(dev))
        if dtype is not None:
            self.astype(dtype)
        return self

    def float(self):
        return self.astype("float32")

    def bfloat16(self):
        return self.astype("bfloat16")

    # --------------------------------------------------------------- hooks
    def _next_hook_id(self):
        hid = self.__dict__["_hook_id"]
        object.__setattr__(self, "_hook_id", hid + 1)
        return hid

    def register_forward_pre_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs)`` before each forward; a non-None result
        replaces the inputs."""
        hid = self._next_hook_id()
        self._forward_pre_hooks[hid] = hook
        return HookRemoveHelper(self._forward_pre_hooks, hid)

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, outputs)`` after each forward; a non-None
        result replaces the outputs."""
        hid = self._next_hook_id()
        self._forward_post_hooks[hid] = hook
        return HookRemoveHelper(self._forward_post_hooks, hid)

    # ---------------------------------------------------------------- call
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} must implement forward()")

    def __call__(self, *inputs, **kwargs):
        for hook in list(self._forward_pre_hooks.values()):
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            result = hook(self, inputs, outputs)
            if result is not None:
                outputs = result
        return outputs

    # ---------------------------------------------------------------- repr
    def extra_repr(self) -> str:
        return ""

    def __repr__(self):
        lines = []
        for name, layer in self._sub_layers.items():
            sub = repr(layer).split("\n")
            lines.append(f"({name}): " + "\n".join(
                [sub[0]] + ["  " + s for s in sub[1:]]))
        main = f"{type(self).__name__}({self.extra_repr()}"
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"
