"""Layer containers: Sequential, LayerList, ParameterList, LayerDict (``paddle_tpu/nn/layer/container.py``)."""
from __future__ import annotations

from collections import OrderedDict

from ...tensor import Parameter
from ..layer_base import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and layers and \
                isinstance(layers[0][0], tuple):
            for name, layer in layers[0]:
                self.add_sublayer(str(name), layer)
        else:
            for idx, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(str(layer[0]), layer[1])
                else:
                    self.add_sublayer(str(idx), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        keys = list(self._sub_layers.keys())
        return self._sub_layers[keys[idx]]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def forward(self, input):
        for layer in self._sub_layers.values():
            input = layer(input)
        return input


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        n = len(self._sub_layers)
        if idx < 0:
            idx += n
        return self._sub_layers[str(idx)]

    def __setitem__(self, idx, layer):
        n = len(self._sub_layers)
        if idx < 0:
            idx += n
        self._sub_layers[str(idx)] = layer

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._sub_layers.values())
        layers.insert(index, layer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        n = len(self._parameters)
        if idx < 0:
            idx += n
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter: Parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        layer = self._sub_layers[key]
        del self._sub_layers[key]
        return layer

    def keys(self):
        return self._sub_layers.keys()

    def values(self):
        return self._sub_layers.values()

    def items(self):
        return self._sub_layers.items()

    def update(self, sublayers):
        if isinstance(sublayers, (dict, OrderedDict)):
            items = sublayers.items()
        else:
            items = sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)
        return self
