"""``Predictor`` (``paddle_tpu/inference/predictor.py``): a ``jit.save``
artifact served through the zero-copy handle protocol.

The program is loaded with ``jit.load`` on the Config's device (the card
unless ``disable_gpu()``; ``RuntimeError`` without one). An input handle
takes a numpy array (``copy_from_cpu``) or a torch tensor
(``share_external_data``, no copy when it is on the device); ``run``
moves the inputs to the device, runs the program (its K1 nodes launch
the kernel on a card) and keeps the outputs on the device; an output
handle gives them back as numpy (``copy_to_cpu``: bf16 widened to f32,
exactly) or as the device tensor (``to_tensor``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .config import Config

__all__ = ["InferTensor", "Predictor", "create_predictor"]


class InferTensor:
    """An input or output handle (``paddle_infer.Tensor``)."""

    def __init__(self, name: str):
        self.name = name
        self._data: Optional[torch.Tensor] = None

    def reshape(self, shape) -> None:
        """Declare the shape before ``copy_from_cpu`` (advisory: the data
        carries its own)."""
        self._shape = tuple(int(s) for s in shape)

    def copy_from_cpu(self, data) -> None:
        self._data = torch.from_numpy(np.array(data, order="C"))

    def share_external_data(self, data: torch.Tensor) -> None:
        self._data = data

    def to_tensor(self) -> torch.Tensor:
        if self._data is None:
            raise RuntimeError(f"tensor {self.name!r} holds no data yet "
                               "(run() first?)")
        return self._data

    def copy_to_cpu(self) -> np.ndarray:
        t = self.to_tensor().detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def shape(self) -> List[int]:
        if self._data is not None:
            return list(self._data.shape)
        return list(getattr(self, "_shape", ()))

    def type(self):
        return None if self._data is None else self._data.dtype


class Predictor:
    def __init__(self, config: Config):
        from .. import jit

        self._config = config
        prefix = config.model_prefix()
        if prefix is None:
            raise ValueError("Config has no model location; call set_model")
        self._layer = jit.load(prefix, device=config.device())
        self._device = self._layer._device
        self._input_names = list(self._layer._input_names)
        self._inputs: Dict[str, InferTensor] = {
            n: InferTensor(n) for n in self._input_names}
        self._outputs: Dict[str, InferTensor] = {}
        self._output_names: List[str] = []

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> InferTensor:
        if name not in self._inputs:
            raise KeyError(f"unknown input {name!r}; inputs: "
                           f"{self._input_names}")
        return self._inputs[name]

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_output_handle(self, name: str) -> InferTensor:
        return self._outputs[name]

    def run(self, inputs: Optional[list] = None):
        """Run the program on the input handles' data (or on ``inputs``,
        numpy arrays or tensors by position). Returns the outputs as
        numpy arrays; the output handles keep them on the device."""
        self.run_tensors(inputs)
        return [self._outputs[n].copy_to_cpu() for n in self._output_names]

    def run_tensors(self, inputs: Optional[list] = None) -> List[torch.Tensor]:
        """As :meth:`run`, returning the outputs as device tensors."""
        if inputs is not None:
            for n, x in zip(self._input_names, inputs):
                h = self._inputs[n]
                h.share_external_data(x) if isinstance(x, torch.Tensor) \
                    else h.copy_from_cpu(np.asarray(x))
        xs = []
        for n in self._input_names:
            if self._inputs[n]._data is None:
                raise RuntimeError(f"input {n!r} not set; call "
                                   "get_input_handle(name).copy_from_cpu")
            xs.append(self._inputs[n]._data.to(self._device,
                                               non_blocking=True))
        out = self._layer(*xs)
        flat = out if isinstance(out, (list, tuple)) else [out]
        flat = [getattr(t, "_value", t) for t in flat]
        self._output_names = [f"out{i}" for i in range(len(flat))]
        self._outputs = {}
        for name, t in zip(self._output_names, flat):
            h = InferTensor(name)
            h.share_external_data(t)
            self._outputs[name] = h
        return flat

    def clear_intermediate_tensor(self) -> None:
        pass  # nothing survives run() but the outputs

    def try_shrink_memory(self) -> None:
        import gc

        gc.collect()
        if self._device.type == "cuda":
            torch.cuda.empty_cache()


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
