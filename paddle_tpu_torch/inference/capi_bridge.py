"""Python side of the inference C API.

The native shim (``paddle_tpu_torch/csrc/pd_inference_c.cc``, built by
``ops/_build.py`` ``load_host``) embeds CPython and calls only the
functions of this module, as the JAX package's does: the C++ layer only
marshals buffers. ``device`` is ``"gpu"`` (the card, the default) or
``"cpu"``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_predictors: Dict[int, object] = {}
_next_handle = [1]


def create_predictor(prefix: str, device: str = "gpu") -> int:
    from . import Config, create_predictor as _create

    cfg = Config()
    cfg.set_model(prefix)
    if device == "cpu":
        cfg.disable_gpu()
    pred = _create(cfg)
    h = _next_handle[0]
    _next_handle[0] += 1
    _predictors[h] = pred
    return h


def destroy_predictor(handle: int) -> None:
    _predictors.pop(handle, None)


def input_names(handle: int) -> List[str]:
    return _predictors[handle].get_input_names()


def set_input(handle: int, name: str, data, dims: List[int],
              dtype: str) -> None:
    arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(tuple(dims))
    _predictors[handle].get_input_handle(name).copy_from_cpu(arr)


def run(handle: int) -> int:
    return len(_predictors[handle].run())


def output_dims(handle: int, idx: int) -> List[int]:
    pred = _predictors[handle]
    name = pred.get_output_names()[idx]
    return list(pred.get_output_handle(name).shape())


def output_dtype(handle: int, idx: int) -> str:
    pred = _predictors[handle]
    name = pred.get_output_names()[idx]
    return str(pred.get_output_handle(name).copy_to_cpu().dtype)


def copy_output(handle: int, idx: int, out_buffer) -> int:
    pred = _predictors[handle]
    name = pred.get_output_names()[idx]
    arr = np.ascontiguousarray(pred.get_output_handle(name).copy_to_cpu())
    view = np.frombuffer(out_buffer, dtype=arr.dtype, count=arr.size)
    view[:] = arr.ravel()
    return arr.nbytes
