"""Dtype vocabulary (``paddle_tpu/dtypes.py``).

Paddle's dtype names map to torch dtypes: ``paddle.float32`` *is*
``torch.float32``, so ``x.dtype == paddle.float32`` holds for a facade
tensor and a torch tensor alike. :func:`convert_dtype` takes a name, a
numpy dtype or scalar type, or a torch dtype; :func:`dtype_name` gives
the numpy name (``"float32"``, ``"bool"``, ``"bfloat16"``), the name the
JAX package's dtypes print as.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["float16", "bfloat16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "uint16", "uint32", "uint64", "bool_",
           "complex64", "complex128", "convert_dtype", "dtype_name",
           "to_numpy_dtype"]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
uint64 = torch.uint64
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "float16": float16, "bfloat16": bfloat16, "float32": float32,
    "float64": float64, "int8": int8, "int16": int16, "int32": int32,
    "int64": int64, "uint8": uint8, "uint16": uint16, "uint32": uint32,
    "uint64": uint64, "bool": bool_, "complex64": complex64,
    "complex128": complex128,
    # paddle legacy aliases
    "fp16": float16, "bf16": bfloat16, "fp32": float32, "fp64": float64,
}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()
                  if not k.startswith(("fp", "bf1"))}
_DTYPE_TO_NAME[bfloat16] = "bfloat16"


def convert_dtype(dtype):
    """A user-facing dtype spec (name, numpy dtype or type, torch dtype)
    as a torch dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype[len("paddle."):] if dtype.startswith("paddle.") \
            else dtype
        try:
            return _NAME_TO_DTYPE[name]
        except KeyError:
            raise ValueError(f"Unknown dtype name: {dtype!r}") from None
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"Unknown dtype: {dtype!r}") from None
    if name not in _NAME_TO_DTYPE:  # ml_dtypes.bfloat16 names itself so too
        raise ValueError(f"Unknown dtype: {dtype!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype) -> str:
    """The numpy name of ``dtype`` (any form :func:`convert_dtype` takes)."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def to_numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype ``Tensor.numpy`` returns for a torch dtype: its
    own, but f32 for bf16, which numpy lacks (every bf16 value is exact in
    f32)."""
    dtype = convert_dtype(dtype)
    if dtype == bfloat16:
        return np.dtype(np.float32)
    return np.dtype(_DTYPE_TO_NAME[dtype])
