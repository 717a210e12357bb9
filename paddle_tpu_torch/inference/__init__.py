"""``paddle.inference`` of the port (``paddle_tpu/inference``): ``Config``,
``Predictor`` over a ``jit.save`` artifact (a ``torch.export`` program
whose attention is K1's operator), the pool, the enums, the version
queries, ``convert_to_mixed_precision``, and the ``PD_*`` C API
(``paddle_tpu_torch/csrc/pd_inference_c.cc``, built by ``ops/_build.py``
``load_host``), which embeds CPython (or joins the running interpreter)
and calls only :mod:`.capi_bridge`.
"""
import enum

from .config import Config
from .predictor import InferTensor, Predictor, create_predictor

# reference's Tensor alias: paddle.inference.Tensor IS the zero-copy
# handle class (pybind inference_api.cc ZeroCopyTensor binding)
Tensor = InferTensor

__all__ = ["Config", "Predictor", "InferTensor", "Tensor",
           "create_predictor", "DataType", "PlaceType", "PrecisionType",
           "get_version", "get_trt_compile_version",
           "get_trt_runtime_version", "get_num_bytes_of_data_type",
           "PredictorPool", "convert_to_mixed_precision",
           "_get_phi_kernel_name"]


# legacy fluid-op → phi-kernel renames the reference's TransToPhiKernelName
# special-cases (phi/core/compat/convert_utils.cc); everything else maps
# through unchanged
_FLUID_TO_PHI = {
    "matmul_v2": "matmul", "elementwise_add": "add",
    "elementwise_sub": "subtract", "elementwise_mul": "multiply",
    "elementwise_div": "divide", "reduce_sum": "sum", "reduce_mean": "mean",
    "reduce_max": "max", "reduce_min": "min", "reduce_prod": "prod",
    "fill_constant": "full", "flatten_contiguous_range": "flatten",
}


def _get_phi_kernel_name(fluid_op_name: str) -> str:
    """reference: pybind inference_api.cc:502 → phi::TransToPhiKernelName
    (legacy fluid op name → phi kernel name)."""
    return _FLUID_TO_PHI.get(fluid_op_name, fluid_op_name)


class DataType(enum.Enum):
    """reference: pybind inference_api.cc:529 PaddleDType."""
    FLOAT64 = 0
    FLOAT32 = 1
    FLOAT16 = 2
    INT64 = 3
    INT32 = 4
    UINT8 = 5
    INT8 = 6
    BOOL = 7


class PlaceType(enum.Enum):
    """reference: pybind inference_api.cc:636 PaddlePlace."""
    UNK = -1
    CPU = 0
    GPU = 1
    XPU = 2
    NPU = 3
    CUSTOM = 4


class PrecisionType(enum.Enum):
    """reference: pybind inference_api.cc:722 AnalysisConfig::Precision."""
    Float32 = 0
    Int8 = 1
    Half = 2
    Bfloat16 = 3


def get_version() -> str:
    """reference: inference_api.cc get_version — the inference runtime's
    version string."""
    from ..version import full_version

    return f"paddle_tpu_torch inference {full_version}"


def get_trt_compile_version():
    """The all-zero triple the reference returns without TensorRT (the
    port runs the exported program's operators and its own kernels)."""
    return (0, 0, 0)


def get_trt_runtime_version():
    """reference: get_trt_runtime_version — all-zero without TRT."""
    return (0, 0, 0)


def get_num_bytes_of_data_type(dtype) -> int:
    """reference: inference_api.cc paddle_dtype_size."""
    return {DataType.FLOAT64: 8, DataType.FLOAT32: 4, DataType.FLOAT16: 2,
            DataType.INT64: 8, DataType.INT32: 4, DataType.UINT8: 1,
            DataType.INT8: 1, DataType.BOOL: 1}[dtype]


class PredictorPool:
    """Pool of predictors over one Config for multi-threaded serving
    (reference: paddle_infer::services::PredictorPool, pybind
    inference_api.cc). Each slot is an independent Predictor — handles
    must not be shared across threads."""

    def __init__(self, config, size: int = 1):
        self._preds = [create_predictor(config) for _ in range(int(size))]

    def retrieve(self, idx: int):
        return self._preds[idx]


def convert_to_mixed_precision(model_file, params_file, mixed_model_file,
                               mixed_params_file, mixed_precision,
                               backend=None, keep_io_types=True,
                               black_list=frozenset()):
    """Store an exported model's f32/f64 weights in half or bf16
    (reference: inference/wrapper.py:73), as the JAX package does: the
    program is copied unchanged (its signature fixes the compute and io
    dtypes) and ``jit.load`` casts the stored weights back to the
    program's dtypes. bf16 is stored in ``framework/io.py``'s encoding.
    ``keep_io_types=False`` is refused."""
    import os
    import pickle

    import torch

    from ..jit.save_load import _host_params, load_params

    if not keep_io_types:
        raise ValueError("keep_io_types=False is not supported: the "
                         "exported program's signature fixes io dtypes")
    target = {PrecisionType.Half: torch.float16,
              PrecisionType.Bfloat16: torch.bfloat16,
              PrecisionType.Float32: torch.float32}.get(mixed_precision)
    if target is None:
        raise ValueError(f"unsupported mixed_precision {mixed_precision!r}")
    params = load_params(params_file)
    casted = {k: (v.to(target) if v.dtype in (torch.float32, torch.float64)
                  else v) for k, v in params.items()}
    for d in (os.path.dirname(mixed_model_file),
              os.path.dirname(mixed_params_file)):
        if d:
            os.makedirs(d, exist_ok=True)
    with open(mixed_params_file, "wb") as f:
        pickle.dump(_host_params(list(casted), list(casted.values())), f)
    with open(model_file, "rb") as src, open(mixed_model_file, "wb") as dst:
        dst.write(src.read())
