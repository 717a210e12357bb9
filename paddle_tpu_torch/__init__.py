"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

``import paddle_tpu_torch as paddle`` is the Paddle namespace of the
port: ``Tensor``, ``Parameter`` and ``to_tensor`` (:mod:`.tensor`, a
thin cell over one ``torch.Tensor`` whose tape is torch autograd), every
op of ``paddle_tpu/ops`` (:mod:`.ops`), the dtypes, ``seed`` and the RNG
state, grad mode and ``paddle.grad``, ``set_device``/``get_device``, and
the modules ``autograd``, ``nn``, ``optimizer`` (with ``optimizer.lr``),
``amp``, ``jit``, ``linalg``, ``models`` and ``vision``, and
``set_flags``/``get_flags``, ``save``/``load``, ``Model`` and the modules
``io``, ``metric``, ``callbacks``, ``hapi`` and ``checkpoint``,
``distributed`` with ``DataParallel``, and the deployment and
observability modules ``inference``, ``profiler`` and ``quantization``
with ``device.cuda``, the places, ``summary``, ``flops`` and the small
names of ``framework.core_api``.

The JAX package ``paddle_tpu`` is the reference; this package grows
beside it slice by slice, keeping its module layout and names so each
module has an obvious counterpart. It imports torch and numpy, never
jax or paddle_tpu.

Its slices so far: the serving data plane (``serving.ServingEngine``
over the paged KV pool, whose attention is the CUDA kernel
``csrc/paged_attention.cu``), with the captured serving step, the prefix
cache, int8 pages, speculative decoding, LoRA adapters, constrained
decoding, the host page tier, metrics, faults and the control plane; the
training steps of the root ``bench.py``'s ``bench_gpt13`` and
``bench_llama`` (``python -m paddle_tpu_torch.bench``, attention through
the CUDA flash kernels of ``csrc/flash_attention.cu``), captured as a
CUDA graph per input signature by ``jit.StaticFunction`` with the LR
schedulers, ``GradScaler``, grad clipping and dropout seeds carried as
data, and the fused AdamW kernel ``csrc/fused_adamw.cu``; the eager
core above; and Paddle's ``nn`` (``nn.Layer`` over facade Parameters,
``ParamAttr``, the initializers, the common, activation, container,
norm, loss and Transformer layers, ``nn.utils``) with BERT's pretraining
step (``models.BertForPretraining``, ``bench --model bert``); the conv,
pooling and RNN layers with ``vision.models``' ResNet family and
ResNet-50's training step (``bench --model resnet50``); Llama's and GPT's
KV-cache ``generate()`` (host and device loop, as CUDA graphs on the
card) with the HF converters, the named recompute policies, the flags
with the NaN/Inf sweep, ``paddle.linalg`` and ``nn``'s extended
functionals and layers; crash-consistent checkpoints
(``checkpoint.CheckpointManager`` over ``distributed.checkpoint``'s
files, the JAX package's format), ``save``/``load``, the train sentinel
(``faults.TrainSentinel``), ``io.DataLoader`` with its samplers and
datasets, ``metric``, ``hapi.Model`` with its callbacks, and the
router's rolling weight reload (``serving.Router.reload``); process
groups, the collectives, ``DataParallel``, the mesh, the placements and
the tensor-parallel layers on ``torch.distributed`` (``distributed``),
with GPT's and Llama's tensor-parallel paths, ``spawn`` and ``launch``,
and the DataLoader's process workers; ZeRO, the sharded checkpoint
across ranks and pipelines; sequence parallelism (ring attention over
the mesh's ``sep`` axis, with Llama's and GPT's ``sep`` paths) and
expert parallelism (``incubate.distributed.models.moe``); the rest of
``distributed`` (the parameter server, ``rpc``, the auto-parallel
``Engine``); and the model zoo (``vision.models``: the classification
nets, PP-YOLOE and PP-OCR), the detection ops (``vision.ops``) and
``jit.BucketedFunction``, with ``bench --model gpt|yoloe|ocr``; and
deployment and observability: ``jit.save``/``jit.load`` on
``torch.export`` (K1 an operator of the exported graph), ``inference``
with its ``Predictor`` and C API, ``profiler`` on ``torch.profiler``,
``device.cuda``, QAT/PTQ; and ``incubate`` (the fused transformer layers
on K1-K3, ``autotune``, the optimizers with BFGS/L-BFGS, ``asp``,
``autograd``, the segment and graph ops) with ``geometric`` and
``nn.functional.flash_attn_unpadded``.

Every entry point runs on ``cuda`` unless given ``device="cpu"`` or told
``set_device("cpu")`` (:mod:`.device`); kernels are built from ``csrc/``
with ``nvcc`` at first use (:mod:`.ops._build`). Not ported yet, of the
JAX package's namespace: ``static``, ``vision``'s ``transforms``,
``datasets`` and image backend, ``distribution``, ``fft``, ``signal``,
``sparse``, ``onnx`` and the rest of ``utils``.
"""
import torch as _torch

from .device import default_device, get_device, resolve_device, set_device
from . import dtypes  # noqa: E402
from .tensor import Parameter, Tensor, to_tensor  # noqa: E402
from . import autograd  # noqa: E402
from .autograd import (enable_grad, grad, is_grad_enabled,  # noqa: E402
                       no_grad, set_grad_enabled)
from . import ops  # noqa: E402
from .ops import *  # noqa: E402,F401,F403
from .dtypes import (bfloat16, bool_, complex64, complex128,  # noqa: E402
                     float16, float32, float64, int8, int16, int32, int64,
                     uint8)
from .dtypes import bool_ as bool  # noqa: E402,A001 - Paddle's name
from . import framework  # noqa: E402
from .framework.flags import get_flags, set_flags  # noqa: E402
from .framework.core_api import (  # noqa: E402
    CPUPlace, CUDAPinnedPlace, CUDAPlace, LazyGuard, TPUPlace, batch,
    check_shape, create_parameter, disable_signal_handler, dtype, finfo,
    get_cuda_rng_state, get_default_dtype, iinfo, in_dynamic_mode,
    is_tensor, set_cuda_rng_state, set_default_dtype, set_printoptions)
from .generator import (default_generator, get_rng_state,  # noqa: E402
                        seed, set_rng_state)
from . import amp, jit, linalg, models, nn, optimizer, vision  # noqa: E402
from .framework.io import load, save  # noqa: E402
from . import checkpoint, io, metric  # noqa: E402
from . import callbacks, hapi  # noqa: E402
from .hapi import Model  # noqa: E402
from . import distributed  # noqa: E402
from .distributed import DataParallel  # noqa: E402
from . import geometric, incubate  # noqa: E402
from . import (inference, loadgen, profiler, quantization,  # noqa: E402
               regularizer, sysconfig, utils, version)
from .hapi import summary  # noqa: E402
from .nn import ParamAttr  # noqa: E402
from .utils import flops  # noqa: E402


def is_compiled_with_cuda() -> bool:
    """This build: True when torch was built with CUDA (the JAX package,
    a TPU build, says False)."""
    return _torch.version.cuda is not None


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


__version__ = "0.1.0"

__all__ = (["default_device", "resolve_device", "set_device", "get_device",
            "Tensor", "Parameter", "to_tensor", "autograd", "no_grad",
            "enable_grad", "grad", "set_grad_enabled", "is_grad_enabled",
            "ops", "dtypes", "bfloat16", "bool_", "bool", "complex64",
            "complex128", "float16", "float32", "float64", "int8", "int16",
            "int32", "int64", "uint8", "framework", "create_parameter",
            "dtype", "finfo", "get_default_dtype", "iinfo",
            "in_dynamic_mode", "is_tensor", "set_default_dtype",
            "default_generator", "get_rng_state", "seed", "set_rng_state",
            "amp", "jit", "linalg", "models", "nn", "optimizer", "vision",
            "set_flags", "get_flags", "save", "load", "checkpoint", "io",
            "metric", "callbacks", "hapi", "Model", "distributed",
            "DataParallel", "geometric", "incubate", "CPUPlace", "CUDAPlace",
            "CUDAPinnedPlace", "TPUPlace", "LazyGuard", "batch",
            "check_shape", "disable_signal_handler", "get_cuda_rng_state",
            "set_cuda_rng_state", "set_printoptions", "is_compiled_with_cuda",
            "is_compiled_with_tpu", "is_compiled_with_xpu", "ParamAttr",
            "inference", "loadgen", "profiler", "quantization",
            "regularizer", "sysconfig", "utils", "version", "summary",
            "flops", "device"]
           + [n for n in ops.__all__ if n not in ("to_tensor",)])
