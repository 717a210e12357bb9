"""Automatic mixed precision: the JAX package's per-op cast rule.

Counterpart of ``paddle_tpu/amp/__init__.py`` (``auto_cast``, ``decorate``,
the white and black lists) and of the cast its tape applies to every op
(``paddle_tpu/autograd/engine.py`` ``_amp_cast``). It is not
``torch.autocast``: its lists differ, and O2 casts *every* op that is not
on the black list, so the port reproduces the JAX package's rule at the
same op boundaries. Each op of the port that the JAX package runs through
``apply_op(..., name=...)`` calls :func:`cast_inputs` with that name:

- an op on the black list gets f32 inputs;
- under O2 every other op, and under O1 an op on the white list, gets
  the amp dtype;
- other ops keep their inputs' dtypes.

Only floating tensors are cast. Along GPT's path under O2 that makes
``layer_norm`` f32 (on the f32 norm parameters ``decorate`` keeps), every
``linear``, residual ``add``, ``gelu`` and ``flash_attention`` bf16, the
fused linear-cross-entropy bf16 at its inputs (f32 inside), and the
unfused ``cross_entropy`` f32.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import FrozenSet, Optional, Sequence

import torch
from torch import nn

__all__ = ["auto_cast", "decorate", "cast_inputs", "current_state",
           "restored_state", "WHITE_LIST", "BLACK_LIST"]

# the JAX package's amp lists (paddle_tpu/amp/__init__.py:31, :40)
WHITE_LIST = frozenset({
    "linear", "matmul", "mm", "bmm", "einsum", "dot",
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "scaled_dot_product_attention", "flash_attention",
    "addmm", "matmul_v2",
    "vocab_parallel_embedding", "column_parallel_linear", "row_parallel_linear",
})

BLACK_LIST = frozenset({
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "logsumexp", "cross_entropy", "nll_loss",
    "softmax_with_cross_entropy", "parallel_cross_entropy",
    "mean", "sum", "prod", "cumsum", "norm", "p_norm",
    "batch_norm", "layer_norm", "instance_norm", "group_norm", "rms_norm",
    "sigmoid_cross_entropy_with_logits", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "smooth_l1_loss",
    "mse_loss", "l1_loss",
})

# norm layers whose parameters O2 keeps in f32 (amp/__init__.py:116-121)
_NORM_PREFIXES = ("BatchNorm", "LayerNorm", "SyncBatchNorm", "InstanceNorm",
                  "GroupNorm", "RMSNorm", "LocalResponseNorm", "SpectralNorm")

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class _State:
    dtype: torch.dtype
    level: str
    white: FrozenSet[str]
    black: FrozenSet[str]


_state: contextvars.ContextVar[Optional[_State]] = contextvars.ContextVar(
    "paddle_tpu_torch_amp", default=None)


def _to_dtype(dtype) -> torch.dtype:
    target = _DTYPES.get(dtype, dtype)
    if target not in (torch.bfloat16, torch.float16):
        raise ValueError(f"amp dtype must be bfloat16/float16, got {dtype}")
    return target


@contextlib.contextmanager
def auto_cast(enable: bool = True,
              custom_white_list: Optional[Sequence[str]] = None,
              custom_black_list: Optional[Sequence[str]] = None,
              level: str = "O1", dtype="bfloat16"):
    """The JAX package's ``amp.auto_cast``: inside the block, every op of
    the port casts its floating inputs by :func:`cast_inputs`. O0 or
    ``enable=False`` casts nothing."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"amp level must be O0/O1/O2, got {level}")
    target = _to_dtype(dtype)
    custom_white = set(custom_white_list or ())
    black = (set(BLACK_LIST) - custom_white) | set(custom_black_list or ())
    white = (set(WHITE_LIST) | custom_white) - black
    state = (_State(target, level, frozenset(white), frozenset(black))
             if enable and level != "O0" else None)
    with restored_state(state):
        yield


def current_state() -> Optional[_State]:
    """The active ``auto_cast`` state (None outside one), for code that
    runs an op again later (``recompute``) under the state it first ran
    in."""
    return _state.get()


@contextlib.contextmanager
def restored_state(state: Optional[_State]):
    """Run the block under ``state`` (from :func:`current_state`)."""
    token = _state.set(state)
    try:
        yield
    finally:
        _state.reset(token)


def cast_inputs(name: str, *tensors: torch.Tensor):
    """``tensors`` as the op ``name`` receives them under the active
    ``auto_cast`` (module docstring); unchanged outside it. Returns a
    tuple in the given order; ``None`` entries pass through."""
    st = _state.get()
    if st is None:
        return tensors
    if name in st.black:
        target = torch.float32
    elif st.level == "O2" or name in st.white:
        target = st.dtype
    else:
        return tensors
    return tuple(t.to(target) if t is not None and t.is_floating_point()
                 and t.dtype != target else t for t in tensors)


def decorate(models, optimizers=None, level: str = "O2", dtype="bfloat16",
             master_weight: Optional[bool] = None):
    """The JAX package's ``amp.decorate``: O2 casts every floating
    parameter to ``dtype`` in place, except those of norm layers, and
    turns on the optimizers' master weights unless ``master_weight`` is
    False. O1 changes nothing. Returns what it was given, as there."""
    if level not in ("O1", "O2"):
        raise ValueError("decorate level must be O1 or O2")
    single_model = not isinstance(models, (list, tuple))
    single_opt = (optimizers is not None
                  and not isinstance(optimizers, (list, tuple)))
    model_list = [models] if single_model else list(models)
    opt_list = [optimizers] if single_opt else list(optimizers or [])
    if level == "O2":
        target = _to_dtype(dtype)
        for m in model_list:
            for layer in m.modules():
                if type(layer).__name__.startswith(_NORM_PREFIXES):
                    continue
                for p in layer.parameters(recurse=False):
                    if p.is_floating_point():
                        _recast(p, target)
        for opt in opt_list:
            if master_weight is not False:
                opt._multi_precision = True
    if optimizers is None:
        return models if single_model else model_list
    return (model_list[0] if single_model else model_list,
            opt_list[0] if single_opt else opt_list)


@torch.no_grad()
def _recast(p: nn.Parameter, dtype: torch.dtype) -> None:
    """Cast ``p`` in place (its identity, and so every reference to it,
    an optimizer's included, stays)."""
    p.data = p.data.to(dtype)
    if p.grad is not None:
        p.grad = p.grad.to(dtype)
