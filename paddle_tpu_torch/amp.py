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

``GradScaler`` (``paddle_tpu/amp/__init__.py:136``) is the dynamic loss
scaler, its state on the device (below).

Only floating tensors are cast. Along GPT's path under O2 that makes
``layer_norm`` f32 (on the f32 norm parameters ``decorate`` keeps), every
``linear``, residual ``add``, ``gelu`` and ``flash_attention`` bf16, the
fused linear-cross-entropy bf16 at its inputs (f32 inside), and the
unfused ``cross_entropy`` f32.
"""
from __future__ import annotations

import collections.abc
import contextlib
import contextvars
from dataclasses import dataclass
from typing import FrozenSet, Optional, Sequence

import torch
from torch import nn

from .device import resolve_device

__all__ = ["auto_cast", "amp_guard", "decorate", "cast_inputs",
           "current_state", "restored_state", "GradScaler", "WHITE_LIST",
           "BLACK_LIST", "white_list", "black_list", "amp_state",
           "is_bfloat16_supported", "is_float16_supported"]

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


amp_guard = auto_cast  # the legacy name (fluid.dygraph.amp_guard)


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


class _StateView(collections.abc.Mapping):
    """``amp.amp_state``: the active ``auto_cast`` state as the JAX
    package's dict reads (``enabled``, ``dtype``, ``level``, ``white``,
    ``black``). Read-only: the state is a context variable, set by
    :func:`auto_cast`."""

    def _view(self) -> dict:
        st = _state.get()
        if st is None:
            return {"enabled": False, "dtype": None, "level": "O1",
                    "white": frozenset(), "black": frozenset()}
        return {"enabled": True, "dtype": st.dtype, "level": st.level,
                "white": st.white, "black": st.black}

    def __getitem__(self, key):
        return self._view()[key]

    def __iter__(self):
        return iter(self._view())

    def __len__(self):
        return 5


amp_state = _StateView()


def is_bfloat16_supported(device=None) -> bool:
    """bf16 runs on the card's tensor cores and on the CPU."""
    return True


def is_float16_supported(device=None) -> bool:
    """fp16 on a card; False without one."""
    return torch.cuda.is_available()


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
    parameter to ``dtype`` in place, except those of norm layers (a
    Paddle ``Layer``'s sublayers and a torch module's modules by class
    name; a facade Parameter keeps its cell and torch tensor), and
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
            for layer in _layers_of(m):
                if type(layer).__name__.startswith(_NORM_PREFIXES):
                    continue
                for p in _own_parameters(layer):
                    if p.is_floating_point():
                        _recast(p, target)
        for opt in opt_list:
            if master_weight is not False:
                opt._multi_precision = True
    if optimizers is None:
        return models if single_model else model_list
    return (model_list[0] if single_model else model_list,
            opt_list[0] if single_opt else opt_list)


def _layers_of(model):
    """Every layer of ``model`` with itself: a Paddle ``Layer``'s
    ``sublayers(include_self=True)``, a torch module's ``modules()``."""
    if hasattr(model, "sublayers"):
        return model.sublayers(include_self=True)
    return model.modules()


def _own_parameters(layer):
    """The torch tensors of ``layer``'s own parameters (a Layer's facade
    Parameters by their values)."""
    if hasattr(layer, "sublayers"):
        return [p._value for p in layer._parameters.values()
                if p is not None]
    return layer.parameters(recurse=False)


@torch.no_grad()
def _recast(p: nn.Parameter, dtype: torch.dtype) -> None:
    """Cast ``p`` in place (its identity, and so every reference to it,
    an optimizer's included, stays)."""
    p.data = p.data.to(dtype)
    if p.grad is not None:
        p.grad = p.grad.to(dtype)


class GradScaler:
    """Dynamic loss scaling (``paddle_tpu/amp/__init__.py:136``). The
    scale and the good and bad step counters are 0-d device cells (f32,
    int32, int32) written in place, so a captured step updates them
    inside its graph; ``__jit_state__`` lists them, as there. A step with
    a non-finite grad is skipped by the optimizer's ``_found_inf`` path (a
    ``torch.where``, no host branch); ``update`` shrinks the scale after
    ``decr_every_n_nan_or_inf`` bad steps in a row and grows it after
    ``incr_every_n_steps`` good ones. Grads are unscaled at most once a
    step, so ``unscale_`` then a clip then ``step`` divides once.
    ``device`` is where the cells live (the default device, as every
    entry point of the port)."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True, device=None):
        dev = resolve_device(device)
        self._enable = bool(enable)
        self._use_dynamic = bool(use_dynamic_loss_scaling) and self._enable
        self._scale = torch.full((), float(init_loss_scaling),
                                 dtype=torch.float32, device=dev)
        self._good_steps = torch.zeros((), dtype=torch.int32, device=dev)
        self._bad_steps = torch.zeros((), dtype=torch.int32, device=dev)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every = int(incr_every_n_steps)
        self._decr_every = int(decr_every_n_nan_or_inf)
        self._unscaled: set = set()  # optimizers unscaled this step

    def __jit_state__(self):
        return [self._scale, self._good_steps, self._bad_steps]

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic

    def get_loss_scaling(self):
        """The scale, as a facade ``Tensor`` holding a copy."""
        from .tensor import Tensor

        return Tensor._wrap(self._scale.clone())

    @torch.no_grad()
    def set_init_loss_scaling(self, value: float) -> None:
        self._scale.fill_(float(value))

    def scale(self, loss):
        """``loss`` times the scale (a facade loss gives a facade
        tensor)."""
        if not self._enable:
            return loss
        value = getattr(loss, "_value", None)
        if value is None:
            return loss * self._scale
        from .tensor import Tensor

        return Tensor._wrap(value * self._scale)

    @torch.no_grad()
    def _unscale_and_check(self, optimizer) -> torch.Tensor:
        """Divide every grad of ``optimizer`` by the scale in place;
        returns a 0-d bool: some grad is not finite."""
        inv = 1.0 / self._scale
        found = torch.zeros((), dtype=torch.bool, device=self._scale.device)
        for g in optimizer._grads():
            g.mul_(inv.to(g.dtype))
            found = found | ~torch.isfinite(g.float()).all()
        if optimizer._zero is not None:  # every rank skips alike
            found = optimizer._zero.any_rank(found)
        return found

    def step(self, optimizer) -> None:
        """Unscale (unless ``unscale_`` did this step), step with the
        skip flag set, then :meth:`update`."""
        if not self._enable:
            optimizer.step()
            return
        if id(optimizer) in self._unscaled:
            found = optimizer._found_inf
        else:
            found = self._unscale_and_check(optimizer)
            optimizer._found_inf = found
        optimizer._found_inf_origin = "amp"
        try:
            optimizer.step()
        finally:
            optimizer._found_inf = None
            self._unscaled.discard(id(optimizer))
        self.update(found)

    def minimize(self, optimizer, scaled_loss) -> None:
        """Apply the grads ``scaled_loss.backward()`` made (it does not
        run the backward itself)."""
        if not any(getattr(p, "_value", p).grad is not None
                   for p in optimizer._parameter_list):
            raise RuntimeError(
                "GradScaler.minimize found no gradients: call "
                "scaled_loss.backward() before minimize()")
        self.step(optimizer)

    def unscale_(self, optimizer) -> torch.Tensor:
        if id(optimizer) in self._unscaled:
            return optimizer._found_inf
        found = self._unscale_and_check(optimizer)
        optimizer._found_inf = found
        optimizer._found_inf_origin = "amp"
        self._unscaled.add(id(optimizer))
        return found

    @torch.no_grad()
    def update(self, found_inf=None) -> None:
        """The update_loss_scaling rule on the device cells, in place."""
        if not self._use_dynamic or found_inf is None:
            return
        found = getattr(found_inf, "_value", found_inf)
        scale, good, bad = self._scale, self._good_steps, self._bad_steps
        new_bad = torch.where(found, bad + 1, 0)
        new_good = torch.where(found, 0, good + 1)
        shrink = new_bad >= self._decr_every
        grow = new_good >= self._incr_every
        new_scale = torch.where(
            shrink, torch.clamp_min(scale * self._decr_ratio, 1e-6),
            torch.where(grow, scale * self._incr_ratio, scale))
        scale.copy_(new_scale)
        good.copy_(torch.where(grow, 0, new_good))
        bad.copy_(torch.where(shrink, 0, new_bad))

    def state_dict(self) -> dict:
        return {
            "scale": self._scale.clone(),
            "incr_ratio": self._incr_ratio, "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "incr_count": self._good_steps.clone(),
            "decr_count": self._bad_steps.clone(),
            "use_dynamic_loss_scaling": self._use_dynamic,
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Into the cells, in place."""
        for key, cell in (("scale", self._scale),
                          ("incr_count", self._good_steps),
                          ("decr_count", self._bad_steps)):
            if key in state:
                val = getattr(state[key], "_value", state[key])
                cell.copy_(torch.as_tensor(val, dtype=cell.dtype))
