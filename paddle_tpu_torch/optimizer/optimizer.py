"""Optimizer base class (``paddle_tpu/optimizer/optimizer.py``).

Per-parameter state ("accumulators") is a dict of tensors on the
parameter's device, created at the first step from each name's
initialiser applied to the parameter (so Adam's moments start in the
parameter's dtype, as there), or all at once by
``_materialize_accumulators``. ``step`` computes each parameter's new
value and state with the subclass's ``_update`` on tensors and writes
them in place: the parameter, every accumulator and ``@master`` keep
their storage for the optimizer's life (``copy_``, never a rebinding),
so a CUDA graph that captured a step reads and writes the same cells on
every replay (the counterpart of the JAX package's donated state slots).

The learning rate is data too: one 0-d f32 buffer per device, written
in place with ``get_lr()`` before each eager step (a fill kernel, no
host sync). Inside a capture the step leaves it alone, and the step
program writes it before each replay (the counterpart of the JAX
package's ``_lr_override``), so an ``LRScheduler`` stepped between calls
needs no new capture.

Master weights (``multi_precision``, set by ``amp.decorate(level="O2")``
unless ``master_weight=False``): a bf16/fp16 parameter keeps an f32 copy
under ``"@master"``; the update runs on it with the f32 grad, and the
parameter holds its down-cast. Without them a low-precision parameter's
whole update runs in its own dtype.

Also as there: parameter groups (a list of dicts with ``params`` and
their own ``learning_rate`` multiplier and ``weight_decay``), an
``LRScheduler`` as ``learning_rate`` (its state in ``state_dict``),
``grad_clip`` (``nn.clip``) applied to the grads before the update, and
``GradScaler``'s ``_found_inf`` skip: a 0-d bool on the device with
which every new value is ``torch.where``'d back to the old one, with no
host branch. ``paddle_tpu_amp_skipped_steps_total`` counts a skipped
eager step (a host read of the flag after the update is queued); a step
being captured counts nothing, as a traced JAX step counts nothing.

Parameters may be torch parameters or facade ``Parameter``s
(``tensor.py``), whose torch value the step writes in place (the cell
keeps its storage, as a module's parameter does).

Under ZeRO (``distributed/sharding.py`` sets ``_zero``) the step updates
this rank's block of each parameter alone: the block is a view of the
parameter (``os``, ``os_g``) or a shard of its own (``p_g_os``), its
state is made from the block (so it is the block's size), its gradient
is that block of the averaged one, and ``_zero.after_step`` gathers the
updated blocks; ``state_dict`` gives the blocks with their global index.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]

_LOW = (torch.bfloat16, torch.float16)


def _value(p) -> torch.Tensor:
    """The torch tensor of a parameter: a facade Parameter's value."""
    return getattr(p, "_value", p)


def _named(parameters) -> List[Tuple[str, torch.nn.Parameter]]:
    """``(name, param)`` pairs from params or ``named_parameters()``
    pairs; a facade Parameter by its name, a torch parameter by its
    position."""
    out = []
    for i, p in enumerate(parameters):
        if isinstance(p, tuple):
            out.append(p)
        else:
            out.append((p.name if hasattr(p, "_value") else f"param_{i}", p))
    return out


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class Optimizer:
    """Subclasses implement ``_update(p, g, accs, lr, name)`` returning
    ``(new_p, new_accs)`` and list their accumulators' initialisers in
    ``_accumulator_specs``. ``lr`` is a 0-dim f32 tensor on the
    parameter's device; ``name`` is the parameter's name; the
    parameter's index and object are ``_current_idx`` and
    ``_current_param`` during the call."""

    _accumulator_specs: Dict[str, Callable] = {}

    def __init__(self, learning_rate: Union[float, LRScheduler] = 0.001,
                 parameters: Optional[Iterable] = None,
                 weight_decay=None, grad_clip=None,
                 name: Optional[str] = None):
        if parameters is None:
            raise ValueError("pass parameters=model.parameters() (or "
                             "model.named_parameters())")
        parameters = list(parameters)
        # per-parameter overrides of the param-group API, by index:
        # [{'params': [...], 'learning_rate': mult, 'weight_decay': wd}]
        self._group_lr_mult: Dict[int, float] = {}
        self._group_wd: Dict[int, object] = {}
        if parameters and isinstance(parameters[0], dict):
            self._param_groups = parameters
            flat = []
            for group in parameters:
                for p in group["params"]:
                    if "learning_rate" in group:
                        self._group_lr_mult[len(flat)] = float(
                            group["learning_rate"])
                    if "weight_decay" in group:
                        self._group_wd[len(flat)] = _coerce_decay(
                            group["weight_decay"])
                    flat.append(p)
            parameters = flat
        else:
            self._param_groups = None
        named = _named(parameters)
        self._names = [n for n, _ in named]
        self._parameter_list = [p for _, p in named]
        self._learning_rate = learning_rate
        # coupled decay added to the gradient: a float (L2Decay) or a
        # callable (param, grad) -> grad
        self.regularization = _coerce_decay(weight_decay)
        self._grad_clip = grad_clip
        self._name = name or type(self).__name__
        self._multi_precision = False
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._lr_bufs: Dict[torch.device, torch.Tensor] = {}
        self._found_inf: Optional[torch.Tensor] = None
        self._found_inf_origin = "amp"
        self._current_idx = -1
        self._current_param = None
        self._global_step = 0
        # ZeRO's per-rank state (distributed/sharding.py), or None
        self._zero = None

    # -------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("optimizer's learning rate can't be set when "
                               "it uses an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler) -> None:
        self._learning_rate = scheduler

    def _lr_buffer(self, device: torch.device) -> torch.Tensor:
        buf = self._lr_bufs.get(device)
        if buf is None:
            buf = torch.zeros((), dtype=torch.float32, device=device)
            self._lr_bufs[device] = buf
        return buf

    def _write_lr(self) -> None:
        """Write ``get_lr()`` into every lr buffer (in place, no host
        sync): before an eager step, or before a captured step's
        replay."""
        lr = self.get_lr()
        for buf in self._lr_bufs.values():
            buf.fill_(lr)

    # ---------------------------------------------------------- state
    def _get_accumulators(self, idx: int, p: torch.Tensor) -> dict:
        """Parameter ``idx``'s state, made at first use from each
        initialiser applied to the parameter. Under master weights a
        low-precision parameter's floating state is made f32 (its
        initial values rounded to the parameter's dtype first): the
        JAX package's state takes f32 at its first update there (the
        update's f32 grad promotes it), and state written in place must
        have its final dtype from the start."""
        accs = self._accumulators.get(idx)
        if accs is None:
            accs = {name: init(p.detach())
                    for name, init in self._accumulator_specs.items()}
            if self._multi_precision and p.dtype in _LOW:
                accs = {k: v.float() if v.is_floating_point() else v
                        for k, v in accs.items()}
            self._accumulators[idx] = accs
        return accs

    def _materialize_accumulators(self) -> None:
        """Create every trainable parameter's state (normally made lazily
        at its first step), its ``@master`` under master weights, and the
        lr buffer of each device, before a capture reads them."""
        for idx, param in enumerate(self._parameter_list):
            p = _value(param)
            if not p.requires_grad or not getattr(param, "trainable", True):
                continue
            if self._zero is not None:
                p = self._zero.local(idx)
            accs = self._get_accumulators(idx, p)
            if (self._multi_precision and p.dtype in _LOW
                    and "@master" not in accs):
                accs["@master"] = p.detach().float()
            self._lr_buffer(p.device)

    def _update(self, p, g, accs: dict, lr, name: str):
        raise NotImplementedError

    def _param_lr(self, idx: int) -> float:
        """The lr multiplier of parameter ``idx``: its group's."""
        return self._group_lr_mult.get(idx, 1.0)

    def _param_regularizer(self, idx: int):
        """Per-parameter > per-group > optimizer-wide."""
        reg = getattr(self._parameter_list[idx], "regularizer", None)
        if reg is not None:
            return reg
        return self._group_wd.get(idx, self.regularization)

    def _collect_params_grads(self) -> List[Tuple[int, object, torch.Tensor]]:
        if self._zero is not None:  # this rank's blocks
            return self._zero.triples()
        out = []
        for idx, param in enumerate(self._parameter_list):
            p = _value(param)
            if (p.grad is None or not p.requires_grad
                    or not getattr(param, "trainable", True)):
                continue
            out.append((idx, param, p.grad))
        return out

    # ---------------------------------------------------------- step
    @torch.no_grad()
    @torch.profiler.record_function("optimizer.step")
    def step(self) -> None:
        """One update of every parameter that has a grad (module
        docstring: clip, the ``_found_inf`` skip, master weights, state in
        place)."""
        triples = self._collect_params_grads()
        if self._grad_clip is not None and triples:
            if self._zero is not None:
                triples = self._zero.clip(self._grad_clip, triples)
            else:
                clipped = self._grad_clip([(param, g)
                                           for _, param, g in triples])
                triples = [(idx, param, g) for (idx, param, _), (_, g)
                           in zip(triples, clipped)]
        found_inf = self._found_inf
        base_lr: Dict[torch.device, torch.Tensor] = {}
        for idx, param, g in triples:
            p = _value(param)
            if p.device not in base_lr:
                buf = self._lr_buffer(p.device)
                if not _capturing(p.device):
                    buf.fill_(self.get_lr())
                base_lr[p.device] = buf
            use_master = self._multi_precision and p.dtype in _LOW
            accs = self._get_accumulators(idx, p)
            if use_master:
                if "@master" not in accs:
                    accs["@master"] = p.detach().float()
                pv, gv = accs["@master"], g.float()
            else:
                pv = p.detach()
                gv = g if g.dtype == pv.dtype else g.to(pv.dtype)
            reg = self._param_regularizer(idx)
            if isinstance(reg, float):
                gv = gv + _weak(reg, pv.dtype) * pv
            elif reg is not None:
                gv = reg(pv, gv)
            plr = self._param_lr(idx)
            lr = base_lr[p.device] * plr if plr != 1.0 else base_lr[p.device]
            self._current_idx, self._current_param = idx, param
            new_val, new_accs = self._update(pv, gv, accs, lr,
                                             self._names[idx])
            if found_inf is not None:
                new_val = torch.where(found_inf, pv, new_val)
                new_accs = {k: torch.where(found_inf, accs[k], v)
                            if k in accs and v.shape == accs[k].shape else v
                            for k, v in new_accs.items()}
            for k, v in new_accs.items():
                old = accs.get(k)
                if old is None or old.dtype != v.dtype \
                        or old.shape != v.shape:
                    accs[k] = v  # new state, or a dtype the update set
                elif v is not old:
                    old.copy_(v)
            if use_master:
                accs["@master"].copy_(new_val)
            p.copy_(new_val)  # the down-cast, under master weights
        self._current_idx, self._current_param = -1, None
        if self._zero is not None:
            self._zero.after_step()
        if found_inf is not None and self._found_inf_origin == "amp" \
                and not _capturing(found_inf.device) and bool(found_inf):
            from ..metrics import get_registry

            get_registry().counter(
                "paddle_tpu_amp_skipped_steps_total",
                "Optimizer updates suppressed by the _found_inf skip "
                "path (GradScaler non-finite gradients)").inc()
        # consumed: a stale flag must not freeze later steps
        self._found_inf = None
        self._found_inf_origin = "amp"
        self._global_step += 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Apply the grads a prior ``loss.backward()`` made (the
        reference's dygraph contract: it never runs autodiff itself);
        raises if there are none."""
        if not any(_value(p).grad is not None for p in self._parameter_list):
            raise RuntimeError(
                "Optimizer.minimize found no gradients: call loss.backward() "
                "before minimize() (minimize only applies already-computed "
                "grads, matching the reference dygraph contract)")
        self.step()
        return None, [(param, g) for _, param, g
                      in self._collect_params_grads()]

    def _grads(self) -> List[torch.Tensor]:
        """The gradients the next step reads (under ZeRO, this rank's
        blocks)."""
        if self._zero is not None:
            return [g for _, _, g in self._zero.triples()]
        return [_value(p).grad for p in self._parameter_list
                if _value(p).grad is not None]

    @torch.no_grad()
    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Every parameter's grad to None (zeroed in place with
        ``set_to_zero``)."""
        if self._zero is not None:
            self._zero.clear()
        for param in self._parameter_list:
            p = _value(param)
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # ------------------------------------------------------ state dict
    def state_dict(self) -> dict:
        """``pos:{index}.{accumulator}`` -> a copy of the tensor, the
        scheduler's state under ``LR_Scheduler``, and ``@global_step``
        (the JAX package's keys: a parameter by its position). Copies,
        since the live state changes in place at every step."""
        sd: Dict[str, object] = {
            f"pos:{idx}.{name}": val.detach().clone()
            for idx, accs in self._accumulators.items()
            for name, val in accs.items()}
        if self._zero is not None:  # the blocks with their global index
            sd = self._zero.sharded_state(sd)
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["@global_step"] = self._global_step
        return sd

    def set_state_dict(self, state_dict: dict) -> None:
        """Load a :meth:`state_dict`: into the existing accumulators in
        place (their storage kept), new ones as copies."""
        state_dict = dict(state_dict)
        lr_state = state_dict.pop("LR_Scheduler", None)
        if lr_state is not None and isinstance(self._learning_rate,
                                               LRScheduler):
            self._learning_rate.set_state_dict(lr_state)
        self._global_step = int(state_dict.pop("@global_step", 0))
        for key, val in state_dict.items():
            pkey, _, name = key.rpartition(".")
            if not pkey.startswith("pos:"):
                continue
            idx = int(pkey[4:])
            if idx >= len(self._parameter_list):
                raise KeyError(
                    f"optimizer state refers to parameter index {idx} but "
                    f"this optimizer has {len(self._parameter_list)}")
            if self._zero is not None:  # this rank's block of it
                val = self._zero.local_state(idx, val)
            val = getattr(val, "_value", val)
            dev = _value(self._parameter_list[idx]).device
            accs = self._accumulators.setdefault(idx, {})
            if name in accs and accs[name].shape == torch.as_tensor(
                    val).shape:
                accs[name].copy_(torch.as_tensor(val))
            else:
                accs[name] = torch.as_tensor(val).to(dev, copy=True)

    load_state_dict = set_state_dict

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.get_lr()})"


def _coerce_decay(weight_decay):
    """A weight decay as the step applies it: None, a float coefficient
    (L2, coupled to the grad) or a callable (param, grad) -> grad."""
    if weight_decay is None or callable(weight_decay):
        return weight_decay
    return float(weight_decay)


_weak_cache: Dict[Tuple[float, torch.dtype], float] = {}


def _weak(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: a Python scalar meets a bf16 array in
    JAX as a bf16 value (a weak type), while torch would apply it at f32
    precision. Exact for f32 use."""
    key = (x, dtype)
    val = _weak_cache.get(key)
    if val is None:
        val = float(torch.tensor(x, dtype=dtype))
        _weak_cache[key] = val
    return val
