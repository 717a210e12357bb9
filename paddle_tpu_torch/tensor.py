"""The eager Tensor (``paddle_tpu/tensor.py``).

A :class:`Tensor` is a thin mutable cell over one ``torch.Tensor``, held
in ``_value``, as the JAX package's is over one ``jax.Array``. It does
not subclass ``torch.Tensor`` and hooks no torch call: the ops of
:mod:`.ops` unwrap their inputs, call plain torch, and wrap what comes
back. Its tape is torch autograd's, so the autograd metadata is read off
``_value``:

- ``stop_gradient`` is ``not _value.requires_grad``. Setting it on a leaf
  calls ``requires_grad_`` (only floating and complex tensors can take a
  gradient; on others ``False`` is ignored, as they get none). Setting
  ``True`` on a non-leaf rebinds ``_value`` to ``_value.detach()``: the
  ops that read it from then on are cut from the graph, the ones that read
  it before keep their edges.
- ``grad`` wraps ``_value.grad`` (None on a non-leaf), and assigning it
  unwraps.
- ``is_leaf`` is ``_value.grad_fn is None``.

A new cell made by :class:`Tensor`, :class:`Parameter` or
:func:`to_tensor` is a leaf over a copy of what it is given, as a new
cell of the JAX package owns an immutable array: an in-place write to it
never reaches the caller's array or tensor.

``numpy()`` returns a copy; a bf16 tensor comes back as f32 (numpy has no
bf16; every bf16 value is exact in f32), so ``np.asarray(t.numpy(),
"float32")`` equals the JAX package's bit for bit.
"""
from __future__ import annotations

import functools
import itertools
from typing import Optional

import numpy as np
import torch

from . import dtypes
from .device import resolve_device, torch_device_name

__all__ = ["Tensor", "Parameter", "to_tensor", "unwrap", "facade_io"]

_uid_counter = itertools.count()

# The hooks of the static-graph front end, read by :func:`facade_io` and
# ``autograd.engine.apply_op``, the port's two op entries: the open
# program's recorder (``static/record.py``) and the observers of control
# flow's capture discovery (``static/nn/control_flow.py``), each called
# with the Tensors an op reads.
program_recorder = None
op_observers: list = []
# conditional-node bodies being captured on this process's card
# (``ops/graph_cond.py``): a host read there raises before it reaches
# the device
capturing_bodies = 0


def _no_host_read(v: torch.Tensor) -> None:
    if capturing_bodies and v.is_cuda:
        raise RuntimeError(
            "a tensor cond/while captured as a conditional node of a CUDA "
            "graph cannot read a device value on the host (.item(), "
            "bool(tensor), .numpy(), float(tensor)): the predicate is read "
            "on the device at every replay")


def _from_numpy(arr: np.ndarray, dtype, device,
                copy: bool = False) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: by bit pattern
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        if arr.dtype == object:
            raise TypeError(f"cannot make a tensor of {arr!r}")
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr, order="C")
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype, copy=copy)


def _as_torch(data, dtype=None, device=None,
              copy: bool = False) -> torch.Tensor:
    """``data`` (a Tensor, a torch tensor, an array, a scalar or a nested
    list) as a torch tensor, detached, and in storage of its own when
    ``copy``: tensors keep their device unless ``device`` is given,
    everything else goes to ``resolve_device(device)``."""
    if isinstance(data, Tensor):
        data = data._value
    if isinstance(data, torch.Tensor):
        dev = None if device is None else resolve_device(device)
        return data.detach().to(device=dev, dtype=dtype, copy=copy)
    return _from_numpy(np.asarray(data), dtype, resolve_device(device),
                       copy)


def _takes_grad(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


class Tensor:
    """Eager tensor: one ``torch.Tensor`` and a name (module docstring)."""

    __slots__ = ("_value", "_name", "dist_attr", "__weakref__")

    def __init__(self, value, stop_gradient: bool = True,
                 name: Optional[str] = None):
        self._init_leaf(_as_torch(value, copy=True), stop_gradient, name)

    def _init_leaf(self, v: torch.Tensor, stop_gradient: bool,
                   name: Optional[str]) -> None:
        """Make this cell a leaf over ``v``, a detached tensor that
        nothing else holds."""
        if not stop_gradient and _takes_grad(v):
            v.requires_grad_(True)
        self._value = v
        self._name = name
        self.dist_attr = None

    @classmethod
    def _wrap(cls, value: torch.Tensor) -> "Tensor":
        """A cell over ``value`` as it is, graph and all (an op's output)."""
        t = object.__new__(cls)
        t._value = value
        t._name = None
        t.dist_attr = None
        return t

    # ------------------------------------------------------------ meta
    @property
    def name(self) -> str:
        if self._name is None:
            self._name = f"tensor_{next(_uid_counter)}"
        return self._name

    @name.setter
    def name(self, value: str) -> None:
        self._name = value

    @property
    def value(self) -> torch.Tensor:
        return self._value

    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self) -> int:
        return self._value.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self._value.dtype

    @property
    def size(self) -> int:
        return self._value.numel()

    def numel(self) -> int:
        return self._value.numel()

    @property
    def place(self) -> str:
        d = self._value.device
        return "cpu" if d.type == "cpu" else f"gpu:{d.index or 0}"

    @property
    def is_leaf(self) -> bool:
        return self._value.grad_fn is None

    @property
    def _grad_node(self):
        """The torch autograd node that made this value (None on a leaf)."""
        return self._value.grad_fn

    # -------------------------------------------------------- autograd
    @property
    def stop_gradient(self) -> bool:
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        v = self._value
        want = not value
        if want == v.requires_grad:
            return
        if v.grad_fn is None:
            if not want or _takes_grad(v):
                v.requires_grad_(want)
        elif value:
            self._value = v.detach()

    @property
    def grad(self) -> Optional["Tensor"]:
        v = self._value
        if v.grad_fn is not None or v.grad is None:
            return None
        return Tensor._wrap(v.grad)

    @grad.setter
    def grad(self, g) -> None:
        self._value.grad = None if g is None else unwrap(g)

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from .autograd import backward

        backward([self], None if grad_tensor is None else [grad_tensor],
                 retain_graph)

    def register_hook(self, hook):
        """``hook(grad)`` runs when this tensor's gradient is computed; it
        returns a new gradient or None. The handle has ``remove()``."""
        def torch_hook(g):
            out = hook(Tensor._wrap(g))
            return None if out is None else unwrap(out)

        return self._value.register_hook(torch_hook)

    def clear_grad(self) -> None:
        self._value.grad = None

    def clear_gradient(self, set_to_zero: bool = False) -> None:
        g = self._value.grad
        if set_to_zero and g is not None:
            g.zero_()
        else:
            self._value.grad = None

    def detach(self) -> "Tensor":
        if program_recorder is not None:  # an op of the program too
            from .autograd.engine import apply_op

            return apply_op(torch.Tensor.detach, [self],
                            differentiable=False, name="detach")
        return Tensor._wrap(self._value.detach())

    # ------------------------------------------------------ conversion
    def numpy(self) -> np.ndarray:
        _no_host_read(self._value)
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        if v.device.type == "cpu":
            return v.numpy().copy()
        return v.cpu().numpy()

    def item(self):
        _no_host_read(self._value)
        return self._value.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype) -> "Tensor":
        from .ops import cast

        return cast(self, dtype)

    def cast(self, dtype) -> "Tensor":
        return self.astype(dtype)

    def clone(self) -> "Tensor":
        from .ops import assign

        return assign(self)

    def cpu(self) -> "Tensor":
        return Tensor(self._value.cpu(), stop_gradient=self.stop_gradient)

    def block_until_ready(self) -> "Tensor":
        if self._value.is_cuda:
            torch.cuda.synchronize(self._value.device)
        return self

    # ------------------------------------------------------------ repr
    def __repr__(self):
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtypes.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n"
                f"       {self.numpy()!r})")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __iter__(self):
        """The first axis, one row at a time; a 0-d tensor raises at
        ``iter()``, as numpy does."""
        if self.ndim == 0:
            raise TypeError("iteration over a 0-d tensor")

        def rows(n):
            for i in range(n):
                yield self[i]

        return rows(self._value.shape[0])

    def __bool__(self):
        _no_host_read(self._value)
        return bool(self._value)

    def __int__(self):
        return int(self.item())

    def __float__(self):
        return float(self.item())

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return repr(self)

    def __hash__(self):
        # by identity: a cell keeps its hash when an in-place op rebinds it
        return id(self)

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    # the operators and op methods are patched in by paddle_tpu_torch.ops


class Parameter(Tensor):
    """A Tensor with ``stop_gradient=False`` (when ``trainable``) and the
    optimizer's attributes (``paddle_tpu/tensor.py:252``)."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "need_clip")

    def __init__(self, value, trainable: bool = True,
                 name: Optional[str] = None):
        super().__init__(value, stop_gradient=not trainable, name=name)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> Tensor:
    """``paddle.to_tensor``: a new leaf on ``place`` (default: the device
    of ``set_device``, else the card). A numpy float64 array or a Python
    float becomes f32 when no ``dtype`` is given; Python ints become
    int64. A tensor keeps its device unless ``place`` is given."""
    dtype = dtypes.convert_dtype(dtype)
    device = torch_device_name(place)
    if not isinstance(data, (Tensor, torch.Tensor)):
        data = np.asarray(data)
        if dtype is None and data.dtype == np.float64:
            dtype = torch.float32
    t = object.__new__(Tensor)
    t._init_leaf(_as_torch(data, dtype, device, copy=True), stop_gradient,
                 None)
    return t


def unwrap(x):
    """The torch tensor of a Tensor; anything else as it is."""
    return x._value if isinstance(x, Tensor) else x


def _unwrap_all(values):
    """``values`` with every Tensor unwrapped, and whether there was one."""
    out = [v._value if isinstance(v, Tensor) else v for v in values]
    return out, any(isinstance(v, Tensor) for v in values)


def _wrap_tree(x):
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap_tree(v) for v in x)
    return x


def facade_io(fn):
    """The facade's boundary: ``fn`` (a torch function or a module's
    ``forward``) takes Tensors in place of torch tensors as arguments and,
    when it was given any, returns Tensors in place of the torch tensors
    it returns (in tuples and lists too). Called with torch tensors only,
    it is ``fn`` unchanged. While a static program records, the call is
    one node of it (``static/record.py``)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if op_observers:
            cells = [v for v in (*args, *kwargs.values())
                     if isinstance(v, Tensor)]
            for obs in op_observers:
                obs(cells)
        rec = program_recorder
        if rec is not None and rec.records():
            return rec.call(fn, args, kwargs)
        args, fa = _unwrap_all(args)
        vals, fk = _unwrap_all(list(kwargs.values()))
        out = fn(*args, **dict(zip(kwargs, vals)))
        return _wrap_tree(out) if fa or fk else out

    return call
