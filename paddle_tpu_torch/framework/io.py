"""``paddle.save`` / ``paddle.load`` (``paddle_tpu/framework/io.py``).

Pickled nested state dicts: each Tensor travels as a
:class:`_TensorPayload` holding its values as a host numpy array and its
``stop_gradient``; a bf16 tensor's array is its 16-bit patterns (an
``int16`` view, ``dtype="bfloat16"`` on the payload), so it comes back
bit for bit. Loaded tensors are made on ``device`` (the card unless
told otherwise, as every entry point).

Crash consistency, as there: the bytes go to ``<path>.tmp-<pid>``, are
fsynced (the ``ckpt.fsync`` fault point), then ``os.replace``d over
``path`` (``ckpt.write`` fires before the write, ``ckpt.commit`` before
the replace), and the directory is fsynced. A crash mid-save leaves the
old file whole.

Across packages: :func:`load` reads a file ``paddle_tpu.save`` wrote
without importing that package or ``ml_dtypes``. A restricted unpickler
maps exactly the JAX package's ``paddle_tpu.framework.io._TensorPayload``
onto this module's class, rebuilds numpy arrays from their raw bytes
(a ``ml_dtypes.bfloat16`` array as a bf16 tensor, bit for bit) and
refuses every other class outside a short list of containers. A file
this module writes pickles this module's class, which the JAX package
cannot import: that direction does not cross, by design (use
``distributed.checkpoint``'s format, which both read).
"""
from __future__ import annotations

import collections
import os
import pickle
from typing import Any

import numpy as np
import torch

from .. import faults
from ..device import resolve_device
from ..tensor import Tensor

__all__ = ["save", "load"]

faults.declare_point("ckpt.write", "before each checkpoint file write")
faults.declare_point("ckpt.fsync", "before each checkpoint fsync")
faults.declare_point(
    "ckpt.commit",
    "before paddle.save's replace; CheckpointManager: before the "
    "COMMIT-marker write and again before the publish rename")


def _fsync_file(fh) -> None:
    """flush + fsync behind the ``ckpt.fsync`` fault point: the one
    durability barrier every checkpoint writer shares."""
    fh.flush()
    faults.point("ckpt.fsync")
    os.fsync(fh.fileno())


def _fsync_dir(path: str) -> None:
    """Make a directory entry durable (a rename or create is on disk only
    once its parent directory is fsynced); best effort where a directory
    cannot be opened."""
    faults.point("ckpt.fsync")
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class _TensorPayload:
    """Pickle wrapper telling tensors from plain arrays. ``dtype`` is
    ``"bfloat16"`` when ``array`` holds bf16 bit patterns (``int16``);
    a payload from the JAX package has no ``dtype``."""

    __slots__ = ("array", "stop_gradient", "dtype")

    def __init__(self, array, stop_gradient, dtype=None):
        self.array = array
        self.stop_gradient = stop_gradient
        self.dtype = dtype


def _host(t: torch.Tensor):
    """(numpy array, dtype tag) of a torch tensor, bf16 by bit pattern."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().copy(), "bfloat16"
    return t.cpu().numpy().copy(), None


def _to_saveable(obj: Any) -> Any:
    if isinstance(obj, (Tensor, torch.Tensor)):
        v = getattr(obj, "_value", obj)
        arr, tag = _host(v)
        stop = (obj.stop_gradient if isinstance(obj, Tensor)
                else not v.requires_grad)
        return _TensorPayload(arr, stop, tag)
    if isinstance(obj, dict):
        return type(obj)((k, _to_saveable(v)) for k, v in obj.items()) \
            if isinstance(obj, collections.OrderedDict) \
            else {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


class _Bfloat16:
    """Stands for ``ml_dtypes.bfloat16`` while a JAX file is unpickled."""


class _Dtype:
    """A numpy dtype as the pickle rebuilds it: a real one, or the bf16
    stand-in, whose pickled state is ignored."""

    def __new__(cls, obj, align=False, copy=False):
        if obj is _Bfloat16:
            return object.__new__(cls)
        return np.dtype(obj, align, copy)

    def __setstate__(self, state):
        pass


class _Array:
    """A numpy array as the pickle rebuilds it (``ndarray.__reduce__``):
    the state's raw bytes, made into a numpy array, or into a bf16 torch
    tensor for the bf16 stand-in (:meth:`value`)."""

    def __init__(self, *args):
        self.value = None

    def __setstate__(self, state):
        _version, shape, dtype, fortran, raw = state
        order = "F" if fortran else "C"
        if isinstance(dtype, _Dtype):
            bits = np.frombuffer(bytes(raw), np.int16).reshape(
                shape, order=order)
            self.value = torch.from_numpy(
                bits.copy(order="C")).view(torch.bfloat16)
        elif dtype.hasobject:
            self.value = np.array(raw, dtype=object).reshape(shape,
                                                             order=order)
        else:
            self.value = np.frombuffer(bytes(raw), dtype).reshape(
                shape, order=order).copy(order="C")


def _scalar(dtype, raw):
    return np.frombuffer(bytes(raw), dtype)[0]


_ALLOWED = {
    ("paddle_tpu.framework.io", "_TensorPayload"): _TensorPayload,
    ("paddle_tpu_torch.framework.io", "_TensorPayload"): _TensorPayload,
    ("numpy.core.multiarray", "_reconstruct"): _Array,
    ("numpy._core.multiarray", "_reconstruct"): _Array,
    ("numpy.core.multiarray", "scalar"): _scalar,
    ("numpy._core.multiarray", "scalar"): _scalar,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): _Dtype,
    ("ml_dtypes", "bfloat16"): _Bfloat16,
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "complex"): complex,
    ("builtins", "slice"): slice,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _ALLOWED.get((module, name))
        if cls is None:
            raise pickle.UnpicklingError(
                f"paddle.load refuses {module}.{name}: only tensors, numpy "
                f"arrays and plain containers are loaded")
        return cls


def _from_saved(obj: Any, device) -> Any:
    if isinstance(obj, _Array):
        return obj.value
    if isinstance(obj, _TensorPayload):
        arr = obj.array
        arr = arr.value if isinstance(arr, _Array) else arr
        if getattr(obj, "dtype", None) == "bfloat16":
            arr = torch.from_numpy(np.ascontiguousarray(arr)).view(
                torch.bfloat16)
        elif not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        return Tensor(arr.to(device), stop_gradient=bool(obj.stop_gradient))
    if isinstance(obj, collections.OrderedDict):
        return collections.OrderedDict(
            (k, _from_saved(v, device)) for k, v in obj.items())
    if isinstance(obj, dict):
        return {k: _from_saved(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v, device) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    """reference: paddle.save (framework/io.py:646). Crash-consistent
    (module docstring)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        faults.point("ckpt.write")
        with open(tmp, "wb") as f:
            pickle.dump(_to_saveable(obj), f, protocol=protocol)
            _fsync_file(f)
        faults.point("ckpt.commit")
        os.replace(tmp, path)
    except BaseException:
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d or ".")


def load(path: str, device=None, **configs) -> Any:
    """reference: paddle.load (framework/io.py:888): the saved object,
    its tensors on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        return _from_saved(_Unpickler(f).load(), dev)
