"""The batch channel of the DataLoader's process workers
(``paddle_tpu/io/shm_channel.py``).

The JAX package moves a worker's numpy batch through a native
shared-memory ring. The port's transport is ``torch.multiprocessing``'s:
with ``use_shared_memory`` every tensor of a batch is put on the queue as
a ``torch.Tensor``, whose storage ``torch.multiprocessing`` moves into
shared memory once, so the trainer receives it without a copy through the
pipe; without it the tensors travel as numpy arrays, pickled. A batch is
packed by :func:`pack` in the worker and rebuilt by :func:`unpack`
(the port's ``Tensor``s on the CPU) in the trainer; a worker's exception
travels as a :class:`WorkerFailure`.
"""
from __future__ import annotations

import queue as _queue
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["ShmChannel", "WorkerFailure", "pack", "unpack"]


class WorkerFailure:
    """A worker's exception: the exception (when it pickles) and its
    traceback's text."""

    def __init__(self, exc: BaseException, text: str):
        self.text = text
        try:
            import pickle

            pickle.dumps(exc)
            self.exc = exc
        except Exception:
            self.exc = None

    def reraise(self):
        if self.exc is not None:
            self.exc.add_note(f"in a DataLoader worker process:\n{self.text}")
            raise self.exc
        raise RuntimeError(f"DataLoader worker failed:\n{self.text}")


def pack(batch, shared: bool):
    """A collated batch made ready for the queue (module docstring)."""
    from ..tensor import Tensor

    if isinstance(batch, Tensor):
        v = batch._value.detach()
        return ("T", v if shared else v.numpy())
    if isinstance(batch, dict):
        return ("D", {k: pack(v, shared) for k, v in batch.items()})
    if isinstance(batch, (list, tuple)):
        return ("L" if isinstance(batch, list) else "U",
                [pack(v, shared) for v in batch])
    return ("O", batch)


def unpack(packed):
    """:func:`pack`'s inverse, in the trainer."""
    from ..tensor import Tensor

    kind, v = packed
    if kind == "T":
        return Tensor._wrap(v if isinstance(v, torch.Tensor)
                            else torch.from_numpy(np.asarray(v)))
    if kind == "D":
        return {k: unpack(x) for k, x in v.items()}
    if kind in ("L", "U"):
        out = [unpack(x) for x in v]
        return out if kind == "L" else tuple(out)
    return v


class ShmChannel:
    """A ``torch.multiprocessing`` queue of ``(seq, payload)`` items from
    the workers to the trainer."""

    def __init__(self, ctx):
        self._q = ctx.Queue()

    def put(self, item: Any) -> None:
        self._q.put(item)

    def get(self, timeout: Optional[float] = None):
        """The next item; ``TimeoutError`` after ``timeout`` seconds."""
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            raise TimeoutError("no batch within the timeout") from None

    def close(self) -> None:
        self._q.cancel_join_thread()
        self._q.close()
