"""Sharded, async checkpoint files (``paddle_tpu/distributed/checkpoint``).

The on-disk format is the JAX package's, so a directory written by either
package is read by the other: one ``.npy`` file per shard of each leaf
(``<key>.p<process>.s<i>.npy``, nested keys flattened with ``//``) and a
manifest ``checkpoint.metadata.json`` (``{"format": 1, "leaves": {key:
{"shape", "dtype", "shards": [{"file", "index"}]}}}``) written last,
through tmp + fsync + ``os.replace``: a crash mid-save leaves shards and
no manifest, which a load refuses, never a manifest naming missing
shards. ``checkpoint.CheckpointManager`` adds its COMMIT marker on top.

bf16: ``np.save`` cannot write it and this package has no ``ml_dtypes``,
so a bf16 leaf is written as the JAX package writes an extension dtype,
its raw bytes as ``uint8`` (the ``int16`` view's bytes) under the
manifest dtype ``"bfloat16"``, and read back with
``torch.frombuffer(...).view(torch.bfloat16)``, bit for bit.

Single process only: this package writes one shard per leaf (process 0)
and assembles any shard list it reads; resharding on load (the JAX
module's ``shardings=``/``target=``) waits for the sharded trainer
(ROADMAP Queue 1C).

Async saves copy every leaf to host memory before :func:`save_state_dict`
returns (a tensor on the card with one ``.cpu()``; one on the CPU into a
copy of its own), since the port's parameters and optimizer state change
in place at the next step; the files are then written on a thread, and
:meth:`AsyncHandle.wait` (or module :func:`wait`) re-raises what that
thread hit: an async save is durable only once ``wait()`` returned.

Fault points: ``ckpt.write`` before each shard file, ``ckpt.fsync``
before each fsync, ``ckpt.manifest`` before the manifest write.
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ... import faults
from ...device import resolve_device
from ...framework.io import _fsync_dir, _fsync_file
from ...tensor import Tensor

__all__ = [
    "save_state_dict", "load_state_dict", "AsyncHandle", "CheckpointError",
    "wait",
]

_META = "checkpoint.metadata.json"
_SEP = "//"  # flat-key separator for nested dicts

_pending: list = []
# reentrant: the save_on_signal handler runs on the main thread and may
# interrupt a frame inside this lock
_pending_lock = threading.RLock()

faults.declare_point("ckpt.manifest", "before the shard-manifest write")


class CheckpointError(RuntimeError):
    """A checkpoint save failed: raised by module :func:`wait` for
    several failed saves at once (each in ``errors``)."""

    def __init__(self, msg: str, errors: Optional[list] = None):
        super().__init__(msg)
        self.errors = list(errors or [])


class _DigestWriter:
    """File proxy summing size and CRC32 as the bytes stream out, so the
    COMMIT marker's digests need no second read."""

    __slots__ = ("_fh", "size", "crc")

    def __init__(self, fh):
        self._fh = fh
        self.size = 0
        self.crc = 0

    def write(self, data) -> int:
        n = self._fh.write(data)
        b = memoryview(data)
        self.size += b.nbytes
        self.crc = zlib.crc32(b, self.crc)
        return n

    def flush(self) -> None:
        self._fh.flush()

    def digest(self) -> Dict[str, int]:
        return {"size": self.size, "crc32": self.crc}


def _write_shard_file(fname: str, arr: np.ndarray) -> Dict[str, int]:
    """``np.save``'s bytes (its version 1.0 header, then the data in the
    array's order), the data written and CRC'd in one call from the
    array's own memory instead of ``np.save``'s 16 MiB copies."""
    faults.point("ckpt.write")
    if not (arr.flags.c_contiguous or arr.flags.f_contiguous):
        arr = np.ascontiguousarray(arr)
    header = np.lib.format.header_data_from_array_1_0(arr)
    data = arr.T if header["fortran_order"] else arr
    with open(fname, "wb") as fh:
        w = _DigestWriter(fh)
        np.lib.format.write_array_header_1_0(w, header)
        w.write(memoryview(data.reshape(-1).view(np.uint8)))
        _fsync_file(fh)
    return w.digest()


def _atomic_json_write(path: str, payload: Dict[str, Any]) -> Dict[str, int]:
    """tmp + fsync + atomic replace + parent fsync: the durable small
    file (manifest, scalars, COMMIT). Returns the bytes' digest."""
    data = json.dumps(payload).encode()
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            _fsync_file(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path) or ".")
    return {"size": len(data), "crc32": zlib.crc32(data)}


def _write_manifest(manifest: str, meta: Dict[str, Any]) -> Dict[str, int]:
    faults.point("ckpt.manifest")
    return _atomic_json_write(manifest, meta)


def _flatten(d: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(d, dict):
        for k, v in d.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            out.update(_flatten(v, key))
    else:
        out[prefix] = d
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def _safe(key: str) -> str:
    return key.replace(_SEP, "__").replace("/", "_").replace(" ", "_")


def _leaf(value):
    """(torch tensor or numpy array, manifest dtype name) of a leaf."""
    value = getattr(value, "_value", value)
    if isinstance(value, torch.Tensor):
        name = str(value.dtype).replace("torch.", "")
        return value.detach(), ("bool" if name == "bool" else name)
    arr = np.asarray(value)
    return arr, str(arr.dtype)


def _host(value, snapshot: bool) -> np.ndarray:
    """The leaf's values as the numpy array the shard file holds (a bf16
    tensor as its bytes, JAX's extension-dtype encoding); with
    ``snapshot``, in memory of its own."""
    if isinstance(value, np.ndarray):
        return value.copy() if snapshot else value
    t = value
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    if t.device.type == "cpu":
        arr = t.numpy()
        if snapshot:
            arr = arr.copy()
    else:
        arr = t.cpu().numpy()
    if value.dtype == torch.bfloat16:
        return np.ascontiguousarray(arr).view(np.uint8)
    return arr


def save_state_dict(state_dict: Dict, path: str, async_save: bool = False,
                    process_index: Optional[int] = None) -> "AsyncHandle":
    """Persist a (nested) dict of Tensors, torch tensors and arrays, one
    file per leaf, the manifest last (module docstring)."""
    os.makedirs(path, exist_ok=True)
    pidx = 0 if process_index is None else int(process_index)
    flat = {k: v for k, v in _flatten(state_dict).items() if v is not None}
    meta: Dict[str, Any] = {"leaves": {}, "format": 1}
    writes = []  # (file path, leaf value)
    for key, value in flat.items():
        value, dtype = _leaf(value)
        fname = f"{_safe(key)}.p{pidx}.s0.npy"
        meta["leaves"][key] = {
            "shape": list(value.shape), "dtype": dtype,
            "shards": [{"file": fname,
                        "index": [[0, int(d)] for d in value.shape]}]}
        writes.append((os.path.join(path, fname), value))
    manifest = os.path.join(path, _META if pidx == 0 else f"{_META}.p{pidx}")

    if async_save:
        # host copies first: the next step writes the live cells in place
        snapped = [(f, _host(v, snapshot=True)) for f, v in writes]

        def bg(handle):
            for fname, arr in snapped:
                handle.digests[os.path.basename(fname)] = \
                    _write_shard_file(fname, arr)
            handle.digests[os.path.basename(manifest)] = \
                _write_manifest(manifest, meta)

        return _spawn_async(bg, pass_handle=True)

    out = AsyncHandle(None)
    for fname, value in writes:
        out.digests[os.path.basename(fname)] = _write_shard_file(
            fname, _host(value, snapshot=False))
    out.digests[os.path.basename(manifest)] = _write_manifest(manifest, meta)
    return out


def _spawn_async(fn, pass_handle: bool = False) -> "AsyncHandle":
    """Run ``fn`` on a daemon thread behind an :class:`AsyncHandle` that
    keeps its exception for ``wait()``."""
    handle = AsyncHandle(None)

    def guarded():
        try:
            fn(handle) if pass_handle else fn()
        except BaseException as exc:  # noqa: BLE001 - surfaced at wait()
            handle._error = exc

    t = threading.Thread(target=guarded, daemon=True)
    handle._thread = t
    with _pending_lock:
        _pending.append(handle)
    t.start()
    return handle


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


def _decode(arr: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """A shard file's array as a torch tensor of the manifest's dtype:
    bf16 (or any dtype written as raw bytes) from its ``uint8`` bytes."""
    if arr.dtype == np.uint8 and dtype != "uint8":
        raw = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1))
        return raw.view(_TORCH_DTYPES[dtype]).reshape(tuple(shape))
    return torch.from_numpy(np.ascontiguousarray(arr))


def _load_global(path: str, key: str, entry: Dict, metas: list,
                 device) -> torch.Tensor:
    dtype, shape = entry["dtype"], tuple(entry["shape"])
    shards = list(entry["shards"])
    for m in metas:
        other = m.get("leaves", {}).get(key)
        if other:
            shards += other["shards"]
    seen, parts = set(), []
    for sh in shards:
        if sh["file"] in seen:
            continue
        seen.add(sh["file"])
        arr = np.load(os.path.join(path, sh["file"]), allow_pickle=False)
        index = [tuple(ab) for ab in sh["index"]]
        parts.append((index, _decode(arr, dtype,
                                     [b - a for a, b in index])))
    if len(parts) == 1 and all(a == 0 and b == d for (a, b), d in
                               zip(parts[0][0], shape)):
        return parts[0][1].reshape(shape).to(device)
    out = torch.zeros(shape, dtype=_TORCH_DTYPES[dtype])
    filled = torch.zeros(shape, dtype=torch.bool)
    for index, part in parts:
        idx = tuple(slice(a, b) for a, b in index)
        out[idx] = part
        filled[idx] = True
    if shape and not bool(filled.all()):
        raise ValueError(
            f"checkpoint leaf '{key}' is missing shards (holes in the "
            f"global array): was a multi-host save only partially copied?")
    return out.to(device)


def load_state_dict(path: str, device=None) -> Dict:
    """Reassemble every leaf as a Tensor on ``device`` (the card unless
    told otherwise); nested keys come back nested."""
    dev = resolve_device(device)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    other_metas = []
    for fname in sorted(os.listdir(path)):
        if fname.startswith(_META + ".p"):
            with open(os.path.join(path, fname)) as f:
                other_metas.append(json.load(f))
    out_flat = {key: Tensor(_load_global(path, key, entry, other_metas, dev),
                            stop_gradient=True)
                for key, entry in meta["leaves"].items()}
    return _unflatten(out_flat)


class AsyncHandle:
    """Join handle of an async save. :meth:`wait` re-raises the writer
    thread's exception; :meth:`done` is True only for a successful
    finish, :meth:`failed` for a crashed one. ``digests`` holds each
    written file's ``{"size", "crc32"}`` once the writer is done."""

    def __init__(self, thread: Optional[threading.Thread] = None):
        self._thread = thread
        self._error: Optional[BaseException] = None
        self.digests: Dict[str, Dict[str, int]] = {}

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        with _pending_lock:
            if self in _pending:
                _pending.remove(self)
        if self._error is not None:
            raise self._error

    def done(self) -> bool:
        if self._thread is not None and self._thread.is_alive():
            return False
        return self._error is None

    def failed(self) -> bool:
        if self._thread is not None and self._thread.is_alive():
            return False
        return self._error is not None


def wait():
    """Join every outstanding async save. One failure re-raises itself;
    several raise one :class:`CheckpointError` carrying them all."""
    with _pending_lock:
        pending = list(_pending)
    errors = []
    for h in pending:
        try:
            h.wait()
        except BaseException as exc:  # noqa: BLE001 - aggregated below
            if not any(exc is e for e in errors):
                errors.append(exc)
    if len(errors) == 1:
        raise errors[0]
    if errors:
        raise CheckpointError(
            f"{len(errors)} async checkpoint saves failed: "
            + "; ".join(f"{type(e).__name__}: {e}" for e in errors),
            errors=errors)
