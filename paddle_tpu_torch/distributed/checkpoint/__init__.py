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

Several processes write one checkpoint as the JAX package's do: each
rank writes the blocks it owns, replica 0 of each, with their global
``index`` (``<key>.p<rank>.s<i>.npy``), then its manifest (rank 0
``checkpoint.metadata.json``, rank r ``checkpoint.metadata.json.p<r>``).
A leaf is sharded when it is a :class:`ShardedLeaf` (ZeRO's slices,
``distributed/sharding.py``; a pipeline stage's rows of a stacked
``[L, ...]`` parameter, ``fleet/pipeline_schedule.py``) or a DTensor
(``sharding_api.shard_tensor``, its block and replica from its mesh and
placements); any other tensor is replicated, written by process 0 alone.

:func:`load_state_dict` merges every manifest and gives each rank the
block its placement asks for, from ``shardings=`` (flat or nested: a
``(ProcessMesh or Mesh, [Shard/Replicate, ...])`` pair, a DTensor, or a
:class:`ShardedLeaf` such as ``sharding.zero_placement``'s) or
``target=`` (a state dict whose values carry their placement), reading
only the shard files that overlap that block; a block any part of which
no shard covers is refused with the JAX package's "holes" message. A
leaf without a placement comes back whole.

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
    "ShardedLeaf", "wait",
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


class ShardedLeaf:
    """This rank's block of a global tensor of shape ``shape``: ``local``
    holds the block ``index`` (``[[start, stop], ...]`` a dim) and
    ``replica`` says which copy of it this rank has (0 writes it). With
    ``local=None`` it is a placement: the block a load should give."""

    def __init__(self, local, shape, index, replica: int = 0):
        self.local = local
        self.shape = tuple(int(d) for d in shape)
        self.index = [[int(a), int(b)] for a, b in index]
        self.replica = int(replica)

    @property
    def dtype(self):
        return getattr(self.local, "dtype", None)

    def __repr__(self):
        return (f"ShardedLeaf(shape={self.shape}, index={self.index}, "
                f"replica={self.replica})")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _dtensor(value):
    """``value``'s DTensor (a port Tensor's too), or None."""
    v = getattr(value, "_value", value)
    return v if hasattr(v, "to_local") and hasattr(v, "placements") \
        else None


def _dtensor_block(shape, mesh, placements):
    """(index, replica) of this rank's block of a DTensor of global
    ``shape`` over ``mesh`` (a ``DeviceMesh``) with torch placements."""
    from torch.distributed.tensor import Shard as TS
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)
    coord = mesh.get_coordinate()
    replica = 0
    for i, pl in enumerate(placements):
        if not isinstance(pl, TS) and coord[i] != 0:
            replica = 1
    return [[o, o + n] for o, n in zip(offset, local)], replica


def _records(value):
    """``(shape, dtype name, [(index, data), ...])``: the blocks of a
    leaf this process writes (module docstring)."""
    if isinstance(value, ShardedLeaf):
        data = value.local.detach() if isinstance(value.local, torch.Tensor) \
            else np.asarray(value.local)
        dtype = _dtype_name(data) if isinstance(data, torch.Tensor) \
            else str(data.dtype)
        return value.shape, dtype, ([(value.index, data)]
                                    if value.replica == 0 else [])
    dt = _dtensor(value)
    if dt is not None:
        index, replica = _dtensor_block(dt.shape, dt.device_mesh,
                                        dt.placements)
        local = dt.to_local().detach()
        return (tuple(dt.shape), _dtype_name(local),
                [(index, local)] if replica == 0 else [])
    value = getattr(value, "_value", value)
    if isinstance(value, torch.Tensor):
        data, dtype = value.detach(), _dtype_name(value)
    else:
        data = np.asarray(value)
        dtype = str(data.dtype)
    return tuple(data.shape), dtype, [([[0, int(d)] for d in data.shape],
                                       data)]


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


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
    """Persist a (nested) dict of Tensors, torch tensors, arrays,
    :class:`ShardedLeaf`s and DTensors: this process's blocks (module
    docstring), one file each, then its manifest. ``process_index``
    defaults to the rank in the ``torch.distributed`` job, else 0."""
    os.makedirs(path, exist_ok=True)
    pidx = _process_index() if process_index is None else int(process_index)
    flat = {k: v for k, v in _flatten(state_dict).items() if v is not None}
    meta: Dict[str, Any] = {"leaves": {}, "format": 1}
    writes = []  # (file path, block value)
    for key, value in flat.items():
        shape, dtype, blocks = _records(value)
        if not isinstance(value, ShardedLeaf) and _dtensor(value) is None \
                and pidx != 0:
            blocks = []  # a replicated leaf: process 0 writes it
        entry = {"shape": list(shape), "dtype": dtype, "shards": []}
        for i, (index, data) in enumerate(blocks):
            fname = f"{_safe(key)}.p{pidx}.s{i}.npy"
            entry["shards"].append({"file": fname, "index": index})
            writes.append((os.path.join(path, fname), data))
        meta["leaves"][key] = entry
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


def _read(path: str, fname: str, dtype: str, index, want):
    """Rows ``want`` (slices, relative to the shard) of one shard file as
    a CPU tensor of ``dtype``; memory-mapped, so only they are read. bf16
    (or any dtype written as raw bytes) is decoded from its ``uint8``
    bytes."""
    arr = np.load(os.path.join(path, fname), mmap_mode="r",
                  allow_pickle=False)
    shape = tuple(b - a for a, b in index)
    if arr.dtype == np.uint8 and dtype != "uint8":
        width = torch.empty((), dtype=_TORCH_DTYPES[dtype]).element_size()
        arr = arr.reshape(-1).view({1: np.uint8, 2: np.int16,
                                    4: np.int32, 8: np.int64}[width])
        part = np.array(arr.reshape(shape)[want])  # a copy; 0-d stays 0-d
        return torch.from_numpy(part).view(_TORCH_DTYPES[dtype])
    return torch.from_numpy(np.array(arr.reshape(shape)[want]))


def _overlap(a, b):
    """The intersection of two index boxes, or None."""
    box = [[max(x0, y0), min(x1, y1)] for (x0, x1), (y0, y1) in zip(a, b)]
    return box if all(lo < hi for lo, hi in box) or not box else None


def _volume(box) -> int:
    return int(np.prod([hi - lo for lo, hi in box])) if box else 1


def _load_block(path: str, key: str, entry: Dict, metas: list,
                block) -> torch.Tensor:
    """The ``block`` (index box; the whole leaf when None) of a leaf, on
    the CPU, from the shard files that overlap it (every manifest's);
    refuses a block some part of which no shard covers."""
    dtype, shape = entry["dtype"], tuple(entry["shape"])
    block = [[0, d] for d in shape] if block is None else block
    shards = list(entry["shards"])
    for m in metas:
        other = m.get("leaves", {}).get(key)
        if other:
            shards += other["shards"]
    parts, seen = [], set()
    for sh in shards:
        box = _overlap(sh["index"], block)
        key_box = json.dumps(sh["index"])
        if box is None or key_box in seen:
            continue  # not this rank's, or a copy of a block already read
        seen.add(key_box)
        parts.append((sh, box))
    bshape = tuple(b - a for a, b in block)
    covered = sum(_volume(box) for _, box in parts)
    disjoint = all(_overlap(x, y) is None for i, (_, x) in enumerate(parts)
                   for _, y in parts[i + 1:])
    if len(parts) == 1 and parts[0][1] == block == parts[0][0]["index"]:
        sh = parts[0][0]
        return _read(path, sh["file"], dtype, sh["index"],
                     tuple(slice(None) for _ in shape))
    out = torch.zeros(bshape, dtype=_TORCH_DTYPES[dtype])
    filled = None if disjoint else torch.zeros(bshape, dtype=torch.bool)
    for sh, box in parts:
        src = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _)
                    in zip(box, sh["index"]))
        dst = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _)
                    in zip(box, block))
        out[dst] = _read(path, sh["file"], dtype, sh["index"], src)
        if filled is not None:
            filled[dst] = True
    holes = (covered != _volume(block)) if disjoint \
        else not bool(filled.all())
    if shape and holes:
        raise ValueError(
            f"checkpoint leaf '{key}' is missing shards (holes in the "
            f"global array): was a multi-host save only partially copied?")
    return out


def _torch_placements(placements, mesh, ndim: int):
    from .. import sharding_api

    pm = sharding_api._process_mesh(mesh)
    return pm.device_mesh, sharding_api._torch_placements(
        placements, None, pm, ndim)


def _placement(place, shape):
    """``(block index or None, wrap)``: what a placement asks of a leaf
    of global ``shape`` and how the block is handed back."""
    if place is None:
        return None, lambda t: Tensor(t, stop_gradient=True)
    if isinstance(place, ShardedLeaf):
        return place.index, lambda t: ShardedLeaf(t, shape, place.index,
                                                  place.replica)
    dt = _dtensor(place)
    if dt is not None:
        mesh, tps = dt.device_mesh, dt.placements
    elif isinstance(place, (tuple, list)) and len(place) == 2:
        mesh, tps = _torch_placements(place[1], place[0], len(shape))
    else:
        raise TypeError(f"unknown placement {place!r}: a (mesh, "
                        "placements) pair, a DTensor or a ShardedLeaf")
    index, _ = _dtensor_block(shape, mesh, tps)

    def wrap(t):
        from torch.distributed.tensor import DTensor

        return Tensor._wrap(DTensor.from_local(
            t, mesh, tps, run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride()))

    return index, wrap


def load_state_dict(path: str, shardings: Optional[Dict] = None,
                    target: Optional[Dict] = None, device=None) -> Dict:
    """Every leaf of the checkpoint at ``path``, the block its placement
    asks for (``shardings`` or ``target``, module docstring) on
    ``device`` (the card unless told otherwise); nested keys come back
    nested."""
    dev = resolve_device(device)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    other_metas = []
    for fname in sorted(os.listdir(path)):
        if fname.startswith(_META + ".p"):
            with open(os.path.join(path, fname)) as f:
                other_metas.append(json.load(f))
    places = _flatten(shardings) if shardings else {}
    if not shardings and target is not None:
        places = {k: v for k, v in _flatten(target).items()
                  if isinstance(v, ShardedLeaf) or _dtensor(v) is not None}
    out_flat = {}
    for key, entry in meta["leaves"].items():
        index, wrap = _placement(places.get(key), tuple(entry["shape"]))
        out_flat[key] = wrap(_load_block(path, key, entry, other_metas,
                                         index).to(dev))
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
