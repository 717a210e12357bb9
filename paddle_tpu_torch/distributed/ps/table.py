"""ctypes bindings for the native PS table engine
(``paddle_tpu/distributed/ps/table.py``).

Reference parity: ``paddle/fluid/distributed/ps/table/`` (memory sparse
table + dense table + accessor fused optimizer). The update math runs in
C++ (``paddle_tpu_torch/csrc/ps_table.cc``, the JAX package's source
copied), built at first use with the host compiler into
``build/paddle_tpu_torch/`` (``ops/_build.py`` ``load_host``; a failed
build raises, there is no table in Python to fall back on); these
classes only marshal numpy arrays across the C ABI. The same source and
flags give the JAX package's fresh rows, updates and ``save`` files bit
for bit, so either package loads the other's files.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ...ops._build import load_host

__all__ = ["TableConfig", "SparseTable", "DenseTable", "SSDSparseTable"]

_OPT_KINDS = {"sgd": 0, "adagrad": 1, "adam": 2}

_lib = None


def _native():
    global _lib
    if _lib is None:
        lib = load_host("ps_table")
        u64p = ctypes.POINTER(ctypes.c_uint64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.pd_ps_sparse_create.restype = ctypes.c_void_p
        lib.pd_ps_sparse_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_uint64]
        lib.pd_ps_sparse_free.argtypes = [ctypes.c_void_p]
        lib.pd_ps_sparse_pull.argtypes = [ctypes.c_void_p, u64p,
                                          ctypes.c_int64, f32p]
        lib.pd_ps_sparse_push.argtypes = [ctypes.c_void_p, u64p,
                                          ctypes.c_int64, f32p]
        lib.pd_ps_sparse_size.restype = ctypes.c_int64
        lib.pd_ps_sparse_size.argtypes = [ctypes.c_void_p]
        lib.pd_ps_sparse_save.restype = ctypes.c_int
        lib.pd_ps_sparse_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pd_ps_sparse_load.restype = ctypes.c_int
        lib.pd_ps_sparse_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pd_ps_dense_create.restype = ctypes.c_void_p
        lib.pd_ps_dense_create.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float]
        lib.pd_ps_dense_free.argtypes = [ctypes.c_void_p]
        lib.pd_ps_dense_set.argtypes = [ctypes.c_void_p, f32p]
        lib.pd_ps_dense_pull.argtypes = [ctypes.c_void_p, f32p]
        lib.pd_ps_dense_push.argtypes = [ctypes.c_void_p, f32p]
        lib.pd_ps_dense_size.restype = ctypes.c_int64
        lib.pd_ps_dense_size.argtypes = [ctypes.c_void_p]
        lib.pd_ps_file_create.restype = ctypes.c_void_p
        lib.pd_ps_file_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_int64]
        lib.pd_ps_file_free.argtypes = [ctypes.c_void_p]
        lib.pd_ps_file_pull.argtypes = [ctypes.c_void_p, u64p,
                                        ctypes.c_int64, f32p]
        lib.pd_ps_file_push.argtypes = [ctypes.c_void_p, u64p,
                                        ctypes.c_int64, f32p]
        lib.pd_ps_file_size.restype = ctypes.c_int64
        lib.pd_ps_file_size.argtypes = [ctypes.c_void_p]
        lib.pd_ps_file_mem_rows.restype = ctypes.c_int64
        lib.pd_ps_file_mem_rows.argtypes = [ctypes.c_void_p]
        lib.pd_ps_file_flush.restype = ctypes.c_int
        lib.pd_ps_file_flush.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


@dataclass
class TableConfig:
    """Table hyperparameters (reference: TableParameter in the_one_ps.proto)."""
    dim: int = 8
    optimizer: str = "sgd"
    learning_rate: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    init_range: float = 0.05
    seed: int = 0

    def _opt_kind(self) -> int:
        if self.optimizer not in _OPT_KINDS:
            raise ValueError(f"unknown PS optimizer {self.optimizer!r}; "
                             f"choose from {sorted(_OPT_KINDS)}")
        return _OPT_KINDS[self.optimizer]


class SparseTable:
    """Grow-on-demand embedding table keyed by uint64 ids."""

    def __init__(self, config: TableConfig):
        self.config = config
        self._h = _native().pd_ps_sparse_create(
            config.dim, config._opt_kind(), config.learning_rate,
            config.beta1, config.beta2, config.epsilon, config.init_range,
            config.seed)

    @property
    def dim(self) -> int:
        return self.config.dim

    def pull(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty((keys.size, self.dim), dtype=np.float32)
        _native().pd_ps_sparse_pull(self._h, _u64(keys), keys.size, _f32(out))
        return out

    def push(self, keys: np.ndarray, grads: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        if grads.shape != (keys.size, self.dim):
            raise ValueError(f"push grads shape {grads.shape} != "
                             f"({keys.size}, {self.dim})")
        _native().pd_ps_sparse_push(self._h, _u64(keys), keys.size,
                                    _f32(grads))

    def __len__(self) -> int:
        return int(_native().pd_ps_sparse_size(self._h))

    def save(self, path: str) -> None:
        if _native().pd_ps_sparse_save(self._h, path.encode()) != 0:
            raise IOError(f"SparseTable.save({path!r}) failed")

    def load(self, path: str) -> None:
        if _native().pd_ps_sparse_load(self._h, path.encode()) != 0:
            raise IOError(f"SparseTable.load({path!r}) failed: missing file "
                          "or dim/optimizer mismatch")

    def __del__(self):  # pragma: no cover
        try:
            _native().pd_ps_sparse_free(self._h)
        except Exception:
            pass


class SSDSparseTable:
    """Disk-backed sparse table with a bounded hot-row cache.

    Reference parity: paddle/fluid/distributed/ps/table/ssd_sparse_table.cc
    (RocksDB-backed). Here: a fixed-record file + in-memory index
    (``csrc/ps_table.cc`` FileSparseTable). Rows beyond ``max_mem_rows``
    are evicted to disk; reopening the same path restores the table, so
    embedding tables larger than host RAM and durable across restarts both
    work.
    """

    def __init__(self, config: TableConfig, path: str,
                 max_mem_rows: int = 100_000):
        self.config = config
        self.path = path
        self._h = _native().pd_ps_file_create(
            config.dim, config._opt_kind(), config.learning_rate,
            config.beta1, config.beta2, config.epsilon, config.init_range,
            config.seed, path.encode(), int(max_mem_rows))
        if not self._h:
            raise IOError(f"SSDSparseTable: cannot open {path!r}")

    @property
    def dim(self) -> int:
        return self.config.dim

    def pull(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty((keys.size, self.dim), dtype=np.float32)
        _native().pd_ps_file_pull(self._h, _u64(keys), keys.size, _f32(out))
        return out

    def push(self, keys: np.ndarray, grads: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        if grads.shape != (keys.size, self.dim):
            raise ValueError(f"push grads shape {grads.shape} != "
                             f"({keys.size}, {self.dim})")
        _native().pd_ps_file_push(self._h, _u64(keys), keys.size, _f32(grads))

    def __len__(self) -> int:
        return int(_native().pd_ps_file_size(self._h))

    @property
    def mem_rows(self) -> int:
        return int(_native().pd_ps_file_mem_rows(self._h))

    def flush(self) -> None:
        if _native().pd_ps_file_flush(self._h) != 0:
            raise IOError(f"SSDSparseTable.flush() to {self.path!r} failed")

    def close(self) -> None:
        if self._h:
            _native().pd_ps_file_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class DenseTable:
    """Flat fp32 parameter block with a server-side optimizer."""

    def __init__(self, size: int, config: Optional[TableConfig] = None):
        self.config = config or TableConfig()
        self.size = int(size)
        self._h = _native().pd_ps_dense_create(
            self.size, self.config._opt_kind(), self.config.learning_rate,
            self.config.beta1, self.config.beta2, self.config.epsilon)

    def set(self, values: np.ndarray) -> None:
        values = np.ascontiguousarray(values, dtype=np.float32).ravel()
        if values.size != self.size:
            raise ValueError(f"set size {values.size} != {self.size}")
        _native().pd_ps_dense_set(self._h, _f32(values))

    def pull(self) -> np.ndarray:
        out = np.empty((self.size,), dtype=np.float32)
        _native().pd_ps_dense_pull(self._h, _f32(out))
        return out

    def push(self, grad: np.ndarray) -> None:
        grad = np.ascontiguousarray(grad, dtype=np.float32).ravel()
        if grad.size != self.size:
            raise ValueError(f"push size {grad.size} != {self.size}")
        _native().pd_ps_dense_push(self._h, _f32(grad))

    def __del__(self):  # pragma: no cover
        try:
            _native().pd_ps_dense_free(self._h)
        except Exception:
            pass
