"""PS transport: servers host native tables, clients shard requests
(``paddle_tpu/distributed/ps/service.py``).

Reference parity: ``BrpcPsServer`` / ``BrpcPsClient``
(``paddle/fluid/distributed/ps/service/brpc_ps_server.h``) and the
client-side key sharding the reference does in ``Communicator``. Here
the transport is length-prefixed pickled numpy over TCP (same wire
pattern as ``distributed.rpc``); each request is handled on a
thread pool and lands in the C++ table engine, so concurrent trainers
contend only on the native shard locks, not the GIL-side service loop.

Sharding: sparse keys go to server ``splitmix64(key) % num_servers``
(client-side partition, like the reference's key-hash routing); a dense
table lives wholly on server ``table_id % num_servers``.
"""
from __future__ import annotations

import pickle
import socket
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from .._wire import recv_msg as _recv_msg
from .._wire import send_msg as _send_msg
from .table import DenseTable, SparseTable, TableConfig

__all__ = ["PSServer", "PSClient"]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class PSServer:
    """Hosts one shard of every table; run one per server endpoint."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        # loopback by default: requests are pickled (arbitrary code on
        # load), so multi-host deployments must opt in by passing the
        # node's fabric IP explicitly
        self._tables_sparse: Dict[int, SparseTable] = {}
        self._tables_dense: Dict[int, DenseTable] = {}
        # geo deltas are read-modify-write on the dense block; handler
        # threads must serialize them (native push/pull lock per-call only)
        self._geo_lock = threading.Lock()
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"ps-server-{self.port}")
        self._thread.start()

    # -- request handlers ----------------------------------------------------
    def _dispatch(self, op: str, args: tuple):
        if op == "create_sparse":
            tid, cfg = args
            with self._geo_lock:  # create-or-join must be atomic across
                if tid not in self._tables_sparse:  # handler threads
                    self._tables_sparse[tid] = SparseTable(cfg)
            return None
        if op == "create_dense":
            tid, size, cfg, init = args
            with self._geo_lock:
                if tid not in self._tables_dense:
                    t = DenseTable(size, cfg)
                    if init is not None:
                        t.set(init)
                    self._tables_dense[tid] = t
            return None
        if op == "pull_sparse":
            tid, keys = args
            return self._tables_sparse[tid].pull(keys)
        if op == "push_sparse":
            tid, keys, grads = args
            self._tables_sparse[tid].push(keys, grads)
            return None
        if op == "pull_dense":
            (tid,) = args
            return self._tables_dense[tid].pull()
        if op == "push_dense":
            tid, grad = args
            self._tables_dense[tid].push(grad)
            return None
        if op == "geo_push_dense":
            # geo-SGD: add the trainer's local delta and return the merged
            # global value in one atomic round trip (reference:
            # communicator.h GeoCommunicator's SendDense/RecvDense pair)
            tid, delta = args
            with self._geo_lock:
                t = self._tables_dense[tid]
                merged = t.pull() + np.asarray(delta, dtype=np.float32)
                t.set(merged)
            return merged
        if op == "set_dense":
            tid, vals = args
            self._tables_dense[tid].set(vals)
            return None
        if op == "sparse_size":
            (tid,) = args
            return len(self._tables_sparse[tid])
        if op == "save_sparse":
            tid, path = args
            self._tables_sparse[tid].save(path)
            return None
        if op == "load_sparse":
            tid, path = args
            self._tables_sparse[tid].load(path)
            return None
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown ps op {op!r}")

    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            # daemon threads: a handler parked in recv on a persistent
            # trainer connection must never block interpreter exit
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()
        self._sock.close()

    def _handle(self, conn: socket.socket) -> None:
        # persistent connection: one trainer keeps a socket open and
        # streams requests over it
        try:
            with conn:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                while not self._stop.is_set():
                    op, args = pickle.loads(_recv_msg(conn))
                    try:
                        reply = (True, self._dispatch(op, args))
                    except Exception as e:
                        reply = (False, e)
                    _send_msg(conn, pickle.dumps(reply))
        except (ConnectionError, OSError, EOFError):
            pass

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


class PSClient:
    """Trainer-side handle: shards sparse keys across servers, routes
    dense tables, and exposes the reference's pull/push verbs."""

    def __init__(self, endpoints: Sequence[str], timeout: float = 60.0):
        self._endpoints = list(endpoints)
        self._conns: List[socket.socket] = []
        self._locks = [threading.Lock() for _ in self._endpoints]
        self._sparse_dims: Dict[int, int] = {}
        for ep in self._endpoints:
            host, port = ep.rsplit(":", 1)
            conn = socket.create_connection((host, int(port)), timeout=timeout)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)

    @property
    def num_servers(self) -> int:
        return len(self._conns)

    def _call(self, server: int, op: str, *args):
        with self._locks[server]:
            conn = self._conns[server]
            _send_msg(conn, pickle.dumps((op, args)))
            ok, value = pickle.loads(_recv_msg(conn))
        if not ok:
            raise value
        return value

    def _call_all(self, op: str, *args) -> list:
        return [self._call(s, op, *args) for s in range(self.num_servers)]

    # -- table management ----------------------------------------------------
    def create_sparse_table(self, table_id: int, config: TableConfig) -> None:
        self._call_all("create_sparse", table_id, config)
        self._sparse_dims[table_id] = config.dim

    def create_dense_table(self, table_id: int, size: int,
                           config: Optional[TableConfig] = None,
                           init: Optional[np.ndarray] = None) -> None:
        self._call(table_id % self.num_servers, "create_dense", table_id,
                   size, config or TableConfig(), init)

    # -- sparse --------------------------------------------------------------
    def _partition(self, keys: np.ndarray):
        keys = np.ascontiguousarray(keys, dtype=np.uint64).ravel()
        owner = (_splitmix64(keys) % np.uint64(self.num_servers)).astype(
            np.int64)
        return keys, owner

    def pull_sparse(self, table_id: int, keys: np.ndarray) -> np.ndarray:
        keys, owner = self._partition(keys)
        if keys.size == 0:  # ragged last batch / empty feature slot
            dim = self._sparse_dims.get(table_id)
            if dim is None:
                raise ValueError(
                    f"pull_sparse({table_id}) with zero keys on a client "
                    "that did not create the table (row width unknown)")
            return np.empty((0, dim), dtype=np.float32)
        out: Optional[np.ndarray] = None
        for s in range(self.num_servers):
            idx = np.nonzero(owner == s)[0]
            if idx.size == 0:
                continue
            vals = self._call(s, "pull_sparse", table_id, keys[idx])
            if out is None:
                out = np.empty((keys.size, vals.shape[1]), dtype=np.float32)
            out[idx] = vals
        return out

    def push_sparse(self, table_id: int, keys: np.ndarray,
                    grads: np.ndarray) -> None:
        keys, owner = self._partition(keys)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        for s in range(self.num_servers):
            idx = np.nonzero(owner == s)[0]
            if idx.size:
                self._call(s, "push_sparse", table_id, keys[idx], grads[idx])

    def sparse_size(self, table_id: int) -> int:
        return sum(self._call_all("sparse_size", table_id))

    def save_sparse(self, table_id: int, path_prefix: str) -> None:
        for s in range(self.num_servers):
            self._call(s, "save_sparse", table_id, f"{path_prefix}.shard{s}")

    def load_sparse(self, table_id: int, path_prefix: str) -> None:
        for s in range(self.num_servers):
            self._call(s, "load_sparse", table_id, f"{path_prefix}.shard{s}")

    # -- dense ---------------------------------------------------------------
    def pull_dense(self, table_id: int) -> np.ndarray:
        return self._call(table_id % self.num_servers, "pull_dense", table_id)

    def push_dense(self, table_id: int, grad: np.ndarray) -> None:
        self._call(table_id % self.num_servers, "push_dense", table_id, grad)

    def geo_push_dense(self, table_id: int, delta: np.ndarray) -> np.ndarray:
        """Add a geo delta server-side; returns the merged global value."""
        return self._call(table_id % self.num_servers, "geo_push_dense",
                          table_id, np.ascontiguousarray(delta, np.float32))

    def set_dense(self, table_id: int, values: np.ndarray) -> None:
        self._call(table_id % self.num_servers, "set_dense", table_id, values)

    def ping(self) -> bool:
        return all(v == "pong" for v in self._call_all("ping"))

    def close(self) -> None:
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._conns = []
