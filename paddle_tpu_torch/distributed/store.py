"""TCPStore: the key-value rendezvous over TCP
(``paddle_tpu/distributed/store.py``).

The JAX package's store is a native library; the port's is
``torch.distributed.TCPStore`` behind the same API and errors: rank 0
hosts the server in-process, every rank connects a client, ``get``
blocks until the key appears, and a timeout raises ``TimeoutError``. A
counter made by ``add`` reads back as its decimal bytes, as there.
"""
from __future__ import annotations

import datetime
from typing import Iterable, Optional

__all__ = ["TCPStore"]


def _delta(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


class TCPStore:
    """KV store for process-group bootstrap.

    Args:
        host: server address (rank-0's host).
        port: server port.
        is_master: when True, host the server in this process.
        world_size: recorded for introspection; not enforced by the store.
        timeout: default client/blocking-get timeout in seconds.
    """

    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: int = 1, timeout: float = 300.0):
        import torch.distributed as dist

        self.host, self.port = host, int(port)
        self.world_size = world_size
        self.timeout = float(timeout)
        self.is_master = bool(is_master)
        try:
            self._store = dist.TCPStore(
                "127.0.0.1" if is_master else host, self.port,
                is_master=self.is_master, timeout=_delta(self.timeout),
                wait_for_workers=False)
        except RuntimeError as e:  # DistNetworkError and its kin
            if is_master:
                raise RuntimeError(
                    f"TCPStore: could not bind server on port {self.port}"
                ) from e
            raise RuntimeError(
                f"TCPStore: could not connect to {host}:{self.port} "
                f"within {self.timeout:.0f}s") from e

    @property
    def store(self):
        """The ``torch.distributed.TCPStore`` (for ``init_process_group``)."""
        if self._store is None:
            raise RuntimeError("TCPStore: stopped")
        return self._store

    # -- reference TCPStore methods ----------------------------------------
    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        elif isinstance(value, int):
            value = str(value).encode()
        self.store.set(key, bytes(value))

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        t = self.timeout if timeout is None else float(timeout)
        try:
            self.store.wait([key], _delta(t))
        except RuntimeError as e:
            raise TimeoutError(f"TCPStore.get({key!r}): no value within "
                               f"{t:.0f}s") from e
        return bytes(self.store.get(key))

    def add(self, key: str, amount: int) -> int:
        return int(self.store.add(key, int(amount)))

    def wait(self, keys: Iterable[str] | str,
             timeout: Optional[float] = None) -> None:
        if isinstance(keys, str):
            keys = [keys]
        t = self.timeout if timeout is None else float(timeout)
        for key in keys:
            try:
                self.store.wait([key], _delta(t))
            except RuntimeError as e:
                raise TimeoutError(f"TCPStore.wait: key {key!r} absent "
                                   f"after {t:.0f}s") from e

    def check(self, keys: Iterable[str] | str) -> bool:
        if isinstance(keys, str):
            keys = [keys]
        return bool(self.store.check(list(keys)))

    def stop(self) -> None:
        """Drop the client and, on the master, the server."""
        self._store = None
