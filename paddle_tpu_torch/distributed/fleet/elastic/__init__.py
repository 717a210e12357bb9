"""Elastic training: node registry, heartbeat, scale-event watch, relaunch
(``paddle_tpu/distributed/fleet/elastic/__init__.py``).

Reference parity: ``ElasticManager``
(python/paddle/distributed/fleet/elastic/manager.py:124) — etcd node
registry with lease heartbeats, a watch loop that detects scale-in/out
(:120), env rewrite + trainer relaunch with ``ELASTIC_EXIT_CODE`` (:30).

As in the JAX package, the registry is a pluggable KV store: the
default ``FileStore`` keeps per-node heartbeat files on a shared
filesystem (under the temporary directory unless
``PADDLE_ELASTIC_DIR`` names one). On a scale event the manager
rewrites ``PADDLE_TRAINERS_NUM``/endpoints and a trainer exits with code
101: the launcher (``distributed/launch``, ``--nnodes N:M``) relaunches
the job at the registry's node count with a fresh ``torch.distributed``
rendezvous store, without using up a ``--max_restarts`` restart.
"""
from __future__ import annotations

import json
import os
import socket
import tempfile
import threading
import time
from typing import List, Optional

__all__ = ["ELASTIC_EXIT_CODE", "ELASTIC_AUTO_PARALLEL_EXIT_CODE",
           "ElasticStatus", "ElasticManager", "FileStore"]

ELASTIC_EXIT_CODE = 101                 # manager.py:30
ELASTIC_AUTO_PARALLEL_EXIT_CODE = 102   # manager.py:31


class ElasticStatus:
    """reference: manager.py:46."""

    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class FileStore:
    """Shared-filesystem node registry: one ``<host>.json`` heartbeat file
    per node under ``root``; liveness = mtime within ``ttl`` seconds (the
    etcd-lease counterpart)."""

    def __init__(self, root: str, ttl: float = 10.0):
        self.root = root
        self.ttl = ttl
        os.makedirs(root, exist_ok=True)

    def register(self, host: str, info: dict):
        path = os.path.join(self.root, f"{host.replace(':', '_')}.json")
        with open(path, "w") as f:
            json.dump({"host": host, **info, "t": time.time()}, f)

    def heartbeat(self, host: str):
        path = os.path.join(self.root, f"{host.replace(':', '_')}.json")
        try:
            os.utime(path, None)
        except OSError:  # removed under us (cleanup race) — re-register
            self.register(host, {})

    def deregister(self, host: str):
        path = os.path.join(self.root, f"{host.replace(':', '_')}.json")
        try:
            os.remove(path)
        except FileNotFoundError:
            pass

    def hosts(self) -> List[str]:
        now = time.time()
        live = []
        for fn in sorted(os.listdir(self.root)):
            if not fn.endswith(".json"):
                continue
            path = os.path.join(self.root, fn)
            try:
                if now - os.path.getmtime(path) <= self.ttl:
                    with open(path) as f:
                        live.append(json.load(f)["host"])
            except (OSError, ValueError, KeyError):
                continue
        return live


class ElasticManager:
    """reference: manager.py:124.

    ``np`` is the expected node count, ``'N:M'`` for an elastic range
    (min/max). ``watch()`` polls the registry and returns an
    ``ElasticStatus``; the caller (launch CLI / user loop) relaunches on
    RESTART and tears down on EXIT — the reference's controller contract.
    """

    def __init__(self, np: Optional[str] = None, host: Optional[str] = None,
                 store: Optional[FileStore] = None,
                 elastic_dir: Optional[str] = None, ttl: float = 10.0,
                 heartbeat_interval: float = 2.0):
        np = np if np is not None else os.environ.get("PADDLE_ELASTIC_NP", "0")
        parts = str(np).split(":")
        self.np_min = int(parts[0] or 0)
        self.np_max = int(parts[-1] or 0) or self.np_min
        self.host = host or os.environ.get(
            "POD_IP", f"{socket.gethostname()}_{os.getpid()}")
        elastic_dir = elastic_dir or os.environ.get(
            "PADDLE_ELASTIC_DIR",
            os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_elastic"))
        self.store = store or FileStore(elastic_dir, ttl=ttl)
        self.enable = self.np_min > 0
        self._hb_interval = heartbeat_interval
        self._stop = threading.Event()
        self._hb_thread = None
        self._last_hosts: Optional[List[str]] = None  # baseline membership
        self._completed = False

    # -- lifecycle -----------------------------------------------------------
    def register(self):
        if not self.enable:
            return
        self.store.register(self.host, {"pid": os.getpid()})
        self._hb_thread = threading.Thread(target=self._beat, daemon=True)
        self._hb_thread.start()
        self._last_hosts = self.hosts()  # membership baseline for watch()

    def _beat(self):
        while not self._stop.wait(self._hb_interval):
            self.store.heartbeat(self.host)

    def exit(self, completed: bool = False):
        """reference: manager.exit — deregister + stop heartbeats."""
        self._completed = completed
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
        if self.enable:
            self.store.deregister(self.host)

    # -- watch ---------------------------------------------------------------
    def hosts(self) -> List[str]:
        return self.store.hosts()

    def watch(self, interval: float = 1.0, timeout: Optional[float] = None):
        """Block until membership changes or the job completes; returns an
        ElasticStatus (reference: manager.py:120 watch loop)."""
        if not self.enable:
            return ElasticStatus.COMPLETED
        deadline = None if timeout is None else time.time() + timeout
        if self._last_hosts is None:  # baseline persists ACROSS watch calls
            self._last_hosts = self.hosts()
        below_quorum = False
        while True:
            if self._completed:
                return ElasticStatus.COMPLETED
            hosts = self.hosts()
            n = len(hosts)
            # the effective set is capped at np_max (the declared range's
            # upper bound): extra joiners beyond it don't re-form the job
            eff = sorted(hosts)[: self.np_max] if self.np_max else hosts
            base = sorted(self._last_hosts)[: self.np_max] \
                if self.np_max else self._last_hosts
            if set(eff) != set(base):
                if n < self.np_min:
                    # below quorum: keep the baseline (so the deficit stays
                    # observable) and poll for rejoin until the deadline —
                    # then EXIT, the reference's teardown path
                    below_quorum = True
                elif self.host not in eff:
                    # scaled past np_max and this node lost the slot race
                    return ElasticStatus.EXIT
                else:
                    self._last_hosts = hosts
                    # quorum intact at a NEW world size: rewrite env, restart
                    self._rewrite_env(eff)
                    return ElasticStatus.RESTART
            else:
                below_quorum = False
            if deadline is not None and time.time() >= deadline:
                return (ElasticStatus.EXIT if below_quorum
                        else ElasticStatus.HOLD)
            time.sleep(interval)

    def _rewrite_env(self, hosts: List[str]):
        """reference: manager._update_endpoint — the relaunched trainer sees
        the new world."""
        os.environ["PADDLE_TRAINERS_NUM"] = str(len(hosts))
        os.environ["PADDLE_TRAINER_ENDPOINTS"] = ",".join(sorted(hosts))
        try:
            os.environ["PADDLE_TRAINER_ID"] = str(
                sorted(hosts).index(self.host))
        except ValueError:
            pass
