"""``paddle.distributed.spawn``: run a function in ``nprocs`` processes
(``paddle_tpu/distributed/spawn.py``).

Each process is started by ``torch.multiprocessing``'s spawn context with
the launch contract in its environment (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER_ENDPOINT``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINER_ENDPOINTS``), so
``init_parallel_env`` and ``TCPStore`` bootstrap as under ``launch``.
Unless ``master`` is given, the parent serves the job's rendezvous
store on a port the OS picks as it binds (``parallel.host_store``) and
holds it until the join, so two jobs started at once never race for a
port.
:class:`MultiprocessContext` joins them: the first worker to fail ends
the others, and its traceback is raised in the parent. Workers run on the
card, rank ``r`` on ``cuda:r % device_count``, like every entry point of
the port; ``backend="cpu"`` runs them on the CPU (``set_device("cpu")``).
"""
from __future__ import annotations

import os
import queue as _queue
import socket
import time
import traceback
from typing import Optional, Tuple

__all__ = ["spawn", "MultiprocessContext"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _worker(func, args, rank: int, env: dict, device: str,
            error_queue, return_queue) -> None:
    os.environ.update(env)
    try:
        import torch

        from ..device import set_device

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        set_device(dev)
        ret = func(*args)
        return_queue.put((rank, ret))
    except KeyboardInterrupt:
        pass
    except BaseException:
        error_queue.put((rank, traceback.format_exc()))
        raise SystemExit(1)


class MultiprocessContext:
    """Join handle for spawned workers (reference: spawn.py:360)."""

    def __init__(self, processes, error_queues, return_queues,
                 store=None):
        self.processes = processes
        # the job's rendezvous server, when the parent hosts it
        self.store = store
        self.error_queues = error_queues
        self.return_queues = return_queues
        self._results: dict = {}

    def _drain(self) -> None:
        while True:
            try:
                rank, ret = self.return_queues.get_nowait()
            except _queue.Empty:
                return
            self._results[rank] = ret

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for every worker, reading their results as they come (a
        large result never blocks its sender). A worker that fails ends
        the others and raises ``RuntimeError`` with its traceback; past
        ``timeout`` seconds the workers are ended and ``TimeoutError``
        raised."""
        t0 = time.monotonic()
        while True:
            self._drain()
            codes = [p.exitcode for p in self.processes]
            failed = [(i, c) for i, c in enumerate(codes)
                      if c not in (0, None)]
            if failed:
                self._end()
                msgs = []
                while True:
                    try:  # the failed worker's traceback, if it sent one
                        rank, tb = self.error_queues.get(
                            timeout=0.0 if msgs else 1.0)
                    except _queue.Empty:
                        break
                    msgs.append(f"---- rank {rank} ----\n{tb}")
                raise RuntimeError(
                    "spawned process(es) failed "
                    f"{[f'rank {i} exit {c}' for i, c in failed]}\n"
                    + "\n".join(msgs))
            if all(c == 0 for c in codes):
                self._drain()
                self.store = None
                return True
            if timeout is not None and time.monotonic() - t0 > timeout:
                self._end()
                raise TimeoutError(f"spawned processes still running after "
                                   f"{timeout:.0f}s; ended them")
            time.sleep(0.05)

    def _end(self) -> None:
        self.store = None
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        for p in self.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()

    def results(self) -> dict:
        self._drain()
        return dict(self._results)


def spawn(func, args: Tuple = (), nprocs: int = 1, join: bool = True,
          daemon: bool = False, **options):
    """Launch ``func(*args)`` in ``nprocs`` processes with the trainer
    environment set. Options: ``master`` (``"ip:port"``, default localhost
    and a free port), ``backend`` (``"cpu"``: the workers run on the CPU;
    anything else, the default: on the card, rank ``r`` on ``cuda:r %
    device_count``, and ``RuntimeError`` without one)."""
    import torch
    import torch.multiprocessing as mp

    if nprocs < 1:
        raise ValueError("nprocs must be >= 1")
    store = None
    master = options.get("master")
    if master is None:
        from .parallel import host_store

        store = host_store(nprocs)
        master = f"127.0.0.1:{store.port}"
    if options.get("backend") == "cpu":
        devices = ["cpu"] * nprocs
    elif torch.cuda.is_available():
        devices = [f"cuda:{r % torch.cuda.device_count()}"
                   for r in range(nprocs)]
    else:
        raise RuntimeError(
            "spawn: the workers run on a CUDA device and none is available; "
            "pass backend='cpu' to run them on the CPU")
    ctx = mp.get_context("spawn")
    error_queue = ctx.Queue()
    return_queue = ctx.Queue()
    endpoints = [f"127.0.0.1:{_free_port()}" for _ in range(nprocs)]
    addr, port = master.rsplit(":", 1)
    processes = []
    for rank in range(nprocs):
        env = {
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_LOCAL_RANK": str(rank),
            "PADDLE_MASTER_ENDPOINT": master,
            "MASTER_ADDR": addr,
            "MASTER_PORT": port,
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_WORKER_ENDPOINT": endpoints[rank],
        }
        if store is not None:
            env["PADDLE_MASTER_HOSTED"] = "1"
        p = ctx.Process(target=_worker,
                        args=(func, args, rank, env, devices[rank],
                              error_queue, return_queue),
                        daemon=daemon)
        p.start()
        processes.append(p)

    context = MultiprocessContext(processes, error_queue, return_queue,
                                  store)
    if join:
        context.join()
    return context
