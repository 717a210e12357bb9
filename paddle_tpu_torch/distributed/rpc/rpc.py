"""RPC agent: run Python callables on remote workers
(``paddle_tpu/distributed/rpc/rpc.py``).

Reference parity: ``python/paddle/distributed/rpc/rpc.py`` — same public
surface (init_rpc/rpc_sync/rpc_async/shutdown/get_worker_info) and the
same rendezvous contract (TCPStore keyed by rank, barrier before start
and before shutdown, PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM /
PADDLE_WORKER_ENDPOINT / PADDLE_MASTER_ENDPOINT env). The agent itself
is redesigned: where the reference runs a brpc service
(``paddle/fluid/distributed/rpc/rpc_agent.h``), workers here serve
length-prefixed pickled calls over plain TCP; the port's ``TCPStore``
(``distributed/store.py``, on ``torch.distributed.TCPStore``) provides
the rendezvous, and a thread a call runs the incoming calls so
concurrent RPCs don't serialize.

Tensor arguments/results: anything picklable travels. A tensor on the
card in a payload (a torch tensor, or a facade ``Tensor``'s value) is
brought to the host before pickling and arrives as a CPU tensor of the
same dtype, so a worker without a card can read it; the caller moves it
where it wants it.
"""
from __future__ import annotations

import concurrent.futures as _futures
import io
import os
import pickle
import socket
import threading
import time
from collections import namedtuple
from typing import Any, Dict, List, Optional

from .._wire import recv_msg as _recv_msg
from .._wire import send_msg as _send_msg
from ..store import TCPStore


def _host_copy(t):
    return t


class _Pickler(pickle.Pickler):
    """Pickles a tensor that lies on a device as its host copy."""

    def reducer_override(self, obj):
        import torch

        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return _host_copy, (obj.detach().cpu(),)
        return NotImplemented


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()

WorkerInfo = namedtuple("WorkerInfo", ["name", "rank", "ip", "port"])

_DEFAULT_RPC_TIMEOUT = -1

_agent: Optional["_RpcAgent"] = None
_store: Optional[TCPStore] = None
_barrier_count = 0


class FutureWrapper:
    """Handle returned by :func:`rpc_async`; ``wait()`` yields the result
    (re-raising any remote exception)."""

    def __init__(self, fut: _futures.Future):
        self._fut = fut

    def wait(self) -> Any:
        return self._fut.result()


class _RpcAgent:
    def __init__(self, name: str, rank: int, ip: str, port: int):
        self.name, self.rank = name, rank
        self.ip, self.port = ip, port
        self.workers: Dict[str, WorkerInfo] = {}
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # bind only the advertised interface: the handler runs pickled
        # callables, so don't listen wider than the endpoint contract
        self._sock.bind((ip, port))
        # port 0: the one the OS gave (no window for another process to
        # take a port picked and released before this bind)
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"rpc-agent-{name}")
        self._thread.start()

    # -- server side --------------------------------------------------------
    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            # daemon handler threads: a handler parked in recv must never
            # block interpreter exit (executor threads are joined atexit)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()
        self._sock.close()

    def _handle(self, conn: socket.socket) -> None:
        try:
            with conn:
                req = pickle.loads(_recv_msg(conn))
                try:
                    fn, args, kwargs = req
                    result = (True, fn(*args, **kwargs))
                except Exception as e:  # travel back to the caller
                    result = (False, e)
                try:
                    payload = _dumps(result)
                except Exception as e:
                    # unpicklable return/exception: the caller still gets
                    # a real error instead of a dead connection
                    payload = pickle.dumps(
                        (False, RuntimeError(
                            f"rpc result not picklable: {e!r} "
                            f"(result was {type(result[1]).__name__})")))
                _send_msg(conn, payload)
        except (ConnectionError, OSError):
            pass  # caller went away mid-call

    # -- client side --------------------------------------------------------
    def invoke(self, to: str, fn, args, kwargs,
               timeout: float) -> FutureWrapper:
        if to not in self.workers:
            raise ValueError(f"unknown rpc worker {to!r}; known: "
                             f"{sorted(self.workers)}")
        info = self.workers[to]
        payload = _dumps((fn, args, kwargs))

        fut: _futures.Future = _futures.Future()

        def call():
            try:
                with socket.create_connection((info.ip, info.port),
                                              timeout=None if timeout <= 0
                                              else timeout) as conn:
                    if timeout > 0:
                        conn.settimeout(timeout)
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    _send_msg(conn, payload)
                    ok, value = pickle.loads(_recv_msg(conn))
                if not ok:
                    fut.set_exception(value)
                else:
                    fut.set_result(value)
            except BaseException as e:
                fut.set_exception(e)

        threading.Thread(target=call, daemon=True).start()
        return FutureWrapper(fut)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _host_ip() -> str:
    return os.environ.get("POD_IP", "127.0.0.1")


def _store_barrier(rank: int, world_size: int) -> None:
    """All workers rendezvous on a unique counter key; everyone leaves only
    once the counter reaches world_size (reference: _barrier_never_timeout)."""
    global _barrier_count
    key = f"rpc/barrier/{_barrier_count}"
    _barrier_count += 1
    if world_size < 2:
        return
    arrived = _store.add(key, 1)
    if arrived == world_size:
        _store.set(key + "/done", b"1")
    _store.wait([key + "/done"], timeout=3600.0)


def init_rpc(name: str, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None) -> None:
    """Start this process's RPC agent and rendezvous with all workers.

    Worker identity comes from args or the PADDLE_TRAINER_ID /
    PADDLE_TRAINERS_NUM / PADDLE_MASTER_ENDPOINT env contract (set by
    ``distributed.launch``).
    """
    global _agent, _store
    if _agent is not None:
        raise RuntimeError("init_rpc called twice (agent already running); "
                           "call rpc.shutdown() first")
    rank = int(os.environ["PADDLE_TRAINER_ID"]) if rank is None else rank
    world_size = (int(os.environ["PADDLE_TRAINERS_NUM"])
                  if world_size is None else world_size)
    endpoint = os.environ.get("PADDLE_WORKER_ENDPOINT")
    if endpoint is None:
        endpoint = f"{_host_ip()}:0"
    master_endpoint = (master_endpoint if master_endpoint is not None
                       else os.environ["PADDLE_MASTER_ENDPOINT"])
    master_ip, master_port = master_endpoint.rsplit(":", 1)
    timeout = float(os.environ.get("FLAGS_stop_check_timeout", "900"))
    _store = TCPStore(master_ip, int(master_port), is_master=(rank == 0),
                      world_size=world_size, timeout=timeout)

    ip, port = endpoint.rsplit(":", 1)
    agent = _RpcAgent(name, rank, ip, int(port))
    _store.set(f"rpc/worker/{rank}",
               pickle.dumps(WorkerInfo(name, rank, ip, agent.port)))
    seen = set()
    for r in range(world_size):
        info = pickle.loads(_store.get(f"rpc/worker/{r}"))
        if info.name in seen:
            raise ValueError(f"worker name {info.name!r} is not unique")
        seen.add(info.name)
        agent.workers[info.name] = info
    _agent = agent
    _store_barrier(rank, world_size)  # all agents serving before any call


def _require_agent() -> _RpcAgent:
    if _agent is None:
        raise RuntimeError("rpc is not initialized; call rpc.init_rpc first")
    return _agent


def rpc_sync(to: str, fn, args=None, kwargs=None,
             timeout: float = _DEFAULT_RPC_TIMEOUT) -> Any:
    """Run ``fn(*args, **kwargs)`` on worker ``to`` and block for the
    result. ``timeout<=0`` waits forever."""
    return rpc_async(to, fn, args, kwargs, timeout).wait()


def rpc_async(to: str, fn, args=None, kwargs=None,
              timeout: float = _DEFAULT_RPC_TIMEOUT) -> FutureWrapper:
    """Run ``fn`` on worker ``to`` asynchronously; returns a
    :class:`FutureWrapper` (``.wait()`` for the value)."""
    return _require_agent().invoke(to, fn, args or (), kwargs or {},
                                   float(timeout))


def shutdown() -> None:
    """Block until every worker reaches shutdown, then stop the agent."""
    global _agent, _store
    agent = _require_agent()
    _store_barrier(agent.rank, len(agent.workers))
    # rank 0 hosts the store server: it must outlive everyone's final
    # barrier read, so non-masters disconnect first
    agent.stop()
    if _store is not None:
        if agent.rank == 0:
            time.sleep(0.2)  # let peers finish their final store reads
        _store.stop()
        _store = None
    _agent = None


def get_worker_info(name: str) -> WorkerInfo:
    return _require_agent().workers[name]


def get_all_worker_infos() -> List[WorkerInfo]:
    return sorted(_require_agent().workers.values(), key=lambda w: w.rank)


def get_current_worker_info() -> WorkerInfo:
    a = _require_agent()
    return a.workers[a.name]
