"""Launcher (``paddle_tpu/distributed/launch/main.py``; reference:
launch/main.py:18 and controllers/).

``python -m paddle_tpu_torch.distributed.launch [--nnodes N] [--nproc_per_node P]
[--master HOST:PORT] [--rank R] [--log_dir DIR] [--max_restarts K]
script.py [script args...]``

Env contract written for every worker (consumed by
``distributed.env`` / ``init_parallel_env``):

- ``PADDLE_TRAINER_ID``        global rank
- ``PADDLE_TRAINERS_NUM``      world size
- ``PADDLE_LOCAL_RANK``        rank within this node
- ``PADDLE_TRAINER_ENDPOINTS`` comma list of worker endpoints
- ``PADDLE_CURRENT_ENDPOINT``  this worker's endpoint
- ``MASTER_ADDR`` / ``MASTER_PORT`` the rendezvous address
  (``init_parallel_env``'s ``torch.distributed`` store)

A worker that fails ends the job: the others are terminated and the
launcher exits with its code (``--max_restarts`` relaunches the job that
many times first). The ``ps`` and ``rpc`` modes write their roles'
environment and supervise the processes; their servers are not ported.
Elastic jobs are not ported.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["launch", "main"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="paddle_tpu_torch distributed launcher (collective jobs)")
    p.add_argument("--nnodes", type=str, default="1",
                   help="number of nodes (int, or 'N:M': the lower bound is "
                        "used)")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="workers on this node (default: 1)")
    p.add_argument("--master", type=str, default=None,
                   help="coordination address host:port (default: "
                        "127.0.0.1:<free port> single-node)")
    p.add_argument("--rank", type=int, default=0,
                   help="this node's rank (multi-node)")
    p.add_argument("--log_dir", type=str, default="log",
                   help="per-worker log directory")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="relaunch the job up to K times if a worker fails")
    p.add_argument("--run_mode", type=str, default="collective",
                   help="'collective' (default), 'ps' (parameter-server "
                        "servers+trainers) or 'rpc'")
    p.add_argument("--server_num", type=int, default=None,
                   help="ps mode: number of server processes on this node")
    p.add_argument("--trainer_num", type=int, default=None,
                   help="ps mode: number of trainer processes on this node")
    p.add_argument("--servers", type=str, default="",
                   help="ps mode: comma list of server endpoints")
    p.add_argument("--trainers", type=str, default="",
                   help="ps mode: comma list of trainer endpoints")
    p.add_argument("--devices", "--gpus", type=str, default=None,
                   help="accepted for reference-CLI compat; ranks pick their "
                        "card by PADDLE_LOCAL_RANK")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


class _Worker:
    def __init__(self, proc: subprocess.Popen, rank: int, log_path: str):
        self.proc = proc
        self.rank = rank
        self.log_path = log_path


def _spawn_workers(args, master: str, node_rank: int, nnodes: int,
                   nproc: int) -> List[_Worker]:
    world = nnodes * nproc
    host = master.split(":")[0] if nnodes == 1 else socket.gethostname()
    # endpoint list covers THIS NODE's workers only: peer addresses on other
    # nodes are not knowable without a gather, and inventing them would hand
    # consumers bogus addresses. Cross-host identity comes from MASTER_ADDR +
    # rank/world; single-node jobs still see the full world list (reference
    # behavior).
    local_endpoints = [f"{host}:{_free_port()}" for _ in range(nproc)]
    os.makedirs(args.log_dir, exist_ok=True)
    workers = []
    for local in range(nproc):
        rank = node_rank * nproc + local
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_LOCAL_RANK": str(local),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(local_endpoints),
            "PADDLE_CURRENT_ENDPOINT": local_endpoints[local],
            "MASTER_ADDR": master.split(":")[0],
            "MASTER_PORT": master.split(":")[1],
        })
        log_path = os.path.join(args.log_dir, f"workerlog.{rank}")
        if rank == 0:
            # rank 0 streams to the console (reference behavior)
            proc = subprocess.Popen(
                [sys.executable, "-u", args.training_script]
                + args.training_script_args, env=env)
        else:
            with open(log_path, "w") as out:
                proc = subprocess.Popen(
                    [sys.executable, "-u", args.training_script]
                    + args.training_script_args,
                    env=env, stdout=out, stderr=subprocess.STDOUT)
        workers.append(_Worker(proc, rank, log_path))
    return workers


def _supervise(workers: List[_Worker]) -> int:
    """Wait for all workers; on any failure kill the rest (reference
    controller.watch). Returns the job's exit code."""
    try:
        while True:
            alive = 0
            for w in workers:
                rc = w.proc.poll()
                if rc is None:
                    alive += 1
                elif rc != 0:
                    print(f"[launch] worker {w.rank} failed rc={rc} "
                          f"(log: {w.log_path}); terminating job",
                          file=sys.stderr, flush=True)
                    for o in workers:
                        if o.proc.poll() is None:
                            o.proc.terminate()
                    for o in workers:
                        try:
                            o.proc.wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            o.proc.kill()
                    return rc
            if alive == 0:
                return 0
            time.sleep(0.2)
    except KeyboardInterrupt:
        for w in workers:
            if w.proc.poll() is None:
                w.proc.send_signal(signal.SIGINT)
        for w in workers:
            try:
                w.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                w.proc.kill()  # escalate past SIGINT-masking trainers
                w.proc.wait()
        return 130


def _spawn_role(args, script_env: dict, count: int, role: str, log_dir: str,
                endpoints: List[str], base_rank: int = 0) -> List[_Worker]:
    """Spawn ``count`` processes of one PS role with the reference env
    contract (launch/controllers/ps.py: TRAINING_ROLE, POD_IP, PADDLE_PORT)."""
    os.makedirs(log_dir, exist_ok=True)
    workers = []
    for i in range(count):
        rank = base_rank + i
        ep = endpoints[rank]
        env = dict(script_env)
        env.update({
            "TRAINING_ROLE": role,
            "POD_IP": ep.split(":")[0],
            "PADDLE_PORT": ep.split(":")[1],
            "PADDLE_TRAINER_ID": str(rank),
        })
        log_path = os.path.join(log_dir, f"{role.lower()}log.{rank}")
        with open(log_path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-u", args.training_script]
                + args.training_script_args,
                env=env, stdout=out, stderr=subprocess.STDOUT)
        workers.append(_Worker(proc, rank, log_path))
    return workers


def _launch_ps(args) -> int:
    """PS job: servers + trainers from ONE script branching on TRAINING_ROLE
    (reference: launch/controllers/ps.py PSController). Servers are
    terminated when every trainer exits cleanly."""
    host = "127.0.0.1"
    if args.servers and args.trainers:
        server_eps = args.servers.split(",")
        trainer_eps = args.trainers.split(",")
    else:
        ns = args.server_num or 1
        nt = args.trainer_num or 1
        server_eps = [f"{host}:{_free_port()}" for _ in range(ns)]
        trainer_eps = [f"{host}:{_free_port()}" for _ in range(nt)]

    base_env = dict(os.environ)
    base_env.update({
        "PADDLE_PSERVERS_IP_PORT_LIST": ",".join(server_eps),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(trainer_eps),
        "PADDLE_TRAINERS_NUM": str(len(trainer_eps)),
    })
    print(f"[launch] ps mode: {len(server_eps)} servers + "
          f"{len(trainer_eps)} trainers", file=sys.stderr, flush=True)
    servers = _spawn_role(args, base_env, len(server_eps), "PSERVER",
                          args.log_dir, server_eps)
    trainers = _spawn_role(args, base_env, len(trainer_eps), "TRAINER",
                           args.log_dir, trainer_eps)

    def _stop(procs):
        for s in procs:
            if s.proc.poll() is None:
                s.proc.terminate()
        for s in procs:
            try:
                s.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                s.proc.kill()

    # supervise BOTH pods (reference PSController.watch): a dead server is a
    # job failure; trainer completion ends the job and stops the servers
    try:
        while True:
            for s in servers:
                rc = s.proc.poll()
                if rc is not None and rc != 0:
                    print(f"[launch] ps server {s.rank} failed rc={rc} "
                          f"(log: {s.log_path}); terminating job",
                          file=sys.stderr, flush=True)
                    _stop(trainers)
                    _stop(servers)
                    return rc
            done = [w.proc.poll() for w in trainers]
            for w, rc in zip(trainers, done):
                if rc is not None and rc != 0:
                    print(f"[launch] trainer {w.rank} failed rc={rc} "
                          f"(log: {w.log_path}); terminating job",
                          file=sys.stderr, flush=True)
                    _stop(trainers)
                    _stop(servers)
                    return rc
            if all(rc == 0 for rc in done):
                _stop(servers)
                return 0
            time.sleep(0.2)
    except KeyboardInterrupt:
        _stop(trainers)
        _stop(servers)
        return 130


def _launch_rpc(args) -> int:
    """RPC job (reference: launch/controllers/rpc.py): N workers with the
    env contract distributed/rpc/rpc.py:init_rpc consumes."""
    nproc = args.nproc_per_node or 2
    host = "127.0.0.1"
    master = args.master or f"{host}:{_free_port()}"
    endpoints = [f"{host}:{_free_port()}" for _ in range(nproc)]
    os.makedirs(args.log_dir, exist_ok=True)
    print(f"[launch] rpc mode: {nproc} workers master={master}",
          file=sys.stderr, flush=True)
    workers = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nproc),
            "PADDLE_WORKER_ENDPOINT": endpoints[rank],
            "PADDLE_MASTER_ENDPOINT": master,
        })
        log_path = os.path.join(args.log_dir, f"rpclog.{rank}")
        if rank == 0:
            proc = subprocess.Popen(
                [sys.executable, "-u", args.training_script]
                + args.training_script_args, env=env)
        else:
            with open(log_path, "w") as out:
                proc = subprocess.Popen(
                    [sys.executable, "-u", args.training_script]
                    + args.training_script_args,
                    env=env, stdout=out, stderr=subprocess.STDOUT)
        workers.append(_Worker(proc, rank, log_path))
    return _supervise(workers)


def launch(argv: Optional[List[str]] = None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if (args.run_mode == "ps" or args.server_num or args.servers
            or args.trainer_num or args.trainers):
        return _launch_ps(args)
    if args.run_mode == "rpc":
        return _launch_rpc(args)
    if args.run_mode != "collective":
        raise SystemExit(f"unknown run_mode={args.run_mode!r}: choose "
                         "collective, ps or rpc")
    nnodes = int(str(args.nnodes).split(":")[0])
    nproc = args.nproc_per_node if args.nproc_per_node is not None else 1
    if nnodes > 1 and not args.master:
        raise SystemExit(
            "--master host:port is required for multi-node jobs: a per-node "
            "default coordinator address can never rendezvous")
    master = args.master or f"127.0.0.1:{_free_port()}"

    attempt = 0
    while True:
        t0 = time.time()
        print(f"[launch] nnodes={nnodes} nproc_per_node={nproc} "
              f"master={master} node_rank={args.rank} "
              f"(attempt {attempt + 1})", file=sys.stderr, flush=True)
        workers = _spawn_workers(args, master, args.rank, nnodes, nproc)
        rc = _supervise(workers)
        if rc == 0:
            print(f"[launch] job finished in {time.time() - t0:.1f}s",
                  file=sys.stderr, flush=True)
            return 0
        if attempt >= args.max_restarts:
            return rc
        attempt += 1
        print(f"[launch] restarting ({attempt}/{args.max_restarts})",
              file=sys.stderr, flush=True)


def main() -> None:
    sys.exit(launch())
