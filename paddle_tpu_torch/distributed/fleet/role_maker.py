"""Fleet role makers (``paddle_tpu/distributed/fleet/role_maker.py``;
reference: python/paddle/distributed/fleet/base/role_maker.py — Role
:31, PaddleCloudRoleMaker :547, UserDefinedRoleMaker :1183).

The collective rendezvous is ``init_parallel_env`` (``fleet.init``), so
a role maker here is the ENV-CONTRACT reader — the same
PADDLE_TRAINER_* / TRAINING_ROLE variables the launch CLI writes — plus
the explicit-kwargs variant for tests and custom schedulers. The PS
runtime (distributed/ps) consumes worker/server roles the same way.
"""
from __future__ import annotations

import os


class Role:
    """reference: role_maker.py:31."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3


class PaddleCloudRoleMaker:
    """Env-driven role maker (reference: role_maker.py:547) — reads the
    launch CLI's env contract: TRAINING_ROLE, PADDLE_TRAINER_ID,
    PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS,
    PADDLE_PSERVERS_IP_PORT_LIST, PADDLE_PORT/POD_IP (server identity).
    """

    def __init__(self, is_collective: bool = False, **kwargs):
        self._is_collective = is_collective
        self._kwargs = kwargs
        self._generated = False

    def _generate_role(self):
        if self._generated:
            return
        env = os.environ
        self._worker_endpoints = [
            e for e in env.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
            if e]
        self._server_endpoints = [
            e for e in env.get("PADDLE_PSERVERS_IP_PORT_LIST", "").split(",")
            if e]
        self._trainers_num = int(
            env.get("PADDLE_TRAINERS_NUM",
                    len(self._worker_endpoints) or 1))
        training_role = env.get("TRAINING_ROLE", "TRAINER")
        if self._is_collective or training_role == "TRAINER":
            self._role = Role.WORKER
            self._current_id = int(env.get("PADDLE_TRAINER_ID", 0))
        else:
            self._role = Role.SERVER
            me = f"{env.get('POD_IP', '127.0.0.1')}:{env.get('PADDLE_PORT')}"
            self._current_id = (self._server_endpoints.index(me)
                                if me in self._server_endpoints else 0)
        self._generated = True

    # -- reference query surface ------------------------------------------
    def _is_worker(self):
        self._generate_role()
        return self._role == Role.WORKER

    def _is_server(self):
        self._generate_role()
        return self._role == Role.SERVER

    def _is_first_worker(self):
        return self._is_worker() and self._worker_index() == 0

    def _worker_index(self):
        self._generate_role()
        return self._current_id

    def _server_index(self):
        self._generate_role()
        return self._current_id

    def _worker_num(self):
        self._generate_role()
        return self._trainers_num

    def _server_num(self):
        self._generate_role()
        return len(self._server_endpoints)

    def _get_trainer_endpoints(self):
        self._generate_role()
        return list(self._worker_endpoints)

    def _get_pserver_endpoints(self):
        self._generate_role()
        return list(self._server_endpoints)

    # public aliases the reference also exposes
    is_worker = _is_worker
    is_server = _is_server
    is_first_worker = _is_first_worker
    worker_index = _worker_index
    server_index = _server_index
    worker_num = _worker_num
    server_num = _server_num


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """Kwargs-driven role maker (reference: role_maker.py:1183):
    ``UserDefinedRoleMaker(current_id=0, role=Role.WORKER, worker_num=2,
    server_endpoints=[...])``."""

    def _generate_role(self):
        if self._generated:
            return
        kw = self._kwargs
        self._server_endpoints = list(kw.get("server_endpoints") or [])
        self._worker_endpoints = list(kw.get("worker_endpoints") or [])
        self._trainers_num = int(kw.get("worker_num", 0)) or \
            len(self._worker_endpoints) or 1
        self._role = kw.get("role", Role.WORKER)
        self._current_id = int(kw.get("current_id", 0))
        self._generated = True
