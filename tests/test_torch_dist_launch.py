"""The port's launch contract, ``ParallelEnv``, ``TCPStore``, ``spawn``
and ``python -m paddle_tpu_torch.distributed.launch``: twins of
``tests/test_fleet_utils_spawn.py:91-110``, ``tests/test_launch.py:
59-176`` and the JAX store's sequence in ``tests/test_rpc.py:27-50``.

The store runs the same sequence of operations in both packages and
must give the same results. The spawn and launch workers import only
``paddle_tpu_torch``.
"""
import json
import os
import socket
import subprocess
import sys

import pytest
from torch_suite import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _store_sequence(TCPStore):
    port = _free_port()
    master = TCPStore("127.0.0.1", port, is_master=True, world_size=2,
                      timeout=20)
    client = TCPStore("127.0.0.1", port, is_master=False, world_size=2,
                      timeout=20)
    out = []
    try:
        master.set("alpha", b"hello")
        out.append(client.get("alpha"))
        out.append(client.add("ctr", 3))
        out.append(master.add("ctr", 4))
        out.append(client.get("ctr"))
        out.append(client.check("missing"))
        try:
            client.wait("missing", timeout=0.3)
            out.append("no timeout")
        except TimeoutError:
            out.append("TimeoutError")
        try:
            client.get("missing", timeout=0.3)
            out.append("no timeout")
        except TimeoutError:
            out.append("TimeoutError")
        client.set("beta", "text-value")
        client.set("gamma", 12)
        master.wait(["alpha", "beta"], timeout=5)
        out.append(master.check(["alpha", "beta"]))
        out.append(master.get("beta"))
        out.append(master.get("gamma"))
    finally:
        client.stop()
        master.stop()
    return out


def test_tcp_store_matches_the_jax_store():
    from paddle_tpu.distributed import TCPStore as JaxStore
    from paddle_tpu_torch.distributed import TCPStore

    got = _store_sequence(TCPStore)
    assert got == _store_sequence(JaxStore)
    assert got[:5] == [b"hello", 3, 7, b"7", False]


def test_tcp_store_refuses_a_taken_port():
    from paddle_tpu_torch.distributed import TCPStore

    port = _free_port()
    first = TCPStore("127.0.0.1", port, is_master=True, timeout=5)
    try:
        with pytest.raises(RuntimeError, match="could not bind"):
            TCPStore("127.0.0.1", port, is_master=True, timeout=5)
    finally:
        first.stop()


def test_env_contract_and_parallel_env(monkeypatch):
    import paddle_tpu.distributed.env as jenv
    import paddle_tpu_torch.distributed as dist

    env = {"PADDLE_TRAINER_ID": "3", "PADDLE_TRAINERS_NUM": "4",
           "PADDLE_LOCAL_RANK": "1",
           "PADDLE_TRAINER_ENDPOINTS": "a:1,b:2,c:3,d:4",
           "PADDLE_CURRENT_ENDPOINT": "d:4"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for e, pe in ((dist, dist.ParallelEnv()), (jenv, jenv.ParallelEnv())):
        assert (e.get_rank(), e.get_world_size()) == (3, 4)
        assert (pe.rank, pe.world_size, pe.nranks) == (3, 4, 4)
        assert (pe.local_rank, pe.dev_id) == (1, 1)
        assert pe.trainer_endpoints == ["a:1", "b:2", "c:3", "d:4"]
        assert pe.current_endpoint == "d:4"
    for k in env:
        monkeypatch.delenv(k)
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)


def _spawn_target(scale):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    n = int(os.environ["PADDLE_TRAINERS_NUM"])
    assert os.environ["PADDLE_MASTER_ENDPOINT"]
    return (rank + 1) * scale + n


def _spawn_failer():
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    if rank == 1:
        raise RuntimeError("rank1 exploded")
    import time

    time.sleep(60)  # ended by the context when rank 1 fails
    return rank


def test_spawn_runs_and_collects_results():
    from paddle_tpu_torch.distributed import spawn

    ctx = spawn(_spawn_target, args=(10,), nprocs=2, backend="cpu")
    assert ctx.results() == {0: 12, 1: 22}


def test_spawn_propagates_worker_error_and_ends_the_others():
    import time

    from paddle_tpu_torch.distributed import spawn

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank1 exploded"):
        spawn(_spawn_failer, nprocs=2, backend="cpu")
    assert time.monotonic() - t0 < 50


def test_spawn_runs_on_the_card_unless_told_the_cpu(monkeypatch):
    import torch

    from paddle_tpu_torch.distributed import spawn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        spawn(_spawn_target, args=(1,), nprocs=2)


def test_spawn_validates_nprocs():
    from paddle_tpu_torch.distributed import spawn

    with pytest.raises(ValueError):
        spawn(_spawn_target, args=(1,), nprocs=0, backend="cpu")


WORKER = """
import json, os, sys
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.distributed.env import (ParallelEnv, get_rank,
                                              get_world_size)

env = ParallelEnv()
info = dict(rank=get_rank(), world=get_world_size(),
            local_rank=env.local_rank,
            endpoint=env.current_endpoint,
            n_endpoints=len(env.trainer_endpoints),
            master=os.environ["MASTER_ADDR"] + ":" + os.environ["MASTER_PORT"],
            jax=any(m.split(".")[0] in ("jax", "paddle_tpu")
                    for m in sys.modules))
with open(os.path.join({out!r}, f"rank{{info['rank']}}.json"), "w") as f:
    json.dump(info, f)
"""


def _run_launch(script_path, tmp_path, nproc=2, extra=()):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc),
           "--log_dir", str(tmp_path / "log"), *extra, str(script_path)]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_launch_env_contract_two_workers(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, out=str(tmp_path)))
    r = _run_launch(script, tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    infos = [json.loads((tmp_path / f"rank{rank}.json").read_text())
             for rank in (0, 1)]
    assert {i["rank"] for i in infos} == {0, 1}
    assert all(i["world"] == 2 for i in infos)
    assert all(i["n_endpoints"] == 2 for i in infos)
    assert infos[0]["endpoint"] != infos[1]["endpoint"]
    assert infos[0]["master"] == infos[1]["master"]
    assert {i["local_rank"] for i in infos} == {0, 1}
    assert not any(i["jax"] for i in infos)


def test_launch_failed_worker_ends_the_job(tmp_path):
    script = tmp_path / "boom.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    r = _run_launch(script, tmp_path)
    assert r.returncode == 3
    assert "worker 1 failed rc=3" in r.stderr


def test_launch_refuses_an_unknown_mode(tmp_path):
    script = tmp_path / "x.py"
    script.write_text("pass\n")
    r = _run_launch(script, tmp_path, extra=("--run_mode", "bogus"))
    assert r.returncode != 0
    assert "collective" in r.stderr


def test_gloo_trio_and_ps_configs_match_jax(tmp_path):
    """The gloo trio on one rank over the port's TCPStore, and the copied
    entry configs and file datasets, against the JAX package's."""
    import paddle_tpu.distributed as jdist
    import paddle_tpu_torch.distributed as dist

    port = _free_port()
    dist.gloo_init_parallel_env(0, 1, f"127.0.0.1:{port}")
    dist.gloo_barrier()
    dist.gloo_barrier()
    dist.gloo_release()
    with pytest.raises(RuntimeError, match="gloo_init_parallel_env"):
        dist.gloo_barrier()
    f = tmp_path / "d.txt"
    f.write_text("1 2\n3 4\n5 6\n")
    for d in (dist, jdist):
        assert d.ProbabilityEntry(0.5)._to_attr() == \
            "probability_entry probability:0.5"
        assert d.CountFilterEntry(3)._to_attr() == \
            "count_filter_entry count_filter:3"
        with pytest.raises(ValueError):
            d.ProbabilityEntry(0.0)
        ds = d.InMemoryDataset()
        ds.set_filelist([str(f)])
        ds.set_parse_fn(lambda line: [int(v) for v in line.split()])
        ds.load_into_memory()
        assert list(ds) == [[1, 2], [3, 4], [5, 6]]
        assert ds.get_memory_data_size() == 3
        assert d.ParallelMode.TENSOR_PARALLEL == 1
    assert dist.is_available() and not dist.is_initialized()
