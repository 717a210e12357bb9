"""The port's elastic manager (``distributed/fleet/elastic``) against the
JAX package's (``tests/test_elastic.py``): each scenario run by both
packages' managers on their own registries, the same statuses and the
same rewritten environment; then the port's launcher relaunching a job
whose worker exits with ``ELASTIC_EXIT_CODE`` without spending a
``--max_restarts`` restart.
"""
import os
import time

import pytest
from torch_suite import one_torch_thread  # noqa: F401

import paddle_tpu.distributed.fleet.elastic as jel
import paddle_tpu_torch.distributed.fleet.elastic as tel

PKGS = {"jax": jel, "torch": tel}
ENV = ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ENDPOINTS", "PADDLE_TRAINER_ID")


@pytest.fixture(autouse=True)
def _clean_env():
    yield
    for k in ENV:
        os.environ.pop(k, None)


def _env():
    return tuple(os.environ.get(k) for k in ENV)


def _manager(el, store, host, np_="1:3"):
    return el.ElasticManager(np=np_, host=host, store=store,
                             heartbeat_interval=0.1)


def test_exit_code_contract():
    assert tel.ELASTIC_EXIT_CODE == jel.ELASTIC_EXIT_CODE == 101
    assert tel.ELASTIC_AUTO_PARALLEL_EXIT_CODE == 102
    assert vars(tel.ElasticStatus).keys() == vars(jel.ElasticStatus).keys()


def _liveness(el, root):
    store = el.FileStore(root, ttl=5.0)
    a = _manager(el, store, "hostA", "2")
    b = _manager(el, store, "hostB", "2")
    a.register()
    b.register()
    time.sleep(0.3)
    hosts = set(store.hosts())
    a.exit(completed=True)
    b.exit(completed=True)
    return hosts, store.hosts()


def test_register_and_liveness(tmp_path):
    got = {n: _liveness(el, str(tmp_path / n)) for n, el in PKGS.items()}
    assert got["torch"] == got["jax"] == ({"hostA", "hostB"}, [])


def _scale_in(el, root):
    store = el.FileStore(root, ttl=0.5)
    a = _manager(el, store, "hostA")
    b = _manager(el, store, "hostB")
    a.register()
    b.register()
    time.sleep(0.3)
    out = [len(a.hosts()), a.watch(interval=0.1, timeout=10), _env()]
    b._stop.set()
    b._hb_thread.join()
    out += [a.watch(interval=0.1, timeout=10), _env()]
    a.exit(completed=True)
    for k in ENV:
        os.environ.pop(k, None)
    return out


def test_scale_in_detected_and_env_rewritten(tmp_path):
    got = {n: _scale_in(el, str(tmp_path / n)) for n, el in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"] == [2, "restart", ("2", "hostA,hostB", "0"),
                            "restart", ("1", "hostA", "0")]


def _scale_out(el, root):
    store = el.FileStore(root, ttl=5.0)
    a = _manager(el, store, "hostA")
    a.register()
    time.sleep(0.2)
    out = [a.watch(interval=0.05, timeout=0.3)]
    c = _manager(el, store, "hostC")
    c.register()
    out += [a.watch(interval=0.05, timeout=10), _env()]
    a.exit()
    c.exit()
    for k in ENV:
        os.environ.pop(k, None)
    return out


def test_scale_out_detected(tmp_path):
    got = {n: _scale_out(el, str(tmp_path / n)) for n, el in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == ["hold", "restart"]


def test_disabled_when_np_zero(tmp_path):
    for el in PKGS.values():
        m = el.ElasticManager(np="0", store=el.FileStore(str(tmp_path)))
        assert not m.enable
        m.register()
        assert m.watch() == el.ElasticStatus.COMPLETED


def _below_quorum(el, root):
    store = el.FileStore(root, ttl=0.4)
    a = _manager(el, store, "hostA", "2:3")
    b = _manager(el, store, "hostB", "2:3")
    a.register()
    b.register()
    time.sleep(0.3)
    a.watch(interval=0.05, timeout=5)
    b._stop.set()
    b._hb_thread.join()
    status = a.watch(interval=0.1, timeout=1.5)
    a.exit()
    return status


def test_below_quorum_exits_after_deadline(tmp_path):
    got = {n: _below_quorum(el, str(tmp_path / n)) for n, el in PKGS.items()}
    assert got["torch"] == got["jax"] == "exit"


def test_default_registry_lies_under_the_temporary_directory(monkeypatch,
                                                             tmp_path):
    monkeypatch.delenv("PADDLE_ELASTIC_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    m = tel.ElasticManager(np="1", host="h")
    assert m.store.root.startswith(str(tmp_path))


_WORKER = """import os, sys
marker = os.path.join({root!r}, "attempts")
with open(marker, "a") as f:
    f.write("x")
sys.exit(101 if len(open(marker).read()) == 1 else 0)
"""


def _launch(argv):
    from paddle_tpu_torch.distributed.launch.main import launch

    return launch(argv)


@pytest.mark.parametrize("how", ["env", "nnodes"])
def test_launcher_relaunches_on_the_elastic_exit_code(tmp_path, how,
                                                      monkeypatch, capsys):
    """A worker exiting 101 is a scale event: the job runs again at the
    registry's node count and ends 0, with no restart allowed."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(root=str(tmp_path)))
    monkeypatch.setenv("PADDLE_ELASTIC_DIR", str(tmp_path / "registry"))
    args = ["--nnodes", "1:2"] if how == "nnodes" else []
    if how == "env":
        monkeypatch.setenv("PADDLE_ELASTIC_NP", "1")
    else:
        monkeypatch.delenv("PADDLE_ELASTIC_NP", raising=False)
    rc = _launch(["--max_restarts", "0", "--log_dir", str(tmp_path / "log"),
                  *args, str(script)])
    assert rc == 0
    assert (tmp_path / "attempts").read_text() == "xx"
    assert "elastic scale event" in capsys.readouterr().err


def test_launcher_without_elastic_stops_at_the_exit_code(tmp_path,
                                                         monkeypatch):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(root=str(tmp_path)))
    monkeypatch.delenv("PADDLE_ELASTIC_NP", raising=False)
    assert _launch(["--log_dir", str(tmp_path / "log"), str(script)]) == 101
    assert (tmp_path / "attempts").read_text() == "x"
