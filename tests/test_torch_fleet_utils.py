"""fleet's utilities, role makers and data generators of the port against
the JAX package's (``tests/test_fleet_utils_spawn.py``,
``distributed/fleet/{utils,role_maker,data_generator}.py``).

``LocalFS``, ``HDFSClient`` without a ``hadoop`` binary, the logger, the
role makers (the same environments read by both packages), ``fleet.util``
and ``fleet.init(role_maker=...)``, and the data generators' lines (byte
for byte) run in this process. The broadcasts over ``dp`` and ``mp`` and
``fused_allreduce_gradients`` run on two gloo ranks spawned once for the
file (``torch_ps_ranks.fleet_utils_job``): rank 0's values everywhere
after a broadcast, nothing moved by one over an axis of one rank, and the
fused reduction equal to ``DataParallel``'s bit for bit.
"""
import io
import os
import sys

import numpy as np
import pytest
from torch_suite import one_torch_thread  # noqa: F401

import paddle_tpu.distributed.fleet as jfleet
import paddle_tpu.distributed.fleet.utils as jutils
import paddle_tpu_torch.distributed.fleet as tfleet
import paddle_tpu_torch.distributed.fleet.utils as tutils

import torch_ps_ranks

PKGS = {"jax": (jfleet, jutils), "torch": (tfleet, tutils)}


@pytest.fixture(autouse=True)
def on_cpu():
    """The CPU for the test, then the device it was (a later test in the
    worker may expect the card)."""
    import paddle_tpu_torch as paddle

    prev = paddle.get_device() if paddle.device._current is not None \
        else None
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


# ------------------------------------------------------------------ fs
def _fs_session(utils, root):
    fs = utils.LocalFS()
    d = os.path.join(root, "sub", "dir")
    fs.mkdirs(d)
    out = [fs.is_dir(d), fs.is_exist(d)]
    f = os.path.join(d, "a.txt")
    fs.touch(f)
    out.append(fs.is_file(f))
    with pytest.raises(utils.FSFileExistsError):
        fs.touch(f, exist_ok=False)
    with open(f, "w") as fh:
        fh.write("payload")
    out += [fs.cat(f), fs.ls_dir(d), fs.list_dirs(os.path.join(root, "sub"))]
    dst = os.path.join(d, "b.txt")
    fs.mv(f, dst)
    out += [fs.is_file(dst), fs.is_exist(f)]
    with pytest.raises(utils.FSFileNotExistsError):
        fs.mv(os.path.join(d, "nope"), os.path.join(d, "x"))
    fs.upload(dst, os.path.join(root, "copy.txt"))
    out.append(fs.cat(os.path.join(root, "copy.txt")))
    fs.delete(d)
    out += [fs.is_exist(d), fs.need_upload_download(), fs.ls_dir(d)]
    return out


def test_local_fs_as_the_jax_one(tmp_path):
    got = {n: _fs_session(u, str(tmp_path / n)) for n, (_, u) in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][3] == "payload"


def test_hdfs_client_without_hadoop_binary():
    client = tutils.HDFSClient(hadoop_home="/nonexistent/hadoop")
    with pytest.raises(tutils.ExecuteError, match="not found"):
        client.mkdirs("/tmp/x")
    assert client.need_upload_download() is True
    assert client.is_exist("/tmp/x") is False


def test_get_logger_rank_prefixed(capsys):
    lg = tutils.get_logger(name="FleetLogTorchTest")
    lg.info("hello fleet")
    err = capsys.readouterr().err
    assert "hello fleet" in err and "[rank 0]" in err


def test_utils_names_as_the_jax_module():
    assert set(tutils.__all__) == set(jutils.__all__)
    assert tutils.recompute is tfleet.recompute


def test_helpers_do_nothing_without_a_process_group():
    from paddle_tpu_torch import nn

    lin = nn.Linear(2, 2)
    before = lin.weight.numpy().copy()
    tutils.broadcast_mp_parameters(lin)
    tutils.broadcast_dp_parameters(lin)
    tutils.fused_allreduce_gradients(list(lin.parameters()))
    np.testing.assert_array_equal(lin.weight.numpy(), before)


# ---------------------------------------------------------- role makers
ENVS = [
    {"TRAINING_ROLE": "TRAINER", "PADDLE_TRAINER_ID": "1",
     "PADDLE_TRAINERS_NUM": "3",
     "PADDLE_TRAINER_ENDPOINTS": "127.0.0.1:1,127.0.0.1:2,127.0.0.1:3",
     "PADDLE_PSERVERS_IP_PORT_LIST": "127.0.0.1:7,127.0.0.1:8"},
    {"TRAINING_ROLE": "PSERVER", "POD_IP": "127.0.0.1", "PADDLE_PORT": "8",
     "PADDLE_TRAINERS_NUM": "2",
     "PADDLE_PSERVERS_IP_PORT_LIST": "127.0.0.1:7,127.0.0.1:8"},
    {},
]
QUERIES = ("_is_worker", "_is_server", "_is_first_worker", "_worker_index",
           "_server_index", "_worker_num", "_server_num",
           "_get_trainer_endpoints", "_get_pserver_endpoints")


def _roles(rm):
    return [getattr(rm, q)() for q in QUERIES]


@pytest.mark.parametrize("env", range(len(ENVS)))
@pytest.mark.parametrize("collective", [False, True])
def test_cloud_role_maker_reads_the_environment_as_jax(monkeypatch, env,
                                                      collective):
    for k in ("TRAINING_ROLE", "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_PSERVERS_IP_PORT_LIST",
              "POD_IP", "PADDLE_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    got = {n: _roles(f.PaddleCloudRoleMaker(is_collective=collective))
           for n, (f, _) in PKGS.items()}
    assert got["torch"] == got["jax"]


def test_user_defined_role_maker_as_jax():
    kw = dict(current_id=1, role=tfleet.Role.SERVER, worker_num=4,
              server_endpoints=["a:1", "b:2"])
    got = {n: _roles(f.UserDefinedRoleMaker(**kw))
           for n, (f, _) in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert (tfleet.Role.WORKER, tfleet.Role.SERVER,
            tfleet.Role.HETER_WORKER) == (1, 2, 3)


def test_fleet_init_with_a_role_maker_and_util(tmp_path):
    rm = tfleet.UserDefinedRoleMaker(current_id=1, role=tfleet.Role.WORKER,
                                     worker_num=3,
                                     server_endpoints=["h:1", "h:2"])
    util = tfleet.util
    fl = tfleet.fleet
    try:
        fl.init(role_maker=rm, is_collective=False)
        assert tfleet.fleet.util is util  # one cached UtilBase
        assert util.role_maker is rm
        assert fl.is_worker() and not fl.is_server()
        assert (fl.worker_index(), fl.worker_num()) == (1, 3)
        assert (fl.server_num(), fl.server_endpoints()) == (2, ["h:1", "h:2"])
        assert fl.server_endpoints(to_string=True) == "h:1,h:2"
        assert fl.get_hybrid_communicate_group() is None
        files = [f"part-{i}" for i in range(7)]
        j = jutils.UtilBase(jfleet.UserDefinedRoleMaker(
            current_id=1, role=jfleet.Role.WORKER, worker_num=3))
        assert util.get_file_shard(files) == j.get_file_shard(files) \
            == ["part-3", "part-4"]
        with pytest.raises(TypeError):
            util.get_file_shard("part-0")
    finally:
        fl._is_initialized = False
        fl._is_collective = True
        fl._role_maker = None
        util._set_role_maker(None)


def test_fleet_exports_the_jax_names():
    for name in ("utils", "data_generator", "auto", "util", "UtilBase",
                 "DistributedInfer", "Role", "UserDefinedRoleMaker",
                 "PaddleCloudRoleMaker", "MultiSlotDataGenerator",
                 "MultiSlotStringDataGenerator"):
        assert hasattr(tfleet, name), name
    assert set(jfleet.__all__) - {"recompute_sequential"} <= set(
        tfleet.__all__)
    assert tfleet.DistributedInfer().get_dist_infer_program() is None


# -------------------------------------------------------- data generators
SAMPLES = [[("words", [1926, 8, 17]), ("label", [1])],
           [("words", [3, 4]), ("label", [0])],
           [("dense", [0.5, 1.25]), ("label", [1])]]


def _lines(pkg, cls_name, lines, batch=2):
    dg = getattr(pkg.data_generator, cls_name)

    class Gen(dg):
        def generate_sample(self, line):
            def it():
                for s in (SAMPLES if line is None
                          else [[("tok", line.split()), ("n", [len(line)])]]):
                    yield s
            return it

    g = Gen()
    g.set_batch(batch)
    out = io.StringIO()
    old_in, old_out = sys.stdin, sys.stdout
    try:
        sys.stdin, sys.stdout = io.StringIO(lines), out
        if lines:
            g.run_from_stdin()
        else:
            g.run_from_memory()
    finally:
        sys.stdin, sys.stdout = old_in, old_out
    return out.getvalue()


@pytest.mark.parametrize("cls", ["MultiSlotDataGenerator",
                                 "MultiSlotStringDataGenerator"])
@pytest.mark.parametrize("lines", ["", "a b c\nd e\nf\n"])
def test_data_generator_lines_are_the_jax_ones(cls, lines):
    got = {n: _lines(f, cls, lines) for n, (f, _) in PKGS.items()}
    assert got["torch"] == got["jax"] and got["torch"]


def test_data_generator_errors_as_jax():
    for f, _ in PKGS.values():
        g = f.MultiSlotDataGenerator()
        with pytest.raises(ValueError, match="empty"):
            g._gen_str([("a", [])])
        with pytest.raises(ValueError, match="list or tuple"):
            g._gen_str("nope")
        g._gen_str([("a", [1])])
        with pytest.raises(ValueError, match="inconsistent"):
            g._gen_str([("a", [1]), ("b", [2])])
        with pytest.raises(NotImplementedError):
            f.data_generator.DataGenerator().generate_sample("x")


# ------------------------------------------------- two ranks on gloo
@pytest.fixture(scope="module")
def ranks():
    from paddle_tpu_torch.distributed import spawn

    rng = np.random.default_rng(5)
    w = {"0.weight": rng.standard_normal((8, 16)).astype("f4"),
         "0.bias": rng.standard_normal(16).astype("f4"),
         "2.weight": rng.standard_normal((16, 4)).astype("f4"),
         "2.bias": rng.standard_normal(4).astype("f4")}
    x = rng.standard_normal((16, 8)).astype("f4")
    y = rng.integers(0, 4, 16)
    ctx = spawn(torch_ps_ranks.fleet_utils_job, args=(w, x, y), nprocs=2,
                backend="cpu")
    res = ctx.results()
    return res[0], res[1]


def test_broadcasts_take_the_first_rank_of_their_axis(ranks):
    r0, r1 = ranks
    for key in ("after_dp", "after_mp"):
        for a, b in zip(r0[key], r1[key]):
            np.testing.assert_array_equal(a, b)
    # over an axis of one rank nothing moves: rank 1 keeps its own noise
    for noop in ("after_mp_noop", "after_dp_noop_mp2"):
        for a, b in zip(r0[noop], r1[noop]):
            np.testing.assert_allclose(b - a, 0.1, rtol=1e-5)


def test_fused_allreduce_equals_data_parallel_bit_for_bit(ranks):
    for r in ranks:
        assert len(r["fused"]) == len(r["dp"]) == 4
        for a, b in zip(r["fused"], r["dp"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ranks[0]["fused"], ranks[1]["fused"]):
        np.testing.assert_array_equal(a, b)


def test_util_collectives_over_the_workers(ranks):
    r0, r1 = ranks
    for r in ranks:
        np.testing.assert_array_equal(r["util_sum"], [3.0])
        np.testing.assert_array_equal(r["util_max"], [2.0])
        assert r["util_gather"] == [0, 10]
    assert r0["file_shard"] == ["f0", "f1", "f2"]
    assert r1["file_shard"] == ["f3", "f4"]
