"""The port's parameter server (``paddle_tpu_torch.distributed.ps``) held
against the JAX package's (``tests/test_ps.py``'s cases, each run in both).

The native tables are one C++ source built by each package with the same
compiler and flags, so fresh rows, SGD/AdaGrad/Adam updates and saved
files are compared bit for bit, and a file saved by either package is
loaded by the other. The servers, clients, ``SparseEmbedding`` and the
communicators are compared the same way where their arithmetic is the
tables'; a loss computed by each package's own tensors (JAX f32 against
torch f32) is held at rtol 1e-6. Last, one sync step of a small
Wide&Deep model through ``SparseEmbedding`` against the same model with
dense embeddings over the touched rows (``tools/ps_engine_drills.py``'s
check on the card), at rtol 1e-4 on the rows' updates.
"""
import os

import numpy as np
import pytest
import torch
from torch_suite import one_torch_thread  # noqa: F401

import paddle_tpu as jpaddle
import paddle_tpu.distributed.ps as jps
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed.ps as tps

PKGS = {"jax": jps, "torch": tps}


@pytest.fixture(autouse=True)
def on_cpu():
    """The CPU for the test, then the device it was (a later test in the
    worker may expect the card)."""
    prev = paddle.get_device() if paddle.device._current is not None \
        else None
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def _both(fn):
    return {name: fn(mod) for name, mod in PKGS.items()}


def _same(got):
    a, b = got["jax"], got["torch"]
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same({"jax": x, "torch": y})
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


# ---------------------------------------------------------------- tables


def test_fresh_rows_equal_the_jax_tables_bit_for_bit():
    keys = np.concatenate([np.arange(200, dtype=np.uint64),
                           np.array([2**63 + 5, 2**64 - 1], np.uint64)])
    for dim, seed, rng in ((1, 0, 0.05), (9, 3, 0.05), (16, 7, 1.0)):
        _same(_both(lambda m: m.SparseTable(m.TableConfig(
            dim=dim, seed=seed, init_range=rng)).pull(keys)))


def test_sparse_table_deterministic_init_and_sgd():
    def case(m):
        t = m.SparseTable(m.TableConfig(dim=4, optimizer="sgd",
                                        learning_rate=0.5, init_range=0.1,
                                        seed=7))
        keys = np.array([3, 99, 3], dtype=np.uint64)
        rows = t.pull(keys)
        t.push(np.array([3, 99], np.uint64), np.ones((2, 4), np.float32))
        return [rows, t.pull(keys), len(t)]

    got = _both(case)
    _same(got)
    rows = got["torch"][0]
    assert np.all(np.abs(rows) <= 0.1)
    np.testing.assert_array_equal(rows[0], rows[2])
    np.testing.assert_allclose(got["torch"][1][:2], rows[:2] - 0.5,
                               rtol=1e-6)


def test_sparse_table_duplicate_keys_apply_sequentially():
    def case(m):
        t = m.SparseTable(m.TableConfig(dim=2, optimizer="sgd",
                                        learning_rate=1.0, init_range=0.0))
        t.push(np.array([5, 5], np.uint64),
               np.array([[1.0, 0.0], [0.0, 2.0]], np.float32))
        return t.pull(np.array([5], np.uint64))

    got = _both(case)
    _same(got)
    np.testing.assert_allclose(got["torch"][0], [-1.0, -2.0], rtol=1e-6)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_updates_equal_the_jax_tables_bit_for_bit(optimizer):
    g = np.random.default_rng(0).standard_normal((6, 5, 3)).astype(
        np.float32)
    keys = np.array([1, 2, 3, 2, 9], np.uint64)  # a repeated key

    def case(m):
        t = m.SparseTable(m.TableConfig(dim=3, optimizer=optimizer,
                                        learning_rate=0.1, seed=4))
        d = m.DenseTable(7, m.TableConfig(optimizer=optimizer,
                                          learning_rate=0.1))
        d.set(np.linspace(-1, 1, 7).astype(np.float32))
        out = []
        for step in g:
            t.push(keys, step)
            d.push(step.ravel()[:7])
            out += [t.pull(keys), d.pull()]
        return out

    _same(_both(case))


def test_sparse_table_adam_matches_numpy():
    lr, b1, b2, eps = 0.1, 0.9, 0.999, 1e-8
    t = tps.SparseTable(tps.TableConfig(dim=3, optimizer="adam",
                                        learning_rate=lr, beta1=b1,
                                        beta2=b2, epsilon=eps,
                                        init_range=0.0))
    key = np.array([42], np.uint64)
    w = t.pull(key)[0].astype(np.float64)
    m = np.zeros(3)
    v = np.zeros(3)
    rng = np.random.default_rng(0)
    for step in range(1, 6):
        g = rng.standard_normal(3).astype(np.float32)
        t.push(key, g[None])
        gf = g.astype(np.float64)
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf * gf
        w = w - lr * (m / (1 - b1 ** step)) / (np.sqrt(v / (1 - b2 ** step))
                                               + eps)
    np.testing.assert_allclose(t.pull(key)[0], w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("saver,loader", [("jax", "torch"),
                                          ("torch", "jax")])
def test_saved_tables_load_across_packages(tmp_path, saver, loader):
    """AdaGrad's slots included: a file written by one package restores
    the other's table, and both files are the same bytes."""
    k = np.arange(40, dtype=np.uint64) * 7919

    def fill(m):
        t = m.SparseTable(m.TableConfig(dim=2, optimizer="adagrad",
                                        learning_rate=0.1, seed=5))
        t.push(k, np.ones((40, 2), np.float32))
        return t

    paths = {}
    for name, m in PKGS.items():
        paths[name] = str(tmp_path / f"{name}.bin")
        fill(m).save(paths[name])
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    src = fill(PKGS[saver])
    dst = PKGS[loader].SparseTable(PKGS[loader].TableConfig(
        dim=2, optimizer="adagrad", learning_rate=0.1, seed=5))
    dst.load(paths[saver])
    assert len(dst) == 40
    np.testing.assert_array_equal(dst.pull(k), src.pull(k))
    src.push(k, np.ones((40, 2), np.float32))  # the slots came along
    dst.push(k, np.ones((40, 2), np.float32))
    np.testing.assert_array_equal(dst.pull(k), src.pull(k))
    bad = PKGS[loader].SparseTable(PKGS[loader].TableConfig(
        dim=3, optimizer="adagrad"))
    with pytest.raises(IOError):
        bad.load(paths[saver])


def test_dense_table_set_pull_push():
    def case(m):
        t = m.DenseTable(6, m.TableConfig(optimizer="sgd",
                                          learning_rate=0.25))
        t.set(np.arange(6, dtype=np.float32))
        t.push(np.ones(6, np.float32))
        return t.pull()

    got = _both(case)
    _same(got)
    np.testing.assert_allclose(got["torch"], np.arange(6) - 0.25)


def test_ssd_table_files_equal_and_reopen_across_packages(tmp_path):
    """The SSD table's record file, evictions included, is the JAX
    package's byte for byte and reopens in either package."""
    keys = np.arange(64, dtype=np.uint64)

    def case(m):
        path = str(tmp_path / f"{m.__name__}.pst")
        cfg = m.TableConfig(dim=4, optimizer="adam", learning_rate=0.1,
                            seed=3)
        t = m.SSDSparseTable(cfg, path, max_mem_rows=8)
        t.push(keys, np.full((64, 4), 0.5, np.float32))
        vals = t.pull(keys)
        mem = t.mem_rows
        t.close()
        return path, vals, mem

    got = _both(case)
    _same({k: list(v[1:]) for k, v in got.items()})
    with open(got["jax"][0], "rb") as a, open(got["torch"][0], "rb") as b:
        assert a.read() == b.read()
    cfg = tps.TableConfig(dim=4, optimizer="adam", learning_rate=0.1, seed=3)
    t2 = tps.SSDSparseTable(cfg, got["jax"][0], max_mem_rows=8)
    assert len(t2) == 64
    np.testing.assert_array_equal(t2.pull(keys), got["jax"][1])
    t2.close()
    with pytest.raises(IOError):
        tps.SSDSparseTable(tps.TableConfig(dim=8), got["jax"][0])


def test_ssd_table_bounded_memory_and_eviction(tmp_path):
    cfg = tps.TableConfig(dim=4, optimizer="sgd", learning_rate=1.0, seed=7)
    t = tps.SSDSparseTable(cfg, str(tmp_path / "emb.pst"), max_mem_rows=8)
    first = t.pull(np.arange(64, dtype=np.uint64))
    assert t.mem_rows <= 8 and len(t) >= 56
    t.push(np.array([3], np.uint64), -np.ones((1, 4), np.float32))
    t.pull(np.arange(100, 164, dtype=np.uint64))
    np.testing.assert_allclose(t.pull(np.array([3], np.uint64)),
                               first[3:4] + 1.0, rtol=1e-6)
    t.close()


def test_ssd_table_adam_matches_memory_table(tmp_path):
    cfg = tps.TableConfig(dim=4, optimizer="adam", learning_rate=0.1, seed=3)
    mem = tps.SparseTable(cfg)
    ssd = tps.SSDSparseTable(cfg, str(tmp_path / "emb.pst"), max_mem_rows=2)
    keys = np.array([1, 2, 3, 4, 5, 6], np.uint64)
    rng = np.random.RandomState(0)
    for _ in range(3):
        g = rng.randn(6, 4).astype(np.float32)
        mem.push(keys, g)
        ssd.push(keys, g)
    np.testing.assert_array_equal(ssd.pull(keys), mem.pull(keys))
    ssd.close()


def test_table_builds_into_the_ignored_build_directory():
    from paddle_tpu_torch.ops import _build

    path = _build.host_library_path("ps_table")
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert "build" in path.parts


def test_failed_host_build_raises(monkeypatch, tmp_path):
    from paddle_tpu_torch.ops import _build

    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="host build of broken.cc"):
        _build.load_host("broken")


# ---------------------------------------------------------------- service


@pytest.fixture
def clients():
    """Two servers and a client in each package."""
    out, servers = {}, []
    for name, m in PKGS.items():
        ss = [m.PSServer(port=0), m.PSServer(port=0)]
        servers += ss
        out[name] = m.PSClient([f"127.0.0.1:{s.port}" for s in ss])
    yield out
    for c in out.values():
        c.close()
    for s in servers:
        s.stop()


def test_ps_service_sparse_sharded(clients):
    keys = np.arange(100, dtype=np.uint64)
    grads = np.tile(np.arange(100, dtype=np.float32)[:, None], (1, 4))
    got = {}
    for name, m in PKGS.items():
        c = clients[name]
        assert c.ping()
        c.create_sparse_table(0, m.TableConfig(
            dim=4, optimizer="sgd", learning_rate=1.0, init_range=0.05,
            seed=1))
        before = c.pull_sparse(0, keys)
        c.push_sparse(0, keys, grads)
        got[name] = [before, c.pull_sparse(0, keys),
                     c._call_all("sparse_size", 0)]
    _same(got)
    sizes = got["torch"][2]
    assert all(s > 0 for s in sizes) and sum(sizes) == 100


def test_ps_service_sparse_save_load_across_packages(clients, tmp_path):
    keys = np.arange(50, dtype=np.uint64)
    cfg = {n: m.TableConfig(dim=2, optimizer="sgd", learning_rate=1.0,
                            init_range=0.05, seed=3)
           for n, m in PKGS.items()}
    clients["jax"].create_sparse_table(7, cfg["jax"])
    clients["jax"].push_sparse(7, keys, np.ones((50, 2), np.float32))
    want = clients["jax"].pull_sparse(7, keys)
    prefix = str(tmp_path / "t7")
    clients["jax"].save_sparse(7, prefix)
    c = clients["torch"]
    c.create_sparse_table(7, cfg["torch"])
    c.load_sparse(7, prefix)
    np.testing.assert_array_equal(c.pull_sparse(7, keys), want)
    assert c.sparse_size(7) == 50


def test_ps_service_dense(clients):
    init = np.linspace(0, 1, 8).astype(np.float32)

    def case(name, m):
        c = clients[name]
        c.create_dense_table(1, 8, m.TableConfig(optimizer="sgd",
                                                 learning_rate=0.5),
                             init=init)
        out = [c.pull_dense(1)]
        c.push_dense(1, np.ones(8, np.float32))
        out.append(c.pull_dense(1))
        out.append(c.geo_push_dense(1, np.full(8, 0.25, np.float32)))
        c.set_dense(1, np.zeros(8, np.float32))
        return out + [c.pull_dense(1)]

    got = {n: case(n, m) for n, m in PKGS.items()}
    _same(got)
    np.testing.assert_allclose(got["torch"][1], init - 0.5)


def test_ps_service_remote_error_travels(clients):
    for c in clients.values():
        with pytest.raises(KeyError):
            c.pull_dense(12345)


def test_pull_of_zero_keys(clients):
    c = clients["torch"]
    c.create_sparse_table(2, tps.TableConfig(dim=3))
    assert c.pull_sparse(2, np.zeros(0, np.uint64)).shape == (0, 3)
    fresh = tps.PSClient(c._endpoints)
    with pytest.raises(ValueError, match="row width unknown"):
        fresh.pull_sparse(2, np.zeros(0, np.uint64))
    fresh.close()


# ---------------------------------------------------------------- layer


def _embedding_run(name, m, client, steps, comm=None):
    """SparseEmbedding trained toward ones; the losses and the rows."""
    ids = np.array([[1, 2], [2, 9]], np.int64)
    cfg = m.TableConfig(dim=4, optimizer="sgd", learning_rate=0.5,
                        init_range=0.05, seed=2)
    kw = {"communicator": comm} if comm is not None else {}
    if name == "torch":
        kw["device"] = "cpu"
    emb = m.SparseEmbedding(client, table_id=3, embedding_dim=4, config=cfg,
                            **kw)
    pkg = jpaddle if name == "jax" else paddle
    target = pkg.to_tensor(np.ones((2, 2, 4), np.float32))
    losses = []
    for _ in range(steps):
        out = emb(ids)
        assert tuple(out.shape) == (2, 2, 4)
        loss = ((out - target) ** 2).mean()
        loss.backward()
        losses.append(float(loss.numpy()))
    return emb, losses, target, ids


def test_sparse_embedding_trains_as_the_jax_one(clients):
    got = {}
    for name, m in PKGS.items():
        emb, losses, target, ids = _embedding_run(name, m, clients[name], 25)
        rows = clients[name].pull_sparse(3, np.array([1, 2, 9], np.uint64))
        emb.eval()  # eval: no pushes, rows stay fixed
        ((emb(ids) - target) ** 2).mean().backward()
        got[name] = (losses, rows, clients[name].pull_sparse(
            3, np.array([1, 2, 9], np.uint64)))
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-6)
    np.testing.assert_allclose(got["torch"][1], got["jax"][1], rtol=1e-5,
                               atol=1e-7)
    losses = got["torch"][0]
    assert losses[-1] < losses[0] * 0.2
    np.testing.assert_array_equal(got["torch"][2], got["torch"][1])


def test_sparse_embedding_torch_ids_and_counts(clients):
    c = clients["torch"]
    emb = tps.SparseEmbedding(c, 11, 3, device="cpu")
    out = emb(torch.tensor([[4, 4, 5]]))
    assert isinstance(out, torch.Tensor) and out.shape == (1, 3, 3)
    out.sum().backward()
    assert emb.stats["pulls"] == 1 and emb.stats["rows_pulled"] == 3
    assert emb.stats["pushes"] == 1 and emb.stats["rows_pushed"] == 3
    with pytest.raises(ValueError):
        tps.SparseEmbedding(c, 12, 3, config=tps.TableConfig(dim=4),
                            device="cpu")


def test_to_static_refuses_a_sparse_embedding_step(clients):
    from paddle_tpu_torch import jit

    emb = tps.SparseEmbedding(clients["torch"], 13, 2, device="cpu")

    def step(ids):
        return emb(ids).sum()

    with pytest.raises(RuntimeError, match="SparseEmbedding pulls"):
        jit.StaticFunction(step)(np.array([1, 2]))


# ----------------------------------------------------- communicators


def test_async_communicator_merges_and_flushes(clients):
    got = {}
    for name, m in PKGS.items():
        c = clients[name]
        c.create_sparse_table(20, m.TableConfig(dim=2, optimizer="sgd",
                                                learning_rate=1.0,
                                                init_range=0.0))
        comm = m.AsyncCommunicator(c, send_steps=1000, send_interval_s=60.0)
        keys = np.array([7, 8], np.uint64)
        comm.push_sparse_async(20, keys, np.ones((2, 2), np.float32))
        comm.push_sparse_async(20, keys, np.ones((2, 2), np.float32))
        held = c.pull_sparse(20, keys)
        comm.stop()
        got[name] = [held, c.pull_sparse(20, keys)]
    _same(got)
    np.testing.assert_array_equal(got["torch"][0], 0.0)
    np.testing.assert_allclose(got["torch"][1], -2.0)


def test_async_communicator_step_trigger(clients):
    import time

    c = clients["torch"]
    c.create_dense_table(21, 3, tps.TableConfig(optimizer="sgd",
                                                learning_rate=1.0),
                         init=np.zeros(3, np.float32))
    comm = tps.AsyncCommunicator(c, send_steps=2, send_interval_s=60.0)
    comm.push_dense_async(21, np.ones(3, np.float32))
    comm.push_dense_async(21, np.ones(3, np.float32))
    deadline = time.time() + 5
    while time.time() < deadline and not np.allclose(c.pull_dense(21), -2):
        time.sleep(0.02)
    np.testing.assert_allclose(c.pull_dense(21), -2.0)
    comm.stop()


def test_geo_communicator_two_trainers_converge(clients):
    got = {}
    for name, m in PKGS.items():
        c = clients[name]
        a = m.GeoCommunicator(c, send_steps=5)
        b = m.GeoCommunicator(c, send_steps=5)
        w = a.register_dense(30, np.zeros(4, np.float32))
        b.register_dense(30, np.zeros(4, np.float32))
        synced = []
        for _ in range(10):
            w += 0.1
            synced.append(a.step(30))
        for _ in range(10):
            b.local[30] += -0.02
            synced.append(b.step(30))
        a.sync(30)
        b.sync(30)
        got[name] = [c.pull_dense(30), a.local[30], b.local[30], synced,
                     w is a.local[30]]
    _same(got)
    np.testing.assert_allclose(got["torch"][0], 0.8, atol=1e-6)


def test_geo_communicator_local_steps_do_not_touch_server(clients):
    c = clients["torch"]
    g = tps.GeoCommunicator(c, send_steps=100)
    g.register_dense(31, np.zeros(2, np.float32))
    for _ in range(50):
        g.local[31] += 1.0
        assert not g.step(31)
    np.testing.assert_array_equal(c.pull_dense(31), 0.0)
    g.sync(31)
    np.testing.assert_allclose(c.pull_dense(31), 50.0)


def test_sparse_embedding_async_communicator_mode(clients):
    got = {}
    for name, m in PKGS.items():
        c = clients[name]
        comm = m.AsyncCommunicator(c, send_steps=1000, send_interval_s=60.0)
        _, losses, _, _ = _embedding_run(name, m, c, 1, comm=comm)
        keys = np.array([1, 2, 9], np.uint64)
        held = c.pull_sparse(3, keys)
        comm.stop()
        got[name] = (losses, held, c.pull_sparse(3, keys))
    np.testing.assert_array_equal(got["torch"][1], got["jax"][1])
    np.testing.assert_allclose(got["torch"][2], got["jax"][2], rtol=1e-5,
                               atol=1e-7)
    assert np.abs(got["torch"][2] - got["torch"][1]).max() > 0


# ---------------------------------------------- the dense twin, path (c)


def test_sync_step_equals_the_dense_embedding_step(clients):
    """One sync step of a small Wide&Deep through ``SparseEmbedding``
    equals the same model with dense embeddings over the touched rows;
    skipping the push does not."""
    from paddle_tpu_torch.tools import ps_engine_drills as d

    cfg = dict(d.CTR_SMALL, keys=1000, batch=16, fc_sizes=[8])
    rec = d._ctr_trainer_sync(clients["torch"], cfg, "cpu", 3, 0)
    assert max(rec["rows_rel"]) < d.CTR_TOL
    assert min(rec["control_rows_rel"]) > d.CTR_TOL
    assert rec["trunk_max_abs"] == 0.0
    assert rec["loss"] == rec["twin_loss"]
    assert rec["table_rows"][0] == rec["table_rows"][1] > 0


def test_launcher_ps_mode_runs_servers_and_trainers(tmp_path):
    """``distributed.launch --run_mode ps``: two servers and one trainer
    of the drills' role script, the trainer's record written."""
    from paddle_tpu_torch.tools import ps_engine_drills as d

    recs = d._launch_ps(str(tmp_path), 1, "sync", "cpu", True, 3)
    r = recs[0]
    assert r["servers"] == 2 and r["trainers"] == 1 and r["steps"] == 3
    assert max(r["rows_rel"]) < d.CTR_TOL
    assert os.path.exists(tmp_path / "log_sync" / "pserverlog.0")
