"""ZeRO (``paddle_tpu_torch.distributed.group_sharded_parallel``) on two
gloo ranks against the JAX package's ``group_sharded_parallel`` on a
``sharding`` 8 mesh (``tests/test_distributed.py:207``
``test_zero_stages_match_unsharded``) and against the port's
``DataParallel`` on the same two ranks.

The same Sequential (the JAX model's weights carried in), Adam 1e-2 and
3 steps everywhere; the JAX side trains on the whole batch (its ZeRO is
a layout), each port rank on its half (its gradients averaged over the
two). Tolerances: rtol 1e-4, atol 1e-5 against the JAX package (the
JAX test's), bit for bit against ``DataParallel`` (a sum of two floats
is the same in any order, and the update is elementwise), and 1e-6 for
global-norm clipping at ``os_g``, whose norm sums its squares over the
blocks. The ranks are spawned once for the file
(``torch_zero_ranks.group_sharded``); a second pair of two-rank jobs
starts at once to hold the rendezvous (no port is chosen before the
store binds it).
"""
import socket

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.sharding import _shard_spec_for

import torch_zero_ranks
from torch_suite import one_torch_thread  # noqa: F401

LEVELS = torch_zero_ranks.LEVELS


def _data():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((16, 8)).astype("float32"),
            rng.integers(0, 4, (16,)))


def _jax_model():
    pt.seed(7)
    m = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    o = pt.optimizer.Adam(learning_rate=1e-2, parameters=m.parameters())
    return m, o


def _jax_train(m, o, x, y):
    for _ in range(3):
        loss = jF.cross_entropy(m(pt.to_tensor(x)), pt.to_tensor(y))
        loss.backward()
        o.step()
        o.clear_grad()
    return [np.asarray(p.numpy()) for p in m.parameters()]


def _init_sharding(n):
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "sharding_degree": n}
    jfleet.fleet._is_initialized = False
    jfleet.init(strategy=strategy)


def _jax_fleet(x, y, hybrid):
    """The JAX package's fleet with ``strategy.sharding`` on its 8-device
    mesh: the parameters after 3 steps on the whole batch."""
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = dict(hybrid)
    strategy.sharding = True
    jfleet.fleet._is_initialized = False
    try:
        jfleet.init(strategy=strategy)
        m, o = _jax_model()
        m = jfleet.distributed_model(m)
        o = jfleet.distributed_optimizer(o)
        return _jax_train(m, o, x, y)
    finally:
        jdist.set_mesh(None)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The ranks, and the JAX package's three levels worked out while
    they run."""
    from paddle_tpu_torch.distributed import spawn

    x, y = _data()
    weights = {k: np.asarray(v.numpy())
               for k, v in _jax_model()[0].state_dict().items()}
    outdir = str(tmp_path_factory.mktemp("zero"))
    ctx = spawn(torch_zero_ranks.group_sharded,
                args=(weights, x, y, outdir), nprocs=2, join=False,
                backend="cpu")
    jax_levels = {}
    try:
        for level in LEVELS:
            _init_sharding(8)
            m, o = _jax_model()
            m, o = jdist.group_sharded_parallel(m, o, level=level)
            jax_levels[level] = _jax_train(m, o, x, y)
    finally:
        jdist.set_mesh(None)
    jax_levels["fleet_sharding2"] = _jax_fleet(x, y, {"sharding_degree": 2})
    ctx.join()
    res = ctx.results()
    return [res[0], res[1]], jax_levels, outdir


@pytest.mark.parametrize("level", LEVELS)
def test_level_against_jax_and_data_parallel(job, level):
    ranks, jax_levels, _ = job
    for r in ranks:
        for got, dp in zip(r[level], r["dp"]):
            np.testing.assert_array_equal(got, dp)
        for got, j in zip(r[level], jax_levels[level]):
            np.testing.assert_allclose(got, j, rtol=1e-4, atol=1e-5)
    for a, b in zip(ranks[0][level], ranks[1][level]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("level", LEVELS)
def test_state_sharded_on_the_jax_dimension(job, level):
    """Each accumulator is this rank's block along the dimension the JAX
    package's ``_shard_spec_for`` picks, half the whole one; a rank's
    state is half of ``DataParallel``'s but for the 0-d powers."""
    ranks, _, _ = job
    for r in ranks:
        state, total = r[level + "_state"]
        dp_state, dp_total = r["dp_state"]
        halves = 0
        for key, (index, local, shape, nbytes) in state.items():
            spec = _shard_spec_for(shape, "sharding", 2, len(shape))
            dims = [d for d, e in enumerate(spec) if e == "sharding"]
            if not shape:
                assert dims == [] and index == []
                continue
            assert len(dims) == 1, key
            d = dims[0]
            assert local[d] * 2 == shape[d]
            assert index[d] == [r["rank"] * local[d],
                                (r["rank"] + 1) * local[d]], key
            assert nbytes * 2 == dp_state[key][3]
            halves += nbytes
        powers = dp_total - 2 * halves
        assert total == halves + powers and total * 2 == dp_total + powers


def test_p_g_os_holds_half_the_parameters_between_steps(job):
    ranks, _, _ = job
    for r in ranks:
        assert r["p_g_os_resident"] * 2 == r["full_param_bytes"]
        assert r["os_resident"] == r["full_param_bytes"]


def test_global_norm_clipping(job):
    """At ``os`` the whole averaged gradients are clipped, as by
    ``DataParallel``: bit for bit; at ``os_g`` the norm's squares are
    summed over the blocks: 1e-6."""
    ranks, _, _ = job
    for r in ranks:
        for a, b in zip(r["clip_os"], r["clip_dp"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r["clip_os_g"], r["clip_dp"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        # the clip bites: the clipped run is not the unclipped one
        assert any(not np.allclose(a, b)
                   for a, b in zip(r["clip_dp"], r["dp"]))


def test_fleet_strategy_sharding(job):
    ranks, _, _ = job
    for r in ranks:
        assert r["fleet_sharded"]
        for a, b in zip(r["fleet"], r["dp"]):
            np.testing.assert_array_equal(a, b)


def test_fleet_sharding_degree_2(job):
    """``sharding_degree`` 2 with ``dp`` 1: the gradients are averaged
    over the sharding axis (a ZeRO ``os`` wrapper) and the state sharded
    over it; bit for bit against ``DataParallel`` at world 2 and within
    the JAX fleet's tolerance."""
    ranks, jax_levels, _ = job
    want = jax_levels["fleet_sharding2"]
    for r in ranks:
        got = r["fleet_sharding2"]
        assert got["wrapper"] == "GroupShardedModel"
        assert got["zero_ranks"] == 2
        for a, b in zip(got["params"], r["dp"]):
            np.testing.assert_array_equal(a, b)
        for a, j in zip(got["params"], want):
            np.testing.assert_allclose(a, j, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def hybrid_job():
    """Four ranks on a ``dp`` 2 x ``sharding`` 2 mesh."""
    from paddle_tpu_torch.distributed import spawn

    x, y = _data()
    weights = {k: np.asarray(v.numpy())
               for k, v in _jax_model()[0].state_dict().items()}
    ctx = spawn(torch_zero_ranks.group_sharded_hybrid,
                args=(weights, x, y), nprocs=4, join=False, backend="cpu")
    want = _jax_fleet(x, y, {"dp_degree": 4, "sharding_degree": 2})
    ctx.join()
    res = ctx.results()
    return [res[r] for r in range(4)], want


@pytest.mark.parametrize("path", LEVELS + ("fleet",))
def test_dp_by_sharding_mesh_averages_over_both(hybrid_job, path):
    """On a ``dp`` 2 x ``sharding`` 2 mesh the state is sharded over the
    ``sharding`` axis and the gradients averaged over all four ranks:
    every path equals the JAX fleet's full-batch training at rtol 1e-4,
    atol 1e-5, and ``DataParallel`` over the four ranks within 1e-6 (a
    sum of four in another order), the same on every rank."""
    ranks, want = hybrid_job
    for r in ranks:
        got = r["fleet"]["params"] if path == "fleet" else r[path]
        zero = r["fleet"]["zero_ranks"] if path == "fleet" \
            else r[path + "_zero_ranks"]
        assert zero == 2
        for a, j in zip(got, want):
            np.testing.assert_allclose(a, j, rtol=1e-4, atol=1e-5)
        for a, b in zip(got, r["dp"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        for a, b in zip(got, ranks[0]["fleet"]["params"] if path == "fleet"
                        else ranks[0][path]):
            np.testing.assert_array_equal(a, b)


def test_wrappers_release_their_parameters(job):
    """After a step, dropping the model, its ``DataParallel`` or ZeRO
    wrapper and its optimizer frees every parameter: the gradient hooks
    the parameters hold do not keep the wrapper alive."""
    ranks, _, _ = job
    for r in ranks:
        assert r["freed"] == {"dp": 0, "os": 0, "os_g": 0, "p_g_os": 0}


def test_save_group_sharded_model(job):
    """``model.pdmodel`` and ``model.pdopt`` in a directory, written by
    rank 0 whole; a file path is refused."""
    import paddle_tpu_torch as paddle

    ranks, _, outdir = job
    for r in ranks:
        assert r["saved_files"] == ["model.pdmodel", "model.pdopt"]
        assert "should be a directory" in r["file_refused"]
    sd = paddle.load(f"{outdir}/saved/model.pdmodel", device="cpu")
    for v, want in zip(sd.values(), ranks[0]["saved_whole"]):
        np.testing.assert_array_equal(np.asarray(v.numpy()), want)
    opt = paddle.load(f"{outdir}/saved/model.pdopt", device="cpu")
    assert tuple(opt["pos:0.moment1"].shape) == (8, 32)


def test_two_jobs_at_once_rendezvous():
    """Two jobs started together: each parent serves its job's store on
    a port the OS gave it as it bound, held until the join (nothing can
    take it in between), and both jobs complete."""
    from paddle_tpu_torch.distributed import spawn

    jobs = [spawn(torch_zero_ranks.rendezvous_job, nprocs=2, join=False,
                  backend="cpu") for _ in range(2)]
    ports = [j.store.port for j in jobs]
    assert ports[0] != ports[1]
    for port in ports:  # bound by the parents' stores while jobs run
        with socket.socket() as s:
            with pytest.raises(OSError):
                s.bind(("127.0.0.1", port))
    for j, port in zip(jobs, ports):
        j.join(timeout=120)
        assert j.store is None
        for total, used, hosted in j.results().values():
            assert (total, used, hosted) == (2.0, port, "1")
