"""The port's collectives, groups, ``shard_map_fn``, topology and
placements on four gloo ranks, against the JAX package's on a 4-device
sub-mesh of the conftest's 8 (``tests/test_distributed.py:32-100``,
``:283-358``).

The four ranks are spawned once for the file (``torch_dist_ranks.
collectives``, one intra-op thread a rank) and run every case; each test
holds what a rank got against the value worked out from the four ranks'
inputs (``tools/dist_cases.py``) and, where the JAX package has the
collective, against its ``shard_map`` run on the same numpy inputs. The
JAX package's collectives act inside ``shard_map`` only and give every
rank the result of ``reduce`` and ``gather``; the port's act on each
rank's tensor, so ``reduce`` is held on its ``dst`` rank. The ranks also
run the four mp layers on the mesh's ``mp`` groups of 2, held against the
JAX layers on a ``{"mp": 2}`` sub-mesh (worked out while the ranks run)
and numpy's dense layers (``tests/test_distributed.py:106-170``): the
port's ranks hold Megatron shards of the same weights, their gradients
gathered whole. Tolerances: 1e-6 (f32 sums of four values), 2e-2 for the
bf16 sum, 1e-5 for the layers.
"""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu.nn.functional as jF
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.tools import dist_cases

import torch_dist_ranks

WORLD = 4
TOL = 1e-5  # the mp layers: f32 partial products summed in another order


def _layers():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype("float32")  # noqa: E731
    return {"mlp": {"w1": f(16, 32) * 0.3, "b1": f(32) * 0.1,
                    "w2": f(32, 8) * 0.3, "b2": f(8) * 0.1, "x": f(4, 16)},
            "embedding": {"w": f(32, 16),
                          "ids": np.array([[0, 5, 31], [7, 8, 15]])},
            "ce": {"logits": f(4, 16), "labels": np.array([1, 0, 15, 7])}}


def _jax_layers():
    """The JAX mp layers on a ``{"mp": 2}`` mesh over ``_layers()``' whole
    weights: outputs and gradients."""
    L, E, C = (_layers()[k] for k in ("mlp", "embedding", "ce"))
    jdist.set_mesh(jdist.create_mesh({"mp": 2}, devices=jax.devices()[:2]))
    try:
        col = jfleet.ColumnParallelLinear(16, 32, gather_output=False)
        row = jfleet.RowParallelLinear(32, 8, input_is_parallel=True)
        for p, v in ((col.weight, L["w1"]), (col.bias, L["b1"]),
                     (row.weight, L["w2"]), (row.bias, L["b2"])):
            p._set_value(pt.to_tensor(v).value)
        x = pt.to_tensor(L["x"])
        x.stop_gradient = False
        out = row(jF.relu(col(x)))
        out.sum().backward()
        mlp = {"out": out.numpy(), "x_grad": x.grad.numpy(),
               "w1_grad": np.asarray(col.weight.grad.numpy()),
               "b1_grad": np.asarray(col.bias.grad.numpy()),
               "w2_grad": np.asarray(row.weight.grad.numpy()),
               "b2_grad": np.asarray(row.bias.grad.numpy())}
        vpe = jfleet.VocabParallelEmbedding(32, 16)
        vpe.weight._set_value(pt.to_tensor(E["w"]).value)
        e = vpe(pt.to_tensor(E["ids"]))
        (e * e).sum().backward()
        emb = {"out": e.numpy(), "w_grad": np.asarray(vpe.weight.grad.numpy())}
        lt = pt.to_tensor(C["logits"])
        lt.stop_gradient = False
        loss = jfleet.ParallelCrossEntropy()(lt, pt.to_tensor(C["labels"]))
        loss.sum().backward()
        ref = jF.cross_entropy(pt.to_tensor(C["logits"]),
                               pt.to_tensor(C["labels"]), reduction="none")
        ce = {"loss": loss.numpy(), "grad": lt.grad.numpy(),
              "dense": ref.numpy()}
    finally:
        jdist.set_mesh(None)
    return {"mlp": mlp, "embedding": emb, "ce": ce}


@pytest.fixture(scope="module")
def job():
    """The four ranks' job, started first; the JAX mp layers' references
    are worked out while it runs."""
    ctx = spawn(torch_dist_ranks.collectives, args=(_layers(),),
                nprocs=WORLD, join=False, backend="cpu")
    ref = _jax_layers()
    ctx.join()
    res = ctx.results()
    return [res[r] for r in range(WORLD)], ref


@pytest.fixture(scope="module")
def ranks(job):
    return job[0]


@pytest.fixture(scope="module")
def jax_layers(job):
    return job[1]


@pytest.fixture
def jmesh():
    jdist.set_mesh(jdist.create_mesh({"dp": WORLD},
                                     devices=jax.devices()[:WORLD]))
    yield jdist.new_group(axis="dp")
    jdist.set_mesh(None)


def _inputs(case):
    return [dist_cases.rank_input(case, r, WORLD) for r in range(WORLD)]


def _jax(fn, xs, in_spec=P("dp")):
    x = np.concatenate(xs) if in_spec == P("dp") else xs
    wrapped = jdist.shard_map_fn(fn, in_specs=(in_spec,), out_specs=P("dp"))
    out = np.asarray(wrapped(pt.to_tensor(x)).numpy())
    return np.split(out, WORLD)


def _jax_case(case, g):
    xs = _inputs(case)
    R = jdist.ReduceOp
    ops = {"all_reduce_sum": R.SUM, "all_reduce_max": R.MAX,
           "all_reduce_min": R.MIN, "all_reduce_prod": R.PROD,
           "all_reduce_avg": R.AVG}
    if case in ops:
        return _jax(lambda t: jdist.all_reduce(t, op=ops[case], group=g), xs)
    if case in ("all_gather_list", "gather"):
        return [o.reshape(WORLD, -1, 3) for o in _jax(
            lambda t: jdist.all_gather(None, t, group=g), xs)]
    if case == "all_gather_axis1":
        return _jax(lambda t: jdist.all_gather(None, t, group=g,
                                               axis_dim=1), xs)
    if case == "broadcast":
        return _jax(lambda t: jdist.broadcast(t, src=1, group=g), xs)
    if case == "reduce":
        return _jax(lambda t: jdist.reduce(t, dst=0, group=g), xs)[:1]
    if case == "scatter_list":
        stacked = xs[0].reshape(WORLD, -1, 3)
        return _jax(lambda t: jdist.scatter(t, group=g), stacked,
                    in_spec=P())
    if case in ("alltoall", "alltoall_single"):
        return _jax(lambda t: jdist.alltoall(t, group=g), xs)
    if case == "reduce_scatter_sum":
        return _jax(lambda t: jdist.reduce_scatter(t, group=g), xs)
    if case == "reduce_scatter_avg":
        return _jax(lambda t: jdist.reduce_scatter(t, op=R.AVG, group=g), xs)
    if case == "batch_isend_irecv":
        def ring(t):
            return jdist.batch_isend_irecv([
                jdist.P2POp(jdist.isend, t, 1, group=g),
                jdist.P2POp(jdist.irecv, t, -1, group=g)])[0]
        return _jax(ring, xs)
    if case == "stream_all_reduce":
        from paddle_tpu.distributed import communication

        return _jax(lambda t: communication.stream.all_reduce(
            t, group=g, use_calc_stream=True), xs)
    return None


@pytest.mark.parametrize("case", list(dist_cases.CASES))
def test_collective_case(ranks, jmesh, case):
    xs = _inputs(case)
    got = [r["cases"][case] for r in ranks]
    for rank in range(WORLD):
        want = dist_cases.expected(case, xs, rank)
        assert dist_cases.held(case, got[rank], want), (case, rank)
    ref = _jax_case(case, jmesh)
    if ref is not None:
        tol = 2e-2 if case.endswith("bf16") else 1e-6
        for rank, r in enumerate(ref):
            np.testing.assert_allclose(got[rank], r, rtol=tol, atol=tol)


def test_column_row_mlp_forward_backward(ranks, jax_layers):
    """Column -> ReLU -> row on ``mp`` 2 (each rank of the 2 x 2 mesh in
    its ``mp`` group), forward and backward, against the JAX layers and
    numpy's dense MLP (``test_distributed.py:106-150``); also the
    gathering column layer into a splitting row layer, and
    ``distributed.split``."""
    L = _layers()["mlp"]
    want = jax_layers["mlp"]
    h = L["x"] @ L["w1"] + L["b1"]
    dense = np.maximum(h, 0) @ L["w2"] + L["b2"]
    dh = np.ones((4, 8), "float32") @ L["w2"].T * (h > 0)
    np.testing.assert_allclose(want["out"], dense, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(want["w1_grad"], L["x"].T @ dh, rtol=TOL,
                               atol=TOL)
    for r in ranks:
        got = r["mp_layers"]
        for k, v in want.items():
            np.testing.assert_allclose(got["mlp"][k], v, rtol=TOL, atol=TOL,
                                       err_msg=k)
        np.testing.assert_allclose(got["mlp_gathered"], want["out"],
                                   rtol=TOL, atol=TOL)
        assert got["split_shape"] == [4, 32]


def test_vocab_parallel_embedding(ranks, jax_layers):
    E = _layers()["embedding"]
    want = jax_layers["embedding"]
    np.testing.assert_allclose(want["out"], E["w"][E["ids"]], rtol=TOL,
                               atol=TOL)
    g = want["w_grad"]
    assert g[5].any() and not g[1].any()
    for r in ranks:
        got = r["mp_layers"]["embedding"]
        np.testing.assert_allclose(got["out"], want["out"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["w_grad"], g, rtol=TOL, atol=TOL)


def test_parallel_cross_entropy(ranks, jax_layers):
    want = jax_layers["ce"]
    np.testing.assert_allclose(want["loss"].squeeze(),
                               want["dense"].squeeze(), rtol=TOL, atol=TOL)
    for r in ranks:
        got = r["mp_layers"]["ce"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["grad"], want["grad"], rtol=TOL,
                                   atol=TOL)


def test_lone_isend_raises_in_both():
    with pytest.raises(RuntimeError, match="batch_isend_irecv"):
        jdist.isend(pt.to_tensor(np.zeros(2, "float32")), 1)
    import paddle_tpu_torch.distributed as tdist

    with pytest.raises(RuntimeError, match="batch_isend_irecv"):
        tdist.isend(np.zeros(2, "float32"), 1)


def test_shard_map_twins(ranks, jmesh):
    """The JAX tests' shard_map cases (``test_distributed.py:73-100``,
    ``:283-358``) at four ranks: every rank assembles the same output."""
    g = jmesh
    sm = [r["shard_map"] for r in ranks]
    a = np.arange(WORLD, dtype="float32")
    x = np.arange(WORLD * WORLD * 16, dtype="float32").reshape(-1, 4)
    xr = np.tile(a, (WORLD, 1)).reshape(-1)

    def run(fn, arr, out=P("dp")):
        w = jdist.shard_map_fn(fn, in_specs=(P("dp"),), out_specs=out)
        return np.asarray(w(pt.to_tensor(arr)).numpy())

    want = {
        "all_reduce": run(lambda t: jdist.all_reduce(t, group=g), a, P()),
        "alltoall": run(lambda t: jdist.alltoall(t, group=g), x),
        "reduce_scatter_sum": run(lambda t: jdist.reduce_scatter(
            t, group=g), xr),
        "reduce_scatter_avg": run(lambda t: jdist.reduce_scatter(
            t, op=jdist.ReduceOp.AVG, group=g), xr),
        "gather": run(lambda t: jdist.gather(t, dst=0, group=g), a, P()),
        "ring": run(lambda t: jdist.batch_isend_irecv([
            jdist.P2POp(jdist.isend, t, 1, group=g),
            jdist.P2POp(jdist.irecv, t, -1, group=g)])[0], a),
    }
    from paddle_tpu.distributed import communication

    want["stream"] = run(lambda t: communication.stream.all_reduce(
        t, group=g, use_calc_stream=True), np.ones(WORLD, "float32"), P())
    np.testing.assert_allclose(want["all_reduce"], [a.sum()])
    np.testing.assert_allclose(want["ring"], np.roll(a, 1))
    for name, w in want.items():
        for rank in range(WORLD):
            np.testing.assert_allclose(
                np.asarray(sm[rank][name]).reshape(np.shape(w)), w,
                rtol=1e-6, atol=1e-6, err_msg=f"{name} rank {rank}")


def test_group_ids_and_subgroups(ranks, jmesh):
    """Ids count from 0 in creation order, as the JAX package's do; a
    two-rank group reduces over its members only."""
    jnext = jdist.new_group(axis="dp")
    assert jnext.id == jmesh.id + 1
    for r in ranks:
        ids = r["groups"]["ids"]
        assert ids == [0, 1, 2]
        assert r["groups"]["get_group"]
    for rank, r in enumerate(ranks):
        want = 3.0 if rank < 2 else rank + 1.0
        np.testing.assert_array_equal(r["groups"]["g2_sum"], [want, want])
        assert r["groups"]["g2_rank"] == (rank if rank < 2 else -1)


def test_topology_on_a_2x2_mesh(ranks):
    """``HybridCommunicateGroup`` at dp 2 x mp 2 against the JAX one's
    degrees (``test_distributed.py:32-52``); each rank's groups are the
    ranks of its row and column, mp innermost."""
    jdist.set_mesh(None)
    jhcg = jdist.HybridCommunicateGroup(
        dp_degree=2, mp_degree=2, devices=jax.devices()[:4])
    try:
        for rank, r in enumerate(ranks):
            t = r["topology"]
            assert t["dp"] == jhcg.get_data_parallel_world_size() == 2
            assert t["mp"] == jhcg.get_model_parallel_world_size() == 2
            assert t["pp"] == jhcg.get_pipe_parallel_world_size() == 1
            assert t["mesh_mp"] == jdist.get_mesh().shape["mp"]
            assert t["axes"] == list(jdist.get_mesh().axis_names)
            assert (t["dp_rank"], t["mp_rank"]) == (rank // 2, rank % 2)
            assert t["mp_group"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
            assert t["dp_group"] == [rank % 2, rank % 2 + 2]
            assert t["created"] == 2
    finally:
        jdist.set_mesh(None)


def test_communicate_topology_matches_jax():
    from paddle_tpu_torch.distributed import CommunicateTopology

    for T in (CommunicateTopology, jdist.CommunicateTopology):
        topo = T(["data", "model"], [2, 4])
        assert topo.world_size() == 8
        assert topo.get_rank(data=1, model=2) == 6
        assert topo.get_axis_list("model", 0) == [0, 4]
        assert topo.get_comm_list("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_placements_and_reshard(ranks):
    """``shard_tensor`` and ``reshard`` on DTensor against the JAX ones
    (``test_distributed.py:55-72``): the same shard shapes on the
    hybrid mesh, the whole value back after a reshard to replicated, and
    each rank's block of a 2 x 2 ``ProcessMesh``."""
    xs = np.arange(64, dtype="float32").reshape(8, 8)
    jdist.set_mesh(None)
    jdist.HybridCommunicateGroup(dp_degree=2, mp_degree=2,
                                 devices=jax.devices()[:4])
    try:
        ja = jdist.shard_tensor(pt.to_tensor(xs),
                                placements=[jdist.Shard(0),
                                            jdist.Replicate()])
        jshapes = {tuple(s.data.shape) for s in ja.value.addressable_shards}
        jb = jdist.shard_tensor(pt.to_tensor(xs),
                                placements=[jdist.Shard(0), jdist.Shard(1)])
        jc = jdist.reshard(jb, placements=[jdist.Replicate(),
                                           jdist.Replicate()])
        np.testing.assert_array_equal(np.asarray(jc.value), xs)
    finally:
        jdist.set_mesh(None)
    for rank, r in enumerate(ranks):
        p = r["placements"]
        assert {tuple(p["a_local"])} == jshapes == {(4, 8)}
        np.testing.assert_array_equal(p["a_full"], xs)
        np.testing.assert_array_equal(p["c_local"], xs)
        i, j = divmod(rank, 2)
        np.testing.assert_array_equal(p["d_local"],
                                      xs[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        np.testing.assert_array_equal(p["e_local"], xs)
        assert "Shard(dim=0)" in p["dist_attr"]
