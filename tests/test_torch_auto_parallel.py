"""The port's auto-parallel ``Engine`` against the JAX package's
(``tests/test_auto_parallel.py``): the same ToyDataset, the same
Sequential (the JAX weights carried in), Adam(1e-2) and the same shuffled
batches (both samplers seeded by ``paddle.seed(0)``). In this process at
world size 1 (``Engine`` starts fleet's mesh over its one rank): ``fit``,
``evaluate``, ``predict``, ``save``/``load`` (across the packages too)
and ``cost``; on two gloo ranks spawned once for the file
(``torch_ps_ranks.engine_job``): each rank its half of every batch,
the loss and the metrics over the whole batch, ``predict`` gathered,
against the JAX ``Engine`` on its 8-device ``dp`` mesh. Tolerances: rtol
1e-4, atol 1e-6 (f32: XLA's and torch's products and Adam's arithmetic
in another order; two halves against one batch).
"""
import numpy as np
import pytest
from torch_suite import one_torch_thread  # noqa: F401

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import auto as jauto
from paddle_tpu.io import Dataset
from paddle_tpu.metric import Accuracy as JAccuracy

import torch_ps_ranks

TOL = dict(rtol=1e-4, atol=1e-6)


class ToyDataset(Dataset):
    def __init__(self, n=64, d=8, classes=4, seed=0):
        rng = np.random.default_rng(seed)
        self.w = rng.standard_normal((d, classes)).astype("float32")
        self.x = rng.standard_normal((n, d)).astype("float32")
        self.y = (self.x @ self.w).argmax(-1).astype("int64")

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


@pytest.fixture(autouse=True)
def _reset():
    import paddle_tpu_torch as paddle

    prev = paddle.get_device() if paddle.device._current is not None \
        else None
    paddle.set_device("cpu")
    yield
    _teardown()
    paddle.set_device(prev)


def _teardown():
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import fleet, topology

    jdist.set_mesh(None)
    jfleet.fleet._is_initialized = False
    if tdist.is_initialized():
        tdist.destroy_process_group()
    topology.set_mesh(None)
    fleet.fleet._is_initialized = False


def _jax_engine(metrics=True):
    jpaddle.seed(0)
    model = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    opt = jpaddle.optimizer.Adam(learning_rate=1e-2,
                                 parameters=model.parameters())
    eng = jauto.Engine(model, jnn.CrossEntropyLoss(), opt,
                       metrics=JAccuracy() if metrics else None)
    return eng, model


def _weights(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Engine: weights at the start, fit's history and weights,
    evaluate and predict; the mesh it built."""
    eng, model = _jax_engine()
    w0 = _weights(model)
    hist = eng.fit(ToyDataset(), batch_size=16, epochs=2, verbose=0)
    out = {"w0": w0, "hist": hist, "w": _weights(model),
           "mesh_dp": jdist.get_mesh().shape["dp"],
           "eval": eng.evaluate(ToyDataset(), batch_size=16, verbose=0),
           "predict": eng.predict(ToyDataset(n=32), batch_size=16),
           "cost": eng.cost()}
    _teardown()
    return out


def test_fit_evaluate_predict_as_the_jax_engine(jax_run):
    import paddle_tpu_torch.distributed as dist

    eng, model = torch_ps_ranks.engine(jax_run["w0"])
    assert eng.cost() is None  # nothing has run
    hist = eng.fit(ToyDataset(), batch_size=16, epochs=2, verbose=0)
    assert dist.get_mesh().shape["dp"] == 1 and jax_run["mesh_dp"] == 8
    np.testing.assert_allclose(hist["loss"], jax_run["hist"]["loss"], **TOL)
    assert hist["acc"] == pytest.approx(jax_run["hist"]["acc"])
    assert hist["loss"][-1] < hist["loss"][0]
    for k, v in jax_run["w"].items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v, **TOL)
    ev = eng.evaluate(ToyDataset(), batch_size=16, verbose=0)
    assert ev["loss"] == pytest.approx(jax_run["eval"]["loss"], rel=1e-4)
    assert ev["acc"] == jax_run["eval"]["acc"] and ev["acc"] > 0.5
    outs = eng.predict(ToyDataset(n=32), batch_size=16)
    assert len(outs) == 2 and outs[0].shape == (16, 4)
    for a, b in zip(outs, jax_run["predict"]):
        np.testing.assert_allclose(a, b, **TOL)
    # cost: the products FlopCounterMode counts on the first step (16
    # rows: forward 2*16*(8*32 + 32*4), backward both weights' products
    # and the hidden layer's input gradient)
    cost = eng.cost()
    fwd = 2 * 16 * (8 * 32 + 32 * 4)
    assert cost["flops"] == fwd + fwd + 2 * 16 * 32 * 4
    assert cost["flops_kernels"] == 0 and cost["peak_bytes"] is None
    assert any("flops" in k for k in jax_run["cost"])
    assert eng._steps["train"].compile_counts()["calls"] == 8


def test_save_load_roundtrip_and_across_packages(jax_run, tmp_path):
    eng, model = torch_ps_ranks.engine(jax_run["w0"])
    eng.fit(ToyDataset(), batch_size=16, epochs=1, verbose=0)
    eng.save(str(tmp_path / "port"))
    eng2, model2 = torch_ps_ranks.engine(jax_run["w0"])
    eng2.load(str(tmp_path / "port"))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(model2.state_dict()[k].numpy(),
                                      v.numpy())
    assert eng2._optimizer.state_dict().keys() \
        == eng._optimizer.state_dict().keys()
    # a JAX Engine's checkpoint loads into the port's model
    jeng, jmodel = _jax_engine()
    jeng.save(str(tmp_path / "jax"), training=False)
    eng3, model3 = torch_ps_ranks.engine(
        {k: np.zeros_like(v) for k, v in jax_run["w0"].items()})
    eng3.load(str(tmp_path / "jax"), load_optimizer=False)
    for k, v in _weights(jmodel).items():
        np.testing.assert_array_equal(model3.state_dict()[k].numpy(), v)


def test_prepare_and_cost_for_an_input_spec(jax_run):
    from paddle_tpu_torch.jit import InputSpec

    eng, _ = torch_ps_ranks.engine(jax_run["w0"])
    cost = eng.cost(InputSpec([4, 8], "float32"), InputSpec([4], "int64"),
                    mode="eval")
    assert cost["flops"] == 2 * 4 * (8 * 32 + 32 * 4)
    assert eng.cost(mode="train") is None


def test_fit_needs_loss_and_optimizer(jax_run):
    from paddle_tpu_torch.distributed.fleet import auto

    eng = auto.Engine(torch_ps_ranks._mlp(jax_run["w0"]))
    with pytest.raises(RuntimeError, match="must all be set"):
        eng.fit(ToyDataset(), batch_size=16)
    assert auto.Strategy({"amp": {"enable": True}}).amp.enable is True


# ------------------------------------------------- two ranks on gloo
@pytest.fixture(scope="module")
def ranks(jax_run):
    from paddle_tpu_torch.distributed import spawn

    ds = ToyDataset()
    ctx = spawn(torch_ps_ranks.engine_job, args=(jax_run["w0"], ds.x, ds.y),
                nprocs=2, backend="cpu")
    res = ctx.results()
    return res[0], res[1]


def test_each_rank_keeps_its_rows_and_an_uneven_batch_whole(ranks):
    x = ToyDataset().x
    for r in ranks:
        assert r["mesh_dp"] == 2
        half = slice(r["rank"] * 8, (r["rank"] + 1) * 8)
        np.testing.assert_array_equal(r["rows_even"], x[:16][half])
        np.testing.assert_array_equal(r["rows_odd"], x[:15])
        assert "gloo" in r["eager_reason"]


def test_two_ranks_train_as_the_jax_dp_mesh(ranks, jax_run):
    r0, r1 = ranks
    for r in ranks:
        np.testing.assert_allclose(r["loss"], jax_run["hist"]["loss"], **TOL)
        assert r["acc"] == pytest.approx(jax_run["hist"]["acc"])
        assert r["eval"]["acc"] == jax_run["eval"]["acc"]
        assert r["eval"]["loss"] == pytest.approx(jax_run["eval"]["loss"],
                                                  rel=1e-4)
        for a, b in zip(r["predict"], jax_run["predict"]):
            assert a.shape == (16, 4)
            np.testing.assert_allclose(a, b, **TOL)
        for got, (k, want) in zip(r["weights"], jax_run["w"].items()):
            np.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(r0["weights"], r1["weights"]):
        np.testing.assert_array_equal(a, b)


def test_engine_keeps_an_existing_hybrid_mesh(ranks):
    for r in ranks:
        h = r["hybrid"]
        assert (h["dp"], h["mp"]) == (1, 2)
        assert h["loss"][0] is not None and not h["wrapped"]
    assert ranks[0]["hybrid"]["loss"] == ranks[1]["hybrid"]["loss"]
