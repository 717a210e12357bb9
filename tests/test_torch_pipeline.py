"""The port's pipelines (``paddle_tpu_torch.distributed.fleet``:
``StackedPipelineBlocks``, ``pipeline_apply``, VPP, 1F1B, F-then-B,
``PipelineLayer``, ``PipelineParallel``) on four gloo ranks against the
JAX package's (``tests/test_pipeline.py``), and ``SegmentLayers``'s
splits against the JAX package's.

Each case takes the JAX stack's weights (its stacked ``[L, ...]``
arrays, this stage's rows of them loaded) and holds the port against:
the JAX pipelined forward at ``pp`` 4 (``:62``), the JAX stack's
gradients at ``pp`` 1 for the port's at ``pp`` 2 (``:73``), the JAX
1F1B at ``pp`` 4 and at ``pp`` 2 with 8 microbatches (``:181``,
``:215``), the JAX ``train_batch`` through the strategy's 1F1B
(``:241``; the port's F-then-B too), the JAX VPP forward and the ``pp``
1 gradients for VPP's (``:331``, ``:366``), and the two raises
(``:389``, ``:397``); the grad-scaler case (``:270``) holds a scaled
run against an unscaled one, as there. Tolerances are the JAX tests':
rtol 1e-4 with atol 1e-4 (forwards) or 1e-5 (gradients, losses). The
``pp`` 2 cases run on a ``dp`` 2 x ``pp`` 2 mesh: both replicas are
checked. The ranks are spawned once (``torch_zero_ranks.pipelines``).
"""
import json
import os

import jax
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.pipeline_schedule import (
    StackedPipelineBlocks, pipeline_1f1b_train)
from paddle_tpu.distributed.fleet.pipeline_parallel import PipelineParallel
from paddle_tpu.distributed.fleet.pp_layers import (LayerDesc, PipelineLayer,
                                                    SegmentLayers,
                                                    SharedLayerDesc)

import torch_zero_ranks
from torch_suite import one_torch_thread  # noqa: F401

H = 16


class Block(jnn.Layer):
    def __init__(self, h=H):
        super().__init__()
        self.lin = jnn.Linear(h, h)
        self.ln = jnn.LayerNorm(h)

    def forward(self, x):
        return x + jF.gelu(self.lin(self.ln(x)))


def _mesh(pp):
    jdist.set_mesh(None if pp == 1 else jdist.create_mesh(
        {"pp": pp}, devices=jax.devices()[:pp]))


def _stacked(stack):
    return {f"s_{n.replace('.', '__')}": np.asarray(p.value)
            for n, p in zip(stack._param_names, stack.stacked)}


def _lin(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _data():
    rng = np.random.default_rng(20)
    return (rng.standard_normal((16, H)).astype("float32"),
            rng.integers(0, 4, (16,)))


def _build():
    """The JAX stacks and layers of every case (weights only, nothing
    run yet)."""
    built, w = {}, {}
    _mesh(4)
    pt.seed(1)
    built["fwd"] = StackedPipelineBlocks(lambda: Block(H), 8)
    w["fwd_stack"] = _stacked(built["fwd"])
    _mesh(1)
    pt.seed(3)
    built["grad"] = StackedPipelineBlocks(lambda: Block(H), 4, remat=False)
    w["grad_stack"] = _stacked(built["grad"])
    for name, pp, L in (("1f1b_pp4", 4, 8), ("1f1b_pp2", 2, 4)):
        _mesh(pp)
        pt.seed(21)
        parts = (jnn.Linear(H, H),
                 StackedPipelineBlocks(lambda: Block(H), L, remat=False),
                 jnn.Linear(H, 4))
        built[name] = parts
        w[name] = {"prefix": _lin(parts[0]), "stack": _stacked(parts[1]),
                   "head": _lin(parts[2])}
    _mesh(4)
    pt.seed(23)
    parts = (StackedPipelineBlocks(lambda: Block(H), 4), jnn.Linear(H, 4))
    built["train_batch"] = parts
    w["train_batch"] = {"stack": _stacked(parts[0]), "head": _lin(parts[1])}
    _mesh(2)
    pt.seed(31)
    w["scaler"] = {"stack": _stacked(StackedPipelineBlocks(
        lambda: Block(H), 2)), "head": _lin(jnn.Linear(H, 4))}
    _mesh(2)
    pt.seed(41)
    built["vpp"] = StackedPipelineBlocks(lambda: Block(H), 8, remat=False,
                                         vpp=2)
    w["vpp_stack"] = _stacked(built["vpp"])
    _mesh(1)
    pt.seed(41)
    built["vpp_ref"] = StackedPipelineBlocks(lambda: Block(H), 8,
                                             remat=False)
    pt.seed(5)
    built["segmented"] = [Block(H) for _ in range(4)]
    w["segmented"] = [_lin(b) for b in built["segmented"]]
    _mesh(1)
    pt.seed(6)
    built["shared"] = PipelineLayer(
        layers=[SharedLayerDesc("tied", jnn.Linear, None, "weight", H, H),
                LayerDesc(Block, H), LayerDesc(Block, H),
                SharedLayerDesc("tied", jnn.Linear, None, "weight", H, H)],
        loss_fn=lambda o, lab: (o * o).mean())
    w["shared"] = _lin(built["shared"])
    return built, w


def _jax_refs(built, x16, y16):
    x8 = x16[:8]
    T = pt.to_tensor
    ref = {}
    _mesh(4)
    ref["fwd"] = np.asarray(built["fwd"](T(x8), num_microbatches=4).numpy())
    _mesh(1)
    o = built["grad"](T(x8))
    (o * o).mean().backward()
    ref["grad"] = [np.asarray(p.grad.value) for p in built["grad"].stacked]
    for name, pp, M, x, y in (("1f1b_pp4", 4, 4, x8, y16[:8]),
                              ("1f1b_pp2", 2, 8, x16, y16)):
        _mesh(pp)
        prefix, stack, head = built[name]
        loss = pipeline_1f1b_train(
            stack, T(x), T(y), lambda out, lab: jF.cross_entropy(head(out),
                                                                 lab),
            num_microbatches=M, prefix=prefix)
        ref[name] = {
            "loss": float(loss.numpy()),
            "stack": [np.asarray(p.grad.value) for p in stack.stacked],
            "prefix": [np.asarray(p.grad.value)
                       for p in prefix.parameters()],
            "head": [np.asarray(p.grad.value) for p in head.parameters()]}
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "pp_degree": 4,
                               "accumulate_steps": 4}
    strategy.pipeline_configs = {"schedule_mode": "1F1B"}
    _mesh(4)
    stack, head = built["train_batch"]
    model = PipelineLayer(layers=[stack, head],
                          loss_fn=lambda out, lab: jF.cross_entropy(out, lab))
    wrapped = PipelineParallel(model, strategy=strategy)
    opt = pt.optimizer.Adam(learning_rate=1e-2,
                            parameters=model.parameters())
    ref["train_batch"] = [float(wrapped.train_batch(
        (T(x8), T(y16[:8])), opt).numpy()) for _ in range(6)]
    _mesh(2)
    ref["vpp_fwd"] = np.asarray(built["vpp"](T(x8),
                                             num_microbatches=4).numpy())
    ref["vpp_order"] = list(built["vpp"].layer_order)
    _mesh(1)
    o = built["vpp_ref"](T(x8))
    (o * o).mean().backward()
    ref["vpp_grad"] = [np.asarray(p.grad.value)
                       for p in built["vpp_ref"].stacked]
    h = T(x8)
    for b in built["segmented"]:
        h = b(h)
    ref["segmented"] = np.asarray((h).numpy())
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "accumulate_steps": 2}
    model = built["shared"]
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    loss = PipelineParallel(model, strategy=strategy).train_batch(
        (T(x8), T(y16[:8])), opt)
    ref["shared"] = (float(loss.numpy()), _lin(model))
    jdist.set_mesh(None)
    return ref


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    from paddle_tpu_torch.distributed import spawn

    x16, y16 = _data()
    outdir = tmp_path_factory.mktemp("pp")
    try:
        built, w = _build()
        ctx = spawn(torch_zero_ranks.pipelines, args=(w, x16, y16,
                                                      str(outdir)),
                    nprocs=4, join=False, backend="cpu")
        ref = _jax_refs(built, x16, y16)
        # a JAX pp 4 save of the same stack, for its shard records
        _mesh(4)
        jckpt.save_state_dict(built["fwd"].state_dict(),
                              str(outdir / "jax_stack_ck")).wait()
    finally:
        jdist.set_mesh(None)
    ctx.join()
    res = ctx.results()
    return [res[r] for r in range(4)], ref, w, outdir


def _held_rows(got, ref_full, rtol=1e-4, atol=1e-5):
    """A stage's row gradients against the JAX stack's whole ones (its
    rows by layer index)."""
    for g, r in zip(got["grads"], ref_full):
        np.testing.assert_allclose(g, r[got["rows"]], rtol=rtol, atol=atol)


def test_segment_layers_split_as_jax():
    from paddle_tpu_torch.distributed.fleet import pp_layers as port

    class TransformerBlock:
        pass

    descs = [LayerDesc(jnn.Linear, 4, 4), LayerDesc(TransformerBlock),
             LayerDesc(jnn.Linear, 8, 8), LayerDesc(TransformerBlock),
             LayerDesc(TransformerBlock), LayerDesc(jnn.Linear, 2, 2),
             LayerDesc(TransformerBlock)]
    pdescs = [port.LayerDesc(d.layer_func, *d.inputs) for d in descs]
    for method in ("uniform", "layer:TransformerBlock", "parameters"):
        for parts in (2, 3, 4):
            want = SegmentLayers(descs, parts, method=method).do_segment()
            got = port.SegmentLayers(pdescs, parts,
                                     method=method).do_segment()
            assert got == want, (method, parts)
    with pytest.raises(ValueError, match="cannot split"):
        port.SegmentLayers(pdescs, 8).do_segment()


def test_pipelined_forward_pp4(job):
    ranks, ref, _, _ = job
    for r in ranks:
        np.testing.assert_allclose(r["fwd"], ref["fwd"], rtol=1e-4,
                                   atol=1e-4)


def test_gradients_through_the_pipeline_against_pp1(job):
    ranks, ref, _, _ = job
    for r in ranks:
        _held_rows(r["grad"], ref["grad"])
    assert sorted({tuple(r["grad"]["rows"]) for r in ranks}) == [(0, 1),
                                                                 (2, 3)]


@pytest.mark.parametrize("name", ["1f1b_pp4", "1f1b_pp2"])
def test_1f1b_against_jax(job, name):
    ranks, ref, _, _ = job
    P = 4 if name == "1f1b_pp4" else 2
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["loss"], ref[name]["loss"],
                                   rtol=1e-4, atol=1e-5)
        _held_rows(got, ref[name]["stack"])
        for key in ("prefix", "head"):
            for g, want in zip(got[key], ref[name][key]):
                np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5)
        # at most P - stage microbatches in flight on a stage
        assert got["in_flight"] == P - got["stage"]


def test_train_batch_through_the_strategy(job):
    """1F1B against the JAX ``train_batch``; F-then-B is the same mean
    loss and gradients, another order."""
    ranks, ref, _, _ = job
    for r in ranks:
        assert r["wrapped_1F1B"] == ("PipelineParallel", "1F1B")
        assert r["wrapped_F-then-B"] == ("PipelineParallel", "F-then-B")
        np.testing.assert_allclose(r["train_batch_1F1B"],
                                   ref["train_batch"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["train_batch_F-then-B"],
                                   ref["train_batch"], rtol=1e-4, atol=1e-5)
        assert r["train_batch_1F1B"][-1] < r["train_batch_1F1B"][0]


def test_grad_scaler(job):
    ranks, _, _, _ = job
    for r in ranks:
        (loss0, params0, same_entries), (loss1, params1, _) = r["scaler"]
        assert same_entries
        np.testing.assert_allclose(loss0, loss1, rtol=1e-5)
        for a, b in zip(params0, params1):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_vpp_forward_and_gradients(job):
    ranks, ref, _, _ = job
    order = ref["vpp_order"]
    for r in ranks:
        assert r["vpp_order"] == order
        np.testing.assert_allclose(r["vpp_fwd"], ref["vpp_fwd"], rtol=1e-4,
                                   atol=1e-4)
        # a stage's rows are layers order[lo:hi] (device-major)
        assert r["vpp_grad"]["rows"] == order[4 * r["vpp_grad"]["stage"]:
                                              4 * r["vpp_grad"]["stage"] + 4]
        _held_rows(r["vpp_grad"], ref["vpp_grad"])


def test_the_two_raises(job):
    ranks, _, _, _ = job
    for r in ranks:
        assert "microbatches" in r["raise_microbatches"]
        assert "divisible" in r["raise_divisible"]


def test_segmented_pipeline_layer(job):
    """Each stage builds its own two of the four layers; the pipelined
    forward gives the JAX layers' output on every stage."""
    ranks, ref, _, _ = job
    for r in ranks:
        assert r["segmented_built"] == 2
        np.testing.assert_allclose(r["segmented_fwd"], ref["segmented"],
                                   rtol=1e-5, atol=1e-5)


def test_stage_ids_and_neighbours(job):
    """On the dp 2 x pp 2 mesh (``pp`` innermost after ``dp``: ranks 0-1
    and 2-3 form the pp groups) each rank's stage is its ``pp``
    coordinate, and its neighbours are its group's other rank."""
    ranks, _, _, _ = job
    for r in ranks:
        stage, first, last, nxt, prev, group = r["hcg"]
        assert group == [r["rank"] - r["rank"] % 2, r["rank"] - r["rank"] % 2
                         + 1]
        assert stage == group.index(r["rank"])
        assert (first, last) == (stage == 0, stage == 1)
        assert nxt == prev == group[1 - stage]


def test_stage_rows_save_as_the_jax_pp_save(job):
    """The four stages' ``state_dict()`` saved together gives the JAX
    package the whole ``[L, ...]`` leaves, with a JAX pp 4 save's shard
    records; loaded back through ``target=`` each stage gets its rows."""
    ranks, _, w, outdir = job

    def records(d):
        out = {}
        for f in sorted(os.listdir(d)):
            if f.startswith("checkpoint.metadata.json"):
                for k, e in json.loads((d / f).read_text())["leaves"].items():
                    out.setdefault(k, []).extend(s["index"]
                                                 for s in e["shards"])
        return {k: sorted(v) for k, v in out.items()}

    assert records(outdir / "stack_ck") == records(outdir / "jax_stack_ck")
    got = jckpt.load_state_dict(str(outdir / "stack_ck"))
    for k, v in w["fwd_stack"].items():
        np.testing.assert_array_equal(np.asarray(got[k].numpy()), v)
    for r in ranks:
        assert r["stack_reload_equal"]


@pytest.mark.parametrize("schedule", ["F-then-B", "1F1B"])
def test_shared_layer_across_stages(job, schedule):
    """A tied Linear at both ends of a segmented ``PipelineLayer``: each
    stage builds its two entries, the tied weight's gradients are summed
    over the stages, and one SGD step equals the JAX pipeline layer's."""
    ranks, ref, _, _ = job
    want_loss, want = ref["shared"]
    for r in ranks:
        loss, got = r["shared_" + schedule]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-6)
        assert got and set(got) <= set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
