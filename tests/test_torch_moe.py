"""The port's MoE (``paddle_tpu_torch.incubate.distributed.models.moe``)
against the JAX package's, the twins of every test of
``tests/test_moe.py`` at its tolerances, the JAX layers' weights carried
into the port's (``set_state_dict``):

- ``limit_by_capacity``; identical experts against the dense formula;
  forced routing; every gate's forward and backward (naive in training;
  gshard in training with ``random_routing=False``, switch in eval: their
  random draws do not cross between packages, and their random paths
  are run for their finite loss and gradients alone); gshard's eval
  determinism; capacity drops; the MoE grad clip;
- expert parallelism: the JAX layer's forward on ``dp`` 8 and the
  port's forward and backward on two gloo ranks
  (``torch_sep_moe_ranks.moe_cases``, each rank its half of the tokens,
  wrapped in ``DataParallel``), the output and every gradient against
  the local path of both packages;
- gshard top-2 in training at ``ep`` 2 against the JAX package's gate on
  the whole batch: the capacity over the global arrival order (capacity
  rate 0.2, so that tokens drop: with top-2 over distinct experts an
  expert receives at most ``T`` entries, so the default rate 1.2 drops
  none) and the aux loss of the global means; and the MoE clip's factor
  at ``ep`` 2 against the local clip on the same gradients.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.nn.layer.container import LayerList as JaxLayerList

import paddle_tpu_torch as paddle
import torch_sep_moe_ranks
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import one_thread  # noqa: F401

D_MODEL, D_HIDDEN, E = 8, 16, 4
GSHARD_CAP = (0.2, 0.4)


def _input(B=2, S=8, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D_MODEL)).astype("float32")


def _np(t):
    return np.asarray(t.numpy())


def _pair(n=E, seed=0, gate=None, **kw):
    """The JAX MoE layer (experts from ``seed``) and the port's with its
    weights. ``gate``: a dict, or a function of the package's moe module
    making a gate."""
    pt.seed(seed)
    experts = JaxLayerList([jmoe.ExpertLayer(D_MODEL, D_HIDDEN)
                            for _ in range(n)])
    jm = jmoe.MoELayer(D_MODEL, experts,
                       gate=gate(jmoe) if callable(gate) else gate, **kw)
    tm = tmoe.MoELayer(D_MODEL, [tmoe.ExpertLayer(D_MODEL, D_HIDDEN)
                                 for _ in range(n)],
                       gate=gate(tmoe) if callable(gate) else gate, **kw)
    tm.set_state_dict({k: paddle.to_tensor(_np(v))
                       for k, v in jm.state_dict().items()})
    return jm, tm


def _run(P, moe, x, aux=0.0):
    out = moe(P.to_tensor(x))
    loss = out.pow(2).mean()
    if aux and moe.gate.has_loss:
        loss = loss + aux * moe.gate.get_loss()
    loss.backward()
    return (_np(out), float(_np(loss)),
            {k: _np(p.grad) for k, p in moe.named_parameters()
             if p.grad is not None})


def _same_run(got, want, tol=1e-5):
    np.testing.assert_allclose(got[0], want[0], rtol=tol, atol=tol)
    np.testing.assert_allclose(got[1], want[1], rtol=tol, atol=tol)
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=tol, atol=tol,
                                   err_msg=k)


def test_moe_exports_the_jax_names():
    """``incubate`` exports the JAX package's names (``distributed``
    among them); ``moe`` every name of the JAX package's."""
    import paddle_tpu.incubate as jinc
    import paddle_tpu_torch.incubate as tinc

    assert tinc.__all__ == jinc.__all__ and "distributed" in tinc.__all__
    assert paddle.incubate is tinc
    assert set(jmoe.__all__) <= set(tmoe.__all__)
    assert all(hasattr(tmoe, n) for n in tmoe.__all__)


def test_limit_by_capacity_marks_overflow():
    idx = np.array([[0], [0], [0], [1], [0], [1]])
    for P, m in ((pt, jmoe), (paddle, tmoe)):
        lec, gec, new = m.limit_by_capacity(P.to_tensor(idx), num_expert=2,
                                            world_size=1, capacity=2)
        assert _np(new).tolist() == [[0], [0], [-1], [1], [-1], [1]]
        assert _np(lec).tolist() == [2, 2] == _np(gec).tolist()


def test_identical_experts_match_dense_reference():
    jm, tm = _pair(seed=3, gate={"type": "naive", "top_k": 2})
    sd = tm.experts[0].state_dict()
    for e in tm.experts:
        e.set_state_dict(sd)
    jsd = jm.experts[0].state_dict()
    for e in jm.experts:
        e.set_state_dict(jsd)
    x = _input()
    out = _np(tm(paddle.to_tensor(x))).reshape(-1, D_MODEL)
    x2d = paddle.to_tensor(x.reshape(-1, D_MODEL))
    val, _ = tm.gate(x2d)
    expected = _np(val).sum(-1, keepdims=True) * _np(tm.experts[0](x2d))
    np.testing.assert_allclose(out, expected, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        out, _np(jm(pt.to_tensor(x))).reshape(-1, D_MODEL), atol=1e-5,
        rtol=1e-5)


def _force(P, moe, expert, bias=10.0):
    w = np.zeros((D_MODEL, E), dtype="float32")
    b = np.zeros((E,), dtype="float32")
    b[expert] = bias
    moe.gate.gate.set_state_dict({"weight": P.to_tensor(w),
                                  "bias": P.to_tensor(b)})


def test_forced_routing_selects_right_expert():
    jm, tm = _pair(seed=4, gate={"type": "naive", "top_k": 1})
    x = _input(seed=5)
    for P, m in ((pt, jm), (paddle, tm)):
        _force(P, m, 2)
        x2d = P.to_tensor(x.reshape(-1, D_MODEL))
        expected = 10.0 * _np(m.experts[2](x2d))
        np.testing.assert_allclose(
            _np(m(P.to_tensor(x))).reshape(-1, D_MODEL), expected,
            atol=1e-4, rtol=1e-4)


_GATES = {
    "naive": (lambda m: m.NaiveGate(D_MODEL, E, 1, topk=2), True),
    "gshard": (lambda m: m.GShardGate(D_MODEL, E, 1, capacity=GSHARD_CAP,
                                      random_routing=False), True),
    "switch": (lambda m: m.SwitchGate(D_MODEL, E, 1), False),
}


@pytest.mark.parametrize("gate_type", ["naive", "gshard", "switch"])
def test_all_gates_train(gate_type):
    """Forward and backward through each gate against the JAX package's
    (module docstring); then the port's random path (gshard's random
    routing, switch's jitter) in training: a finite loss, gradients at
    the gate and at some expert, the aux loss in the graph."""
    make, training = _GATES[gate_type]
    jm, tm = _pair(seed=6, gate=make)
    for m in (jm, tm):
        m.train() if training else m.eval()
    x = _input(seed=7)
    _same_run(_run(paddle, tm, x, 0.01), _run(pt, jm, x, 0.01))

    top_k = 1 if gate_type == "switch" else 2
    _, tm = _pair(seed=6, gate={"type": gate_type, "top_k": top_k})
    tm.train()
    out, loss, grads = _run(paddle, tm, x, 0.01)
    assert np.isfinite(loss)
    assert "gate.gate.weight" in grads
    assert any(np.abs(g).sum() > 0 for k, g in grads.items()
               if k.endswith("htoh4.weight"))


def test_gshard_eval_deterministic():
    jm, tm = _pair(seed=8, gate={"type": "gshard", "top_k": 2})
    jm.eval()
    tm.eval()
    x = _input(seed=9)
    a = _np(tm(paddle.to_tensor(x)))
    np.testing.assert_array_equal(a, _np(tm(paddle.to_tensor(x))))
    np.testing.assert_allclose(a, _np(jm(pt.to_tensor(x))), atol=1e-5,
                               rtol=1e-5)


def test_capacity_drops_scale_output():
    jm, tm = _pair(seed=10, gate={"type": "naive", "top_k": 1},
                   capacity_factor=0.25)
    x = _input(B=1, S=16, seed=11)
    T = 16
    cap = max(1, int(np.ceil(0.25 * T * 1 / E)))
    outs = []
    for P, m in ((pt, jm), (paddle, tm)):
        _force(P, m, 0)  # everyone wants expert 0: capacity overflow
        out = _np(m(P.to_tensor(x))).reshape(-1, D_MODEL)
        zero_rows = np.sum(np.all(np.abs(out) < 1e-12, axis=1))
        assert zero_rows == T - cap, f"{zero_rows} zero rows, want {T - cap}"
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5, rtol=1e-5)


def test_moe_grad_clip():
    jm, tm = _pair(seed=14, gate={"type": "naive", "top_k": 2})
    x = _input(seed=15)
    norms = []
    for P, m, mod in ((pt, jm, jmoe), (paddle, tm, tmoe)):
        (m(P.to_tensor(x)).pow(2).sum() * 100).backward()
        pg = [(p, p.grad) for p in m.parameters()]
        clipped = mod.ClipGradForMOEByGlobalNorm(clip_norm=1.0)(pg)
        total = sum(np.sum(_np(g).astype("float64") ** 2)
                    for _, g in clipped if g is not None)
        assert np.sqrt(total) <= 1.0 + 1e-4
        norms.append([_np(g) for _, g in clipped])
    for a, b in zip(*norms):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


# ------------------------------------------------- expert parallelism
EP_EXPERTS = 8


def _ep_weights():
    pt.seed(12)
    experts = JaxLayerList([jmoe.ExpertLayer(D_MODEL, D_HIDDEN)
                            for _ in range(EP_EXPERTS)])
    jm = jmoe.MoELayer(D_MODEL, experts, gate={"type": "naive", "top_k": 2})
    return jm, {k: _np(v) for k, v in jm.state_dict().items()}


def _jax_ep(jm, x):
    """The JAX layer expert-parallel over ``dp`` 8 (the JAX test's), the
    same gate weights: its output (its backward, ~24 s of recompiles
    here, is the JAX test's own; the port's expert-parallel gradients
    are held against both packages' local path)."""
    jfleet.fleet._is_initialized = False
    jdist.set_mesh(None)
    try:
        s = jfleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 8, "mp_degree": 1, "pp_degree": 1}
        jfleet.init(is_collective=True, strategy=s)
        group = jfleet.get_hybrid_communicate_group().get_data_parallel_group()
        ep = jmoe.MoELayer(D_MODEL, jm.experts,
                           gate={"type": "naive", "top_k": 2},
                           moe_group=group)
        ep.gate = jm.gate
        assert ep._ep_axis == "dp"
        return _np(ep(pt.to_tensor(x)))
    finally:
        jdist.set_mesh(None)
        jfleet.fleet._is_initialized = False


@pytest.fixture(scope="module")
def ep_job():
    from paddle_tpu_torch.distributed import spawn

    jm, weights = _ep_weights()
    pt.seed(0)
    jg = jmoe.GShardGate(D_MODEL, EP_EXPERTS, 1, capacity=GSHARD_CAP,
                         random_routing=False)
    gshard = {k: v for k, v in weights.items() if k.startswith("experts")}
    gshard.update({f"gate.{k}": _np(v) for k, v in jg.state_dict().items()})
    x = _input(B=4, S=16, seed=13)
    ctx = spawn(torch_sep_moe_ranks.moe_cases,
                args=({"x": x, "weights": weights, "gshard_cap": GSHARD_CAP,
                       "gshard_weights": gshard},),
                nprocs=2, join=False, backend="cpu")
    try:
        ref = {"naive_local": _run(pt, jm, x)}
        for p in jm.parameters():
            p.clear_gradient()
        ref["naive_ep"] = _jax_ep(jm, x)
        jl = jmoe.MoELayer(D_MODEL, jm.experts, gate=jg)
        jl.train()
        for p in jl.parameters():
            p.clear_gradient()
        ref["gshard"] = _run(pt, jl, x, 0.01)
    finally:
        ctx.join(timeout=600)
    res = ctx.results()
    return [res[0], res[1]], ref, x, weights


def _gathered(ranks, key):
    """The ranks' ``(out, loss, grads)`` as one program's: the outputs
    stacked in rank order, the mean loss, each expert's gradient from its
    owner and the replicated ones from rank 0 (equal on both)."""
    outs = np.concatenate([r[key][0] for r in ranks])
    loss = float(np.mean([r[key][1] for r in ranks]))
    grads = dict(ranks[0][key][2])
    grads.update(ranks[1][key][2])
    for k, g in ranks[0][key][2].items():
        if not k.startswith("experts"):
            np.testing.assert_array_equal(g, ranks[1][key][2][k])
    return outs, loss, grads


def test_expert_parallel_matches_local(ep_job):
    """Each rank keeps its 4 of the 8 experts under their global names;
    forward and every gradient equal the local path's, as the JAX
    layer's on ``dp`` 8 equal its own."""
    ranks, ref, x, weights = ep_job
    assert ranks[0]["local_experts"] == ["0", "1", "2", "3"]
    assert ranks[1]["local_experts"] == ["4", "5", "6", "7"]
    np.testing.assert_allclose(ref["naive_ep"], ref["naive_local"][0],
                               rtol=1e-5, atol=1e-5)
    got = _gathered(ranks, "naive")
    _same_run(got, ref["naive_local"])
    _, tm = _local_port(weights, {"type": "naive", "top_k": 2})
    _same_run(got, _run(paddle, tm, x))


def _local_port(weights, gate, training=False):
    tm = tmoe.MoELayer(D_MODEL, [tmoe.ExpertLayer(D_MODEL, D_HIDDEN)
                                 for _ in range(EP_EXPERTS)], gate=gate)
    tm.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()
                       if k in tm.state_dict()})
    tm.train() if training else tm.eval()
    return None, tm


def test_gshard_at_ep2_matches_the_global_gate(ep_job):
    """gshard top-2 in training, capacity rate 0.2 (tokens drop): the
    ranks' outputs, mean loss (with the aux loss) and gradients equal the
    JAX package's gate over the whole batch."""
    ranks, ref, x, weights = ep_job
    got = _gathered(ranks, "gshard")
    dropped = sum(np.all(np.abs(o) < 1e-12, axis=-1).sum()
                  for o in got[0])
    assert dropped > 0
    _same_run(got, ref["gshard"])


def test_moe_clip_at_ep2_matches_the_local_clip(ep_job):
    """The clip's factor over the ranks' gradients (the experts' squared
    norm all-reduced over the moe group) equals the one program's over
    the same gradients, and it clips."""
    ranks, ref, x, weights = ep_job
    grads = _gathered(ranks, "gshard")[2]
    total = np.sqrt(sum(np.sum(g.astype("float64") ** 2)
                        for g in grads.values()))
    want = 1e-3 / total
    assert want < 1.0
    for r in ranks:
        np.testing.assert_allclose(r["clip_factor"], want, rtol=1e-4)
