"""The seven optimizers this slice adds (SGD, Momentum, Adamax, Adagrad,
Adadelta, RMSProp, Lamb), grad clipping, schedulers, param groups and the
state written in place, against the JAX package's.

Each optimizer takes three steps over the same parameters and grads
(numpy) in both packages. Tolerances, as ``tests/test_torch_optimizer.py``
states them: f32 atol = rtol = 1e-6 (the same elementwise f32 formula;
torch's and XLA's sqrt, division and norms may differ by an ulp); bf16
under master weights (``amp.decorate``'s ``_multi_precision``): the f32
master within 1e-6 and the bf16 parameter within one bf16 ulp (rtol
2^-7) of the JAX one. Twins of ``tests/test_optimizer.py``'s
``test_grad_clip_global_norm``, ``test_scheduler_with_optimizer``,
``test_optimizer_state_dict_roundtrip`` (here with a scheduler) and
``test_param_groups_lr_and_weight_decay``; the clips by value and by
norm and the ``_found_inf`` skip on both sides; and every parameter,
accumulator, ``@master`` and lr buffer keeps its storage across steps.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.tensor import Parameter as JaxParameter
from paddle_tpu.tensor import Tensor as JaxTensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from torch_suite import one_torch_thread  # noqa: F401

SHAPES = [(8, 6), (5,), (3, 4)]

# name: constructor keywords (the same for both packages)
NEW = {
    "SGD": dict(learning_rate=0.05),
    "Momentum": dict(learning_rate=0.05, momentum=0.9),
    "Momentum_nesterov": dict(learning_rate=0.05, momentum=0.8,
                              use_nesterov=True, weight_decay=0.01),
    "Adamax": dict(learning_rate=0.01),
    "Adagrad": dict(learning_rate=0.05, initial_accumulator_value=0.1),
    "Adadelta": dict(learning_rate=1.0, rho=0.9),
    "RMSProp": dict(learning_rate=0.01, momentum=0.5),
    "RMSProp_centered": dict(learning_rate=0.01, centered=True),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.05),
}


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x):
    return np.asarray(x, np.float32)


def _arrays(seed, dtype, steps=3):
    rng = np.random.default_rng(seed)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[(0.1 * rng.standard_normal(s)).astype(np.float32)
           for s in SHAPES] for _ in range(steps)]
    if dtype == "bf16":
        ps = [p.astype(ml_dtypes.bfloat16) for p in ps]
        gs = [[g.astype(ml_dtypes.bfloat16) for g in st] for st in gs]
    return ps, gs


def _pair(name, dtype, master=False, steps=3, **extra):
    """Both packages' optimizer ``name`` stepped over the same grads:
    ``(jax params, port params, jax opt, port opt)``."""
    cls = name.split("_")[0]
    kw = dict(NEW[name], **extra)
    ps, gs = _arrays(len(name) + len(dtype), dtype, steps)
    jps = [JaxParameter(jnp.asarray(p)) for p in ps]
    tps = [torch.nn.Parameter(_t(p)) for p in ps]
    jo = getattr(pt.optimizer, cls)(parameters=jps, **kw)
    to = getattr(topt, cls)(parameters=tps, **kw)
    jo._multi_precision = to._multi_precision = master
    for step in gs:
        for jp, tp, g in zip(jps, tps, step):
            jp.grad = JaxTensor(jnp.asarray(g))
            tp.grad = _t(g)
        jo.step()
        to.step()
    return jps, tps, jo, to


CASES = ([(n, "f32", False) for n in NEW]
         + [(n, "bf16", True) for n in ("SGD", "Momentum", "Adamax",
                                        "RMSProp", "Lamb")])


@pytest.mark.parametrize("name,dtype,master", CASES)
def test_optimizer_updates_twin(name, dtype, master):
    jps, tps, jo, to = _pair(name, dtype, master)
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        got, want = tp.detach().float().numpy(), _np(jp.numpy())
        if dtype == "f32":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        else:
            assert tp.dtype == torch.bfloat16
            np.testing.assert_allclose(got, want, atol=0, rtol=2 ** -7)
        jaccs, taccs = jo._accumulators[jp._uid], to._accumulators[i]
        assert set(jaccs) == set(taccs)
        for key, val in jaccs.items():
            np.testing.assert_allclose(taccs[key].float().numpy(), _np(val),
                                       atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(NEW))
def test_state_is_written_in_place(name):
    """Parameters, accumulators, ``@master`` and the lr buffer keep their
    storage over steps (a captured step reads and writes them there)."""
    ps, gs = _arrays(1, "bf16", 3)
    tps = [torch.nn.Parameter(_t(p)) for p in ps]
    opt = getattr(topt, name.split("_")[0])(parameters=tps, **NEW[name])
    opt._multi_precision = True
    opt._materialize_accumulators()

    def ptrs():
        return ([p.data_ptr() for p in tps]
                + [v.data_ptr() for i in sorted(opt._accumulators)
                   for v in opt._accumulators[i].values()]
                + [b.data_ptr() for b in opt._lr_bufs.values()])

    before = ptrs()
    assert all("@master" in a for a in opt._accumulators.values())
    for step in gs:
        for p, g in zip(tps, step):
            p.grad = _t(g)
        opt.step()
    assert ptrs() == before


def test_found_inf_skips_the_update_twin():
    """With ``_found_inf`` set the update is a ``where`` back to the old
    values in both packages: parameters and accumulators equal to before;
    with it false the step runs."""
    for flag in (True, False):
        jps, tps, jo, to = _pair("Adamax", "f32", steps=1)
        before = [tp.detach().clone() for tp in tps]
        accs = {k: v.clone() for k, v in to._accumulators[0].items()}
        g = np.full(SHAPES[0], 0.3, np.float32)
        jps[0].grad, tps[0].grad = JaxTensor(jnp.asarray(g)), _t(g)
        jo._found_inf = JaxTensor(jnp.asarray(flag))
        to._found_inf = torch.tensor(flag)
        jo.step()
        to.step()
        np.testing.assert_allclose(tps[0].detach().numpy(),
                                   _np(jps[0].numpy()), atol=1e-6, rtol=1e-6)
        same = torch.equal(tps[0].detach(), before[0]) and all(
            torch.equal(v, accs[k]) for k, v in to._accumulators[0].items())
        assert same == flag
        assert to._found_inf is None


def test_grad_clip_global_norm_twin():
    """``tests/test_optimizer.py::test_grad_clip_global_norm`` in both."""
    out = []
    for P, opt_mod, clip_mod in ((pt, pt.optimizer, pt.nn),
                                 (None, topt, tnn)):
        if P is pt:
            p = pt.Parameter(np.zeros((2,), dtype=np.float32))
            p.grad = pt.to_tensor(np.array([3.0, 4.0], dtype=np.float32))
        else:
            p = torch.nn.Parameter(torch.zeros(2))
            p.grad = torch.tensor([3.0, 4.0])
        opt = opt_mod.SGD(learning_rate=1.0, parameters=[p],
                          grad_clip=clip_mod.ClipGradByGlobalNorm(1.0))
        opt.step()
        out.append(_np(p.numpy()) if P is pt else p.detach().numpy())
    np.testing.assert_allclose(out[1], [-0.6, -0.8], rtol=1e-5)
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6)


@pytest.mark.parametrize("clip", ["value", "norm", "global"])
def test_clips_twin(clip):
    """Each clip on three grads (one with ``need_clip`` False) against the
    JAX one; no host read of the norm (the factor is a device where)."""
    rng = np.random.default_rng(7)
    gs = [(3 * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
    make = {"value": lambda m: m.ClipGradByValue(0.5, -0.25),
            "norm": lambda m: m.ClipGradByNorm(1.5),
            "global": lambda m: m.ClipGradByGlobalNorm(2.0)}[clip]
    jps = [JaxParameter(jnp.zeros(s)) for s in SHAPES]
    tps = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    jps[1].need_clip = False
    tps[1].need_clip = False
    jout = make(pt.nn)([(p, JaxTensor(jnp.asarray(g)))
                        for p, g in zip(jps, gs)])
    tout = make(tnn)([(p, torch.from_numpy(g)) for p, g in zip(tps, gs)])
    for (_, jg), (_, tg), g in zip(jout, tout, gs):
        np.testing.assert_allclose(tg.numpy(), _np(jg.numpy()), atol=1e-6,
                                   rtol=1e-6)
    np.testing.assert_array_equal(tout[1][1].numpy(), gs[1])


def test_scheduler_with_optimizer_twin():
    """``tests/test_optimizer.py::test_scheduler_with_optimizer``, and the
    lr the step reads is the scheduler's (the lr buffer is written before
    each step)."""
    for lr_mod, opt_mod, make in (
            (pt.optimizer.lr, pt.optimizer,
             lambda: pt.Parameter(np.zeros((2,), dtype=np.float32))),
            (topt.lr, topt, lambda: torch.nn.Parameter(torch.zeros(2)))):
        sched = lr_mod.StepDecay(learning_rate=0.1, step_size=2, gamma=0.5)
        p = make()
        opt = opt_mod.SGD(learning_rate=sched, parameters=[p])
        assert opt.get_lr() == pytest.approx(0.1)
        sched.step()
        sched.step()
        assert opt.get_lr() == pytest.approx(0.05)
        with pytest.raises(RuntimeError):
            opt.set_lr(0.5)
    p.grad = torch.ones(2)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), [-0.05, -0.05])
    assert float(opt._lr_bufs[p.device]) == pytest.approx(0.05)


def test_optimizer_state_dict_roundtrip_twin():
    """``tests/test_optimizer.py::test_optimizer_state_dict_roundtrip``
    with a scheduler, in both packages: three Adam steps, the state dict
    into a second optimizer, accumulators and the scheduler's state equal,
    and the port's state dict equal to the JAX one's. Loading writes into
    existing accumulators in place."""
    sd = {}
    for side in ("jax", "port"):
        if side == "jax":
            sched = pt.optimizer.lr.ExponentialDecay(learning_rate=0.05,
                                                     gamma=0.9)
            jps, _tps, jo, _to = _pair("SGD", "f32", steps=0)
            opt = pt.optimizer.Adam(learning_rate=sched, parameters=jps)
        else:
            sched = topt.lr.ExponentialDecay(learning_rate=0.05, gamma=0.9)
            _jps, tps, _jo, _to = _pair("SGD", "f32", steps=0)
            opt = topt.Adam(learning_rate=sched, parameters=tps)
        _ps, gs = _arrays(5, "f32", 3)
        for step in gs:
            params = jps if side == "jax" else tps
            for p, g in zip(params, step):
                p.grad = (JaxTensor(jnp.asarray(g)) if side == "jax"
                          else torch.from_numpy(g))
            opt.step()
            sched.step()
        sd[side] = opt.state_dict()
        if side == "port":
            fresh_sched = topt.lr.ExponentialDecay(learning_rate=0.05,
                                                   gamma=0.9)
            fresh = topt.Adam(learning_rate=fresh_sched, parameters=tps)
            fresh._materialize_accumulators()
            ptr = fresh._accumulators[0]["moment1"].data_ptr()
            fresh.set_state_dict(sd[side])
            assert fresh._accumulators[0]["moment1"].data_ptr() == ptr
            for i, accs in opt._accumulators.items():
                for name, val in accs.items():
                    assert torch.equal(fresh._accumulators[i][name], val)
            assert fresh_sched.state_dict() == sched.state_dict()
            assert fresh.get_lr() == opt.get_lr()
    assert sd["port"]["LR_Scheduler"] == sd["jax"]["LR_Scheduler"]
    assert sd["port"]["@global_step"] == sd["jax"]["@global_step"] == 3
    keys = {k for k in sd["jax"] if k.startswith("pos:")}
    assert keys == {k for k in sd["port"] if k.startswith("pos:")}
    for k in keys:
        np.testing.assert_allclose(sd["port"][k].numpy(),
                                   _np(sd["jax"][k].numpy()), atol=1e-6,
                                   rtol=1e-6)


def test_param_groups_lr_and_weight_decay_twin():
    """``tests/test_optimizer.py::test_param_groups_lr_and_weight_decay``
    in both packages, and AdamW's group weight decay as its decoupled
    coefficient."""
    w = np.ones((2, 2), dtype=np.float32)
    g = np.ones((2, 2), dtype=np.float32)
    res = {}
    for side in ("jax", "port"):
        for cls in ("SGD", "AdamW"):
            if side == "jax":
                p1, p2 = pt.Parameter(w.copy()), pt.Parameter(w.copy())
                mod = pt.optimizer
            else:
                p1, p2 = (torch.nn.Parameter(torch.from_numpy(w.copy()))
                          for _ in range(2))
                mod = topt
            opt = getattr(mod, cls)(learning_rate=0.1, parameters=[
                {"params": [p1], "learning_rate": 1.0},
                {"params": [p2], "learning_rate": 0.5, "weight_decay": 0.5},
            ])
            for p in (p1, p2):
                p.grad = (pt.to_tensor(g.copy()) if side == "jax"
                          else torch.from_numpy(g.copy()))
            opt.step()
            res[side, cls] = [_np(p.numpy()) if side == "jax"
                              else p.detach().numpy() for p in (p1, p2)]
    np.testing.assert_allclose(res["port", "SGD"][0], w - 0.1 * g, rtol=1e-6)
    for cls in ("SGD", "AdamW"):
        for a, b in zip(res["port", cls], res["jax", cls]):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
