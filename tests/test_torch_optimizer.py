"""paddle_tpu_torch.optimizer against the JAX package's optimizers: single
Adam and AdamW updates on the same parameters and grads (numpy), f32 and
bf16, with and without master weights (``multi_precision``), with
``apply_decay_param_fun`` and ``lr_ratio``, then ``clear_grad`` and the
state dict.

Tolerances. f32: atol = rtol = 1e-6 (the same elementwise f32 formula;
torch's and XLA's sqrt/division may differ by an ulp). bf16 without
master weights: the update runs in bf16 on both sides, op for op with
the same roundings, so each result may differ by at most one bf16 ulp
(rtol 2^-7). bf16 with master weights: the f32 master agrees to 1e-6
and the bf16 parameter is its rounding.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Parameter as JaxParameter
from paddle_tpu.tensor import Tensor as JaxTensor
from paddle_tpu_torch.optimizer import Adam, AdamW
from torch_suite import one_torch_thread  # noqa: F401

SHAPES = [(8, 6), (5,), (3, 4)]


def _arrays(seed, dtype):
    rng = np.random.default_rng(seed)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[(0.1 * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
          for _ in range(2)]
    if dtype == "bf16":
        ps = [p.astype(ml_dtypes.bfloat16) for p in ps]
        gs = [[g.astype(ml_dtypes.bfloat16) for g in step] for step in gs]
    return ps, gs


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x):
    return np.asarray(x, np.float32)


def _run(cls_name, dtype, master, **kw):
    """Two steps on both sides; returns (jax params, port params, jax
    opt, port opt) after them."""
    ps, gs = _arrays(len(cls_name) + len(dtype) + master, dtype)
    jps = [JaxParameter(jnp.asarray(p)) for p in ps]
    tps = [torch.nn.Parameter(_t(p)) for p in ps]
    names = [p.name for p in jps]
    decay_fn = kw.pop("decay_first_only", None)
    ratio = kw.pop("lr_ratio_first", None)
    jkw, tkw = dict(kw), dict(kw)
    if decay_fn:
        jkw["apply_decay_param_fun"] = lambda n: n == names[0]
        tkw["apply_decay_param_fun"] = lambda n: n == "w0"
    if ratio:
        jkw["lr_ratio"] = lambda p: ratio if p is jps[0] else 1.0
        tkw["lr_ratio"] = lambda p: ratio if p is tps[0] else 1.0
    jcls = getattr(paddle.optimizer, cls_name)
    tcls = {"Adam": Adam, "AdamW": AdamW}[cls_name]
    jo = jcls(learning_rate=0.01, parameters=jps, multi_precision=master,
              **jkw)
    to = tcls(learning_rate=0.01, parameters=[(f"w{i}", p)
                                              for i, p in enumerate(tps)],
              multi_precision=master, **tkw)
    jo._multi_precision = master  # what amp.decorate sets
    for step in gs:
        for jp, tp, g in zip(jps, tps, step):
            jp.grad = JaxTensor(jnp.asarray(g))
            tp.grad = _t(g)
        jo.step()
        to.step()
    return jps, tps, jo, to


CASES = [("Adam", "f32", False, {}), ("AdamW", "f32", False, {}),
         ("Adam", "f32", False, {"weight_decay": 0.1}),
         ("AdamW", "f32", False, {"weight_decay": 0.3,
                                  "decay_first_only": True}),
         ("AdamW", "f32", False, {"lr_ratio_first": 0.25}),
         ("AdamW", "bf16", False, {}), ("Adam", "bf16", False, {}),
         ("AdamW", "bf16", True, {}), ("AdamW", "bf16", True,
                                       {"decay_first_only": True})]


@pytest.mark.parametrize("cls_name,dtype,master,kw", CASES)
def test_updates_match(cls_name, dtype, master, kw):
    jps, tps, jo, to = _run(cls_name, dtype, master, **dict(kw))
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        got = tp.detach().float().numpy()
        want = _np(jp.numpy())
        if dtype == "f32":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        else:
            assert tp.dtype == torch.bfloat16
            np.testing.assert_allclose(got, want, atol=0, rtol=2 ** -7)
        jaccs = jo._accumulators[jp._uid]
        taccs = to._accumulators[i]
        assert set(jaccs) == set(taccs)
        for name, val in jaccs.items():
            assert str(taccs[name].dtype).split(".")[-1] == str(val.dtype)
        if master:
            np.testing.assert_allclose(taccs["@master"].numpy(),
                                       _np(jaccs["@master"]), atol=1e-6,
                                       rtol=1e-6)
            np.testing.assert_array_equal(
                tp.detach().numpy() if tp.dtype == torch.float32 else
                tp.detach().view(torch.int16).numpy(),
                taccs["@master"].to(torch.bfloat16).view(torch.int16).numpy())


def test_decay_follows_apply_decay_param_fun():
    """Only the parameter the function accepts is decayed: with zero
    grads, Adam moves nothing and the decay alone acts."""
    p0 = torch.nn.Parameter(torch.ones(3))
    p1 = torch.nn.Parameter(torch.ones(3))
    opt = AdamW(learning_rate=0.5, parameters=[("a", p0), ("b", p1)],
                weight_decay=0.2, apply_decay_param_fun=lambda n: n == "a")
    for p in (p0, p1):
        p.grad = torch.zeros(3)
    opt.step()
    np.testing.assert_allclose(p0.detach().numpy(), 0.9, rtol=1e-6)
    np.testing.assert_allclose(p1.detach().numpy(), 1.0)


def test_clear_grad_and_state_dict_round_trip():
    _jps, tps, _jo, to = _run("AdamW", "f32", False)
    to.clear_grad()
    assert all(p.grad is None for p in tps)
    sd = to.state_dict()
    assert sd["@global_step"] == 2
    assert set(sd) == {"@global_step"} | {
        f"pos:{i}.{n}" for i in range(len(SHAPES))
        for n in ("moment1", "moment2", "beta1_pow", "beta2_pow")}
    fresh = AdamW(learning_rate=0.01, parameters=tps)
    fresh.set_state_dict(sd)
    assert fresh._global_step == 2
    for i in range(len(SHAPES)):
        for n, val in to._accumulators[i].items():
            assert torch.equal(fresh._accumulators[i][n], val)
    assert fresh.get_lr() == 0.01
    fresh.set_lr(0.5)
    assert fresh.get_lr() == 0.5
    with pytest.raises(KeyError):
        AdamW(parameters=tps[:1]).set_state_dict(sd)
