"""paddle_tpu_torch.amp.GradScaler against the JAX package's.

Twins of ``tests/test_amp.py``'s scaler tests (lines 85-126): the scale /
unscale round trip, an inf that skips the update (parameters and
accumulators bit-equal to before) and shrinks the scale, the scale that
grows after n good steps, and the compiled scaler step (``jit.to_static``
in both packages: one program each). Then 6 steps with an inf injected
at step 3, where the scale and the good and bad counters must equal the
JAX package's after every step, and ``unscale_`` before ``step``
dividing once. Both sides start from the same ``Linear(8, 4)`` weights
(the JAX one's, transposed into the port's ``[out, in]``) and take the
same numpy inputs; parameters agree at f32 atol 1e-6, rtol 1e-5 (the
JAX test's tolerance), scales and counters exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu import jit as jjit
from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.models import _modules as tnn
from paddle_tpu_torch import optimizer as topt
from torch_suite import one_torch_thread  # noqa: F401


def _pair(lr=0.1, opt="SGD"):
    """The JAX test's ``_setup`` in both packages, with equal weights."""
    pt.seed(3)
    jm = pt.nn.Linear(8, 4)
    tm = tnn.Linear(8, 4)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.array(jm.weight.numpy()).T))
        tm.bias.copy_(torch.from_numpy(np.array(jm.bias.numpy())))
    jo = getattr(pt.optimizer, opt)(learning_rate=lr,
                                    parameters=jm.parameters())
    to = getattr(topt, opt)(learning_rate=lr, parameters=tm.parameters())
    return (jm, jo), (tm, to)


def _w(m):
    w = m.weight
    return (np.asarray(w.numpy()) if hasattr(w, "_uid")
            else w.detach().numpy().T)


def _state(scaler):
    cells = scaler.__jit_state__()
    return [float(np.asarray(getattr(c, "numpy")())) if hasattr(c, "_value")
            else float(c) for c in cells]


def _step_both(jside, tside, jscaler, tscaler, x, unscale_first=False):
    (jm, jo), (tm, to) = jside, tside
    jl = jm(pt.to_tensor(x)).sum()
    tl = tm(torch.from_numpy(x)).sum()
    jscaler.scale(jl).backward()
    tscaler.scale(tl).backward()
    if unscale_first:
        jscaler.unscale_(jo)
        tscaler.unscale_(to)
    jscaler.step(jo)
    tscaler.step(to)
    jo.clear_grad()
    to.clear_grad()


def test_scale_unscale_roundtrip_twin():
    jside, tside = _pair()
    js = jamp.GradScaler(init_loss_scaling=1024.0)
    ts = amp.GradScaler(init_loss_scaling=1024.0, device="cpu")
    before = _w(tside[0]).copy()
    _step_both(jside, tside, js, ts, np.ones((4, 8), "float32"))
    np.testing.assert_allclose(_w(tside[0]), _w(jside[0]), rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(before, _w(tside[0]))
    # the unscaled step of the JAX test's reference, on the port
    _, (tm2, to2) = _pair()
    tm2(torch.ones(4, 8)).sum().backward()
    to2.step()
    np.testing.assert_allclose(_w(tside[0]), _w(tm2), rtol=1e-5, atol=1e-6)


def test_inf_skips_update_and_shrinks_scale_twin():
    jside, tside = _pair(opt="Adam")
    js = jamp.GradScaler(init_loss_scaling=1024.0, decr_every_n_nan_or_inf=1)
    ts = amp.GradScaler(init_loss_scaling=1024.0, decr_every_n_nan_or_inf=1,
                        device="cpu")
    _step_both(jside, tside, js, ts, np.ones((4, 8), "float32"))
    to = tside[1]
    before = [p.detach().clone() for p in tside[0].parameters()]
    accs = {i: {k: v.clone() for k, v in a.items()}
            for i, a in to._accumulators.items()}
    _step_both(jside, tside, js, ts, np.full((4, 8), np.inf, "float32"))
    for p, b in zip(tside[0].parameters(), before):
        assert torch.equal(p.detach(), b)
    for i, a in to._accumulators.items():
        for k, v in a.items():
            assert torch.equal(v, accs[i][k])
    assert float(ts.get_loss_scaling().numpy()) == 512.0
    assert float(js.get_loss_scaling().numpy()) == 512.0
    np.testing.assert_allclose(_w(tside[0]), _w(jside[0]), rtol=1e-5,
                               atol=1e-6)


def test_scale_grows_after_n_good_steps_twin():
    jside, tside = _pair()
    js = jamp.GradScaler(init_loss_scaling=256.0, incr_every_n_steps=3)
    ts = amp.GradScaler(init_loss_scaling=256.0, incr_every_n_steps=3,
                        device="cpu")
    for _ in range(3):
        _step_both(jside, tside, js, ts, np.ones((4, 8), "float32"))
    assert float(ts.get_loss_scaling().numpy()) == 512.0
    assert _state(ts) == _state(js)


def test_scale_and_counters_follow_jax_with_an_inf_step():
    """6 steps, the third on an inf input: scale, good and bad counts equal
    the JAX scaler's after each step; parameters too."""
    jside, tside = _pair(opt="Adam", lr=0.01)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    js = jamp.GradScaler(**kw)
    ts = amp.GradScaler(device="cpu", **kw)
    rng = np.random.default_rng(2)
    for i in range(6):
        x = rng.standard_normal((4, 8)).astype("float32")
        if i == 2:
            x[0, 0] = np.inf
        _step_both(jside, tside, js, ts, x, unscale_first=i == 4)
        assert _state(ts) == _state(js), i
        np.testing.assert_allclose(_w(tside[0]), _w(jside[0]), rtol=1e-5,
                                   atol=1e-6)
    assert ts._unscaled == set()
    sd = ts.state_dict()
    fresh = amp.GradScaler(device="cpu")
    cells = [c.data_ptr() for c in fresh.__jit_state__()]
    fresh.load_state_dict(sd)
    assert _state(fresh) == _state(ts)
    assert [c.data_ptr() for c in fresh.__jit_state__()] == cells


def test_compiled_scaler_step_twin():
    """``tests/test_amp.py::test_compiled_scaler_step``: the scaler inside
    a ``jit.to_static`` step, in both packages; losses and scale follow
    the JAX compiled step's, one program each."""
    (jm, jo), (tm, to) = _pair()
    js = jamp.GradScaler(init_loss_scaling=64.0, incr_every_n_steps=2)
    ts = amp.GradScaler(init_loss_scaling=64.0, incr_every_n_steps=2,
                        device="cpu")
    rng = np.random.default_rng(4)

    @jjit.to_static
    def jstep(xb, yb):
        loss = ((jm(xb) - yb) ** 2).mean()
        js.scale(loss).backward()
        js.step(jo)
        jo.clear_grad()
        return loss

    @jit.to_static
    def tstep(xb, yb):
        loss = ((tm(xb) - yb) ** 2).mean()
        ts.scale(loss).backward()
        ts.step(to)
        to.clear_grad()
        return loss

    x = rng.standard_normal((8, 8)).astype("float32")
    y = rng.standard_normal((8, 4)).astype("float32")
    jl, tl = [], []
    for _ in range(5):
        jl.append(float(jstep(pt.to_tensor(x), pt.to_tensor(y)).numpy()))
        tl.append(float(tstep(torch.from_numpy(x),
                             torch.from_numpy(y)).detach()))
        assert _state(ts) == _state(js)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert tl[-1] < tl[0]
    assert len(tstep._cache) == len(jstep._cache) == 1
    assert float(ts.get_loss_scaling().numpy()) > 64.0


def test_scaler_cells_live_on_the_device_given():
    s = amp.GradScaler(device="cpu")
    assert all(c.device.type == "cpu" for c in s.__jit_state__())
    assert [c.dtype for c in s.__jit_state__()] == [torch.float32,
                                                      torch.int32,
                                                      torch.int32]
    off = amp.GradScaler(enable=False, device="cpu")
    loss = torch.tensor(2.0)
    assert off.scale(loss) is loss
    with pytest.raises(RuntimeError):
        amp.GradScaler(device="cpu").minimize(
            topt.SGD(parameters=[torch.nn.Parameter(torch.zeros(1))]),
            loss)
