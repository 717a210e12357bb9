"""paddle_tpu_torch.jit against the JAX package's: twins of
``tests/test_jit.py``, and the contract that makes a capture sound.

On the CPU the port's ``StaticFunction`` runs the function eagerly on
every call (the CUDA graph exists only on the card) but keeps its
signature cache, counts and seed buffers, so these tests hold the port's
results, program counts and state against the JAX package's compiled
ones:

- ``test_forward_matches_eager``, ``test_retrace_on_new_shape`` and
  ``test_layer_decoration``: the same outputs (f32 1e-5, the JAX test's
  tolerance) and the same ``len(_cache)``;
- ``test_train_step_matches_eager``: the JAX compiled step against the
  port's ``to_static`` step, 5 Adam steps from the same weights, losses
  and parameters at f32 atol = rtol = 1e-6 (the tolerance of
  ``tests/test_torch_optimizer.py``);
- ``test_lr_scheduler_no_retrace``: ``StepDecay`` with SGD; one program
  in each package, and the parameters equal after the scheduler steps;
- ``test_dropout_rng_advances``: two calls differ, the mean within 0.2
  of 1, and the seed stream stands where eager calls leave it;
- the capture contract: over 3 steps of ``to_static(train_fn)`` on a
  small GPT with dropout, AdamW under O2 with master weights, a
  ``GradScaler``, ``ClipGradByGlobalNorm`` and a ``LinearWarmup``
  scheduler, the ``data_ptr()`` of every parameter, accumulator,
  ``@master``, lr buffer, scaler cell and seed buffer never changes, and
  the losses equal an eager run's bit for bit;
- a failed capture raises, naming the function, and the seed tape plays
  back a recompute's redraws.

Not twinned yet: ``test_batchnorm_stats_update`` waits for ``nn.Layer``
(ROADMAP Queue 1B item 9), and ``TestSaveLoad`` for ``jit.save``/``load``
(Queue 1C item 16).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as paddle
from paddle_tpu import jit as jjit
from paddle_tpu_torch import amp, generator, jit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import _modules
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn import functional as F
from torch_suite import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _models(seed=7):
    """The JAX test's model and data, and the port's model with its
    weights (transposed into ``[out, in]``)."""
    pt.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tm = torch.nn.Sequential(_modules.Linear(8, 16), torch.nn.ReLU(),
                             _modules.Linear(16, 4))
    with torch.no_grad():
        for i in (0, 2):
            tm[i].weight.copy_(torch.from_numpy(
                np.array(jm[i].weight.numpy()).T))
            tm[i].bias.copy_(torch.from_numpy(np.array(jm[i].bias.numpy())))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((32, 8)).astype("float32")
    y = rng.integers(0, 4, (32,))
    return jm, tm, x, y


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") and not isinstance(
        t, torch.Tensor) else t.detach().numpy(), np.float32)


def test_forward_matches_eager():
    jm, tm, x, _ = _models()
    eager = tm(torch.from_numpy(x)).detach().numpy()
    jfwd = jjit.to_static(lambda t: jm(t))
    tfwd = jit.to_static(lambda t: tm(t))
    for _ in range(2):  # warm-up, then the program
        j = np.asarray(jfwd(pt.to_tensor(x)).numpy())
        t = tfwd(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(t, eager, **TOL)
        np.testing.assert_allclose(t, j, **TOL)
    assert len(tfwd._cache) == len(jfwd._cache) == 1
    assert tfwd.compile_counts() == {"signatures": 1, "captured": 1,
                                     "calls": 2}


def test_retrace_on_new_shape():
    jm, tm, x, _ = _models()
    jfwd = jjit.to_static(lambda t: jm(t))
    tfwd = jit.to_static(lambda t: tm(t))
    for f, mk in ((jfwd, pt.to_tensor), (tfwd, torch.from_numpy)):
        f(mk(x))
        f(mk(x))
        out = f(mk(x[:8]))
        assert tuple(out.shape) == (8, 4)
    assert len(tfwd._cache) == len(jfwd._cache) == 2


def test_layer_decoration():
    jm, tm, x, _ = _models()
    ref = tm(torch.from_numpy(x)).detach().numpy()
    jm = jjit.to_static(jm)
    tm = jit.to_static(tm)
    for _ in range(2):
        jout = np.asarray(jm(pt.to_tensor(x)).numpy())
        tout = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(tout, ref, **TOL)
    np.testing.assert_allclose(tout, jout, **TOL)
    assert isinstance(tm.forward, jit.StaticFunction)
    assert len(tm.forward._cache) == len(jm.forward._cache) == 1


def test_train_step_matches_eager():
    """5 Adam steps: the JAX compiled step against the port's
    ``to_static`` step, and the port's eager step."""
    jm, tm, x, y = _models(seed=3)
    _, tm_eager, _, _ = _models(seed=3)
    jo = pt.optimizer.Adam(learning_rate=1e-2, parameters=jm.parameters())
    to = topt.Adam(learning_rate=1e-2, parameters=tm.parameters())
    te = topt.Adam(learning_rate=1e-2, parameters=tm_eager.parameters())

    @jjit.to_static
    def jstep(xb, yb):
        loss = JF.cross_entropy(jm(xb), yb)
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss

    def make(model, opt):
        def step(xb, yb):
            loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return step

    tstep = jit.to_static(make(tm, to))
    estep = make(tm_eager, te)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    jl = [float(jstep(pt.to_tensor(x), pt.to_tensor(y)).numpy())
          for _ in range(5)]
    tl = [float(tstep(xt, yt).detach()) for _ in range(5)]
    el = [float(estep(xt, yt).detach()) for _ in range(5)]
    assert tl == el
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-6)
    for i in (0, 2):
        np.testing.assert_allclose(tm[i].weight.detach().numpy().T,
                                   np.asarray(jm[i].weight.numpy()),
                                   rtol=1e-6, atol=1e-6)
    assert tl[-1] < tl[0]
    assert len(tstep._cache) == len(jstep._cache) == 1


def test_lr_scheduler_no_retrace():
    jm, tm, x, y = _models()
    js = pt.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
    ts = topt.lr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
    jo = pt.optimizer.SGD(learning_rate=js, parameters=jm.parameters())
    to = topt.SGD(learning_rate=ts, parameters=tm.parameters())

    @jjit.to_static
    def jstep(xb, yb):
        loss = JF.cross_entropy(jm(xb), yb)
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss

    @jit.to_static
    def tstep(xb, yb):
        loss = F.cross_entropy(tm(xb), yb)
        loss.backward()
        to.step()
        to.clear_grad()
        return loss

    for f, mk, s in ((jstep, pt.to_tensor, js), (tstep, torch.from_numpy,
                                                  ts)):
        f(mk(x), mk(y))
        f(mk(x), mk(y))
        s.step()
        f(mk(x), mk(y))  # lr 0.05: no new program
    assert len(tstep._cache) == len(jstep._cache) == 1
    assert float(to._lr_bufs[torch.device("cpu")]) == np.float32(0.05)
    for i in (0, 2):
        np.testing.assert_allclose(tm[i].weight.detach().numpy().T,
                                   np.asarray(jm[i].weight.numpy()),
                                   rtol=1e-6, atol=1e-6)


def test_dropout_rng_advances():
    """Two calls of a captured dropout differ (the seed slot is refilled
    each call), keep about half and rescale by 2; after three calls the
    seed stream stands where three eager calls leave it."""
    pt.seed(11)
    drop = jnn.Dropout(0.5)
    jf = jjit.to_static(lambda t: drop(t))
    generator.seed(11)
    tf = jit.to_static(lambda t: F.dropout(t, 0.5))
    for f, mk in ((jf, pt.to_tensor), (tf, torch.from_numpy)):
        x = mk(np.ones((64, 64), "float32"))
        f(x)
        a = np.asarray(f(x).numpy())
        b = np.asarray(f(x).numpy())
        assert not np.array_equal(a, b)
        assert abs(a.mean() - 1.0) < 0.2
    after = generator.next_seed()
    generator.seed(11)
    for _ in range(3):
        F.dropout(torch.ones(4), 0.5)
    assert generator.next_seed() == after
    assert len(tf._cache) == len(jf._cache) == 1


def _state_ptrs(model, opt, scaler, step):
    """Addresses of everything a captured step reads and writes."""
    return ([p.data_ptr() for p in model.parameters()]
            + [v.data_ptr() for i in sorted(opt._accumulators)
               for v in opt._accumulators[i].values()]
            + [b.data_ptr() for b in opt._lr_bufs.values()]
            + [c.data_ptr() for c in scaler.__jit_state__()]
            + [b.data_ptr() for prog in step._cache.values()
               for b in prog.tape.buffers.values()])


def _contract_run(graphed):
    generator.seed(0)
    cfg = gpt_tiny(hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
                   fused_loss=True)
    model = GPTForCausalLM(cfg, device="cpu")
    sched = topt.lr.LinearWarmup(learning_rate=1e-3, warmup_steps=3,
                                 start_lr=0.0, end_lr=1e-3)
    opt = topt.AdamW(learning_rate=sched, parameters=model.parameters(),
                     grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10, device="cpu")

    def train_fn(ids, labels):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            _, loss = model(ids, labels=labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        return loss

    step = jit.to_static(train_fn) if graphed else train_fn
    ids_np = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    ids = paddle.to_tensor(ids_np, place="cpu")
    labels = paddle.to_tensor(np.roll(ids_np, -1, 1), place="cpu")
    losses, ptrs = [], []
    for _ in range(3):
        losses.append(float(step(ids, labels).detach()))
        sched.step()
        if graphed:
            ptrs.append(_state_ptrs(model, opt, scaler, step))
    return losses, ptrs, model, opt, step


def test_capture_contract_state_written_in_place():
    losses, ptrs, model, opt, step = _contract_run(True)
    eager_losses, *_ = _contract_run(False)
    assert losses == eager_losses
    assert ptrs[0] == ptrs[1] == ptrs[2]
    low = [i for i, p in enumerate(opt._parameter_list)
           if p.dtype == torch.bfloat16]
    assert low and all("@master" in opt._accumulators[i] for i in low)
    assert all(math.isfinite(x) for x in losses)
    prog = next(iter(step._cache.values()))
    buf = prog.tape.buffers[torch.device("cpu")]
    assert int((buf != 0).sum()) >= 2 * 2  # 2 layers x (attention, hidden)
    assert step.compile_counts() == {"signatures": 1, "captured": 1,
                                     "calls": 3}


def test_failed_capture_raises_naming_the_function(monkeypatch):
    """A capture that fails (on the card: a host read of a device value)
    raises a RuntimeError that names the function and the dy2static pass,
    and falls back to nothing."""
    class _Graph:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

        def __exit__(self, *exc):
            return False

    from paddle_tpu_torch.jit import static_function as sf

    monkeypatch.setattr(sf.torch.cuda, "graph", _Graph)
    monkeypatch.setattr(sf.torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(sf.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(sf.torch.cuda, "device", lambda d: _Nothing())
    monkeypatch.setattr(sf.torch.cuda, "current_stream", lambda d: None)
    monkeypatch.setattr(sf.StaticFunction, "_side_stream",
                        lambda self, d: _Nothing())
    calls = []

    def host_sync_step(x):
        calls.append(1)
        return x * 2

    step = jit.StaticFunction(host_sync_step)
    prog = sf._Program()
    with pytest.raises(RuntimeError, match="host_sync_step.*dy2static"):
        step._capture(prog, [torch.ones(2)], ("A", 0), [True],
                      torch.device("cuda"))
    assert prog.graph is None and calls == []


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def wait_stream(self, other):
        pass


def test_seed_tape_replays_a_recompute_redraw():
    """The record of a step whose recompute sets the generator back and
    draws again plays back the same values in the same slots as the
    recorded call, and leaves the host stream where that call left it."""
    tape = generator.SeedTape()
    dev = torch.device("cpu")
    generator.seed(5)
    with tape.open("record"):
        a = generator.next_seed(dev)
        state = generator.get_rng_state()
        b = generator.next_seed(dev)
        now = generator.get_rng_state()
        generator.set_rng_state(state)
        c = generator.next_seed(dev)  # the recompute's redraw of b
        generator.set_rng_state(now)
        d = generator.next_seed(dev)
    recorded = tape.recorded_values()[dev]
    after_record = generator.next_seed()
    generator.seed(5)
    played = tape.run()[dev]
    assert played == recorded
    assert recorded[1] == recorded[2] and len(set(recorded)) == 3
    assert generator.next_seed() == after_record
    assert [t.data_ptr() for t in (a, b, c, d)] == [
        tape.buffers[dev][i].data_ptr() for i in range(4)]
