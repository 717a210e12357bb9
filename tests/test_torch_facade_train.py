"""The JAX bench's training step written against the port's Paddle
namespace, on the CPU.

- The root ``bench.py``'s ``train_fn`` (``amp.auto_cast``, ``model(ids,
  labels=labels)``, ``loss.backward()``, ``opt.step()``,
  ``opt.clear_grad()``, ``loss.numpy()``) on ``gpt_tiny`` for 3 steps in
  both packages, eagerly, from the JAX model's weights carried by
  ``load_reference_state_dict``; the port's side takes and returns facade
  tensors. ``tests/test_torch_gpt.py``'s tolerances: f32 (``epsilon``
  1e-6) losses and parameters within 1e-5; O2 bf16 losses within rtol
  1e-3, the updates within 10% of their norm, cosine >= 0.995.
- On the port alone, ``bench.facade_step`` (the same step through the
  facade) gives ``bench.make_train_fn``'s losses (torch tensors in) bit
  for bit.
- Facade SDPA on ``[B, S, H, D]`` equals the JAX package's
  ``F.scaled_dot_product_attention``, forward and grads.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import amp, bench
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     load_reference_state_dict)
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

TOL = 1e-5


def _flat_jax(jm):
    return np.concatenate([np.asarray(p.numpy()).astype(np.float32).ravel()
                           for p in jm.parameters()])


def _flat_port(tm):
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    out = []
    for n, p in tm.named_parameters():
        a = p.detach().float().numpy()
        out.append((a.T if n in linear else a).ravel())
    return np.concatenate(out)


def _train_both(decorate, steps=3, **opt_kw):
    """The bench's train_fn in each package; the port's written with
    facade tensors. Returns losses, and parameters before and after."""
    pt.seed(0)
    jm = JaxGPT(jax_gpt_tiny(fused_loss=True))
    ref = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(fused_loss=True), seed=1)
    load_reference_state_dict(tm, ref)
    jo = pt.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                            **opt_kw)
    to = paddle.optimizer.AdamW(learning_rate=1e-3,
                                parameters=tm.parameters(), **opt_kw)
    if decorate is not None:
        jm, jo = jamp.decorate(jm, jo, level="O2", dtype="bfloat16",
                               master_weight=decorate)
        tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16",
                              master_weight=decorate)
    on = decorate is not None
    before = (_flat_jax(jm), _flat_port(tm))
    rng = np.random.default_rng(1)
    ids_np = rng.integers(0, 512, (2, 32))
    labels_np = np.roll(ids_np, -1, axis=1)
    losses = ([], [])
    for P, m, o, amp_, out in ((pt, jm, jo, jamp, losses[0]),
                               (paddle, tm, to, amp, losses[1])):
        ids, labels = P.to_tensor(ids_np), P.to_tensor(labels_np)
        for _ in range(steps):
            with amp_.auto_cast(enable=on, level="O2", dtype="bfloat16"):
                _, loss = m(ids, labels=labels)
            loss.backward()
            o.step()
            o.clear_grad()
            out.append(float(np.asarray(loss.numpy(), dtype="float32")))
    assert isinstance(loss, paddle.Tensor)
    assert all(p.grad is None for p in tm.parameters())
    return losses, before, (_flat_jax(jm), _flat_port(tm))


def test_bench_step_f32_matches_the_jax_package():
    (jl, tl), before, after = _train_both(None, epsilon=1e-6)
    np.testing.assert_array_equal(before[1], before[0])
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
    assert jl[-1] < jl[0]
    np.testing.assert_allclose(after[1], after[0], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("master", [False, True])
def test_bench_step_o2_bf16_matches_the_jax_package(master):
    (jl, tl), before, after = _train_both(master)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    dj, dt = after[0] - before[0], after[1] - before[1]
    assert np.linalg.norm(dt - dj) <= 0.1 * np.linalg.norm(dj)
    assert dj @ dt >= 0.995 * np.linalg.norm(dj) * np.linalg.norm(dt)


def test_facade_step_equals_the_torch_step_bit_for_bit():
    """``bench.facade_step`` (facade ids, ``model.parameters()``, the
    default device) and the bench's own step (torch ids,
    ``named_parameters()``) draw the same weights and ids and give the
    same losses, bit for bit."""
    cfg = gpt_tiny(fused_loss=True, vocab_size=512)
    B, S = 2, 32
    step, (ids, labels), model, opt = bench.facade_step(cfg, B, S)
    facade = [step(ids, labels) for _ in range(3)]
    assert all(isinstance(x, paddle.Tensor) for x in facade)
    model2, opt2 = bench.build(cfg, torch.device("cpu"), False)
    train = bench.make_train_fn(model2, opt2)
    rng = np.random.default_rng(0)
    ids_np = rng.integers(0, cfg.vocab_size, (B, S))
    tids = torch.from_numpy(ids_np)
    tlabels = torch.from_numpy(np.roll(ids_np, -1, axis=1))
    plain = [train(tids, tlabels) for _ in range(3)]
    assert [float(x) for x in facade] == [x.item() for x in plain]
    for (n, p), q in zip(model2.named_parameters(), model.parameters()):
        assert torch.equal(p, q), n


def test_facade_sdpa_matches_the_jax_package():
    """``F.scaled_dot_product_attention`` on facade ``[B, S, H, D]``
    tensors (causal and not) against the JAX functional, forward and
    the grads of q, k and v, f32 at 1e-5."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.RandomState(3)
    arrs = [rng.randn(2, 16, 2, 8).astype("float32") for _ in range(3)]
    for causal in (False, True):
        outs, grads = [], []
        for P, F in ((pt, JF), (paddle, TF)):
            q, k, v = [P.to_tensor(a, stop_gradient=False) for a in arrs]
            o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            (o * o).sum().backward()
            outs.append(np.asarray(o.numpy()))
            grads.append([np.asarray(t.grad.numpy()) for t in (q, k, v)])
        assert isinstance(o, paddle.Tensor)
        np.testing.assert_allclose(outs[1], outs[0], atol=TOL, rtol=TOL)
        for a, b in zip(grads[0], grads[1]):
            np.testing.assert_allclose(b, a, atol=TOL, rtol=TOL)
    fo, none = TF.flash_attention(*[paddle.to_tensor(a) for a in arrs],
                                  causal=True)
    assert none is None and isinstance(fo, paddle.Tensor)


def test_adamw_on_facade_parameters_matches_and_writes_in_place():
    """``optimizer.AdamW`` over facade ``Parameter``s (a toy regression
    written in facade ops) gives the JAX package's parameters after three
    steps, and writes each parameter's storage in place (a module or a
    captured graph holding it sees the step)."""
    rng = np.random.RandomState(5)
    w0 = rng.randn(4, 3).astype("float32")
    b0 = rng.randn(3).astype("float32")
    xs = rng.randn(8, 4).astype("float32")
    ys = rng.randn(8, 3).astype("float32")
    results = []
    for P in (pt, paddle):
        w, b = P.Parameter(w0), P.Parameter(b0)
        opt = P.optimizer.AdamW(learning_rate=1e-2, parameters=[w, b],
                                epsilon=1e-6)
        x, y = P.to_tensor(xs), P.to_tensor(ys)
        ptrs = (w._value.data_ptr(), b._value.data_ptr()) \
            if P is paddle else None
        for _ in range(3):
            loss = P.mean((P.matmul(x, w) + b - y) ** 2)
            loss.backward()
            opt.step()
            opt.clear_grad()
        if ptrs is not None:
            assert (w._value.data_ptr(), b._value.data_ptr()) == ptrs
            assert w.grad is None and not w.stop_gradient
        results.append((w.numpy(), b.numpy(), float(loss)))
    (jw, jb, jl), (tw, tb, tl) = results
    np.testing.assert_allclose(tw, jw, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tb, jb, atol=TOL, rtol=TOL)
    assert tl == pytest.approx(jl, rel=TOL)
