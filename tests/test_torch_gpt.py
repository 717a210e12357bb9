"""paddle_tpu_torch.models.gpt against the JAX package's GPT, and the
training step of ``paddle_tpu_torch.bench``.

The JAX ``gpt_tiny`` is built from its own seed and its ``state_dict``
carried across with ``load_reference_state_dict``; token ids come from
numpy. Both packages then run the same forward, backward and AdamW steps
eagerly (the bench's ``train_fn``, without ``StaticFunction``).

Tolerances, f32 (atol = rtol): logits and loss 1e-5, grads 1e-5 (the
same f32 math over two layers, summed in other orders: a few ulps).
Three AdamW steps, f32: losses and parameters 1e-5, with ``epsilon=1e-6``
-- at the default 1e-8 the update m/(sqrt(v) + eps) of a parameter whose
grad is itself ~1e-8 is a sign that summation order can flip, which
moves that one element by up to 2 lr. bf16 under
``amp.decorate(level="O2")``, with and without master weights: the
losses agree to rtol 1e-3, and the three steps' parameter updates to 10%
of their norm (measured: 4.4%) with cosine >= 0.995 -- bf16 grads carry
~3 significant digits, and Adam turns the sign of every near-zero grad
into a full-size step, so elements part where the two packages round a
grad near zero differently.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW

TOL = 1e-5


def _pair(**kw):
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(**kw))
    ref = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(**kw), device="cpu", seed=1)
    load_reference_state_dict(tm, ref)
    return jm, tm


def _linear_weights(tm):
    return {f"{n}.weight" for n, m in tm.named_modules()
            if isinstance(m, torch.nn.Linear)}


def _as_jax_layout(tm, name, t):
    a = t.detach().float().numpy()
    return a.T if name in _linear_weights(tm) else a


def _ids(seed, vocab, B, S):
    ids = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return ids, np.roll(ids, -1, axis=1)


@pytest.mark.parametrize("fused", [False, True])
def test_loss_and_grads_match(fused):
    jm, tm = _pair(fused_loss=fused)
    ids, labels = _ids(0, 512, 2, 32)
    j_logits, j_loss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    j_loss.backward()
    t_logits, t_loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss.numpy()),
                               atol=TOL, rtol=TOL)
    if fused:
        assert j_logits is None and t_logits is None
    else:
        np.testing.assert_allclose(t_logits.detach().numpy(),
                                   np.asarray(j_logits.numpy()),
                                   atol=TOL, rtol=TOL)
    j_grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    t_params = dict(tm.named_parameters())
    assert set(j_grads) == set(t_params)
    for n, p in t_params.items():
        np.testing.assert_allclose(_as_jax_layout(tm, n, p.grad), j_grads[n],
                                   atol=TOL, rtol=TOL, err_msg=n)


def test_logits_match_without_labels():
    jm, tm = _pair()
    ids, _ = _ids(3, 512, 2, 16)
    np.testing.assert_allclose(
        tm(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jm(paddle.to_tensor(ids)).numpy()), atol=TOL, rtol=TOL)


def test_long_sequence_routes_to_plain_flash():
    """At S = 512 the JAX side (off the TPU) runs its dense _sdpa_ref; the
    port routes every layer to flash attention's plain version and its
    backward, with the same result."""
    jm, tm = _pair(max_position_embeddings=512, num_layers=1)
    ids, labels = _ids(1, 512, 1, 512)
    _, j_loss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    j_loss.backward()
    tfa.reset_counters()
    _, t_loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    t_loss.backward()
    assert tfa.plain_calls == dict.fromkeys(tfa.KERNELS, 1)
    assert tfa.kernel_launches == dict.fromkeys(tfa.KERNELS, 0)
    np.testing.assert_allclose(t_loss.item(), float(j_loss.numpy()),
                               atol=TOL, rtol=TOL)
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(
            _as_jax_layout(tm, n, dict(tm.named_parameters())[n].grad),
            np.asarray(p.grad.numpy()), atol=TOL, rtol=TOL, err_msg=n)


def _train(jm, tm, steps, decorate=None, **opt_kw):
    """The bench's train_fn on both sides; returns the losses and the
    parameters before and after, flattened in the JAX layout."""
    jo = paddle.optimizer.AdamW(learning_rate=1e-3,
                                parameters=jm.parameters(), **opt_kw)
    to = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(), **opt_kw)
    if decorate is not None:
        jm, jo = jamp.decorate(jm, jo, level="O2", dtype="bfloat16",
                               master_weight=decorate)
        tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16",
                              master_weight=decorate)

    def flat():
        j = np.concatenate([np.asarray(p.numpy()).astype(np.float32).ravel()
                            for p in jm.parameters()])
        t = np.concatenate([_as_jax_layout(tm, n, p).ravel()
                            for n, p in tm.named_parameters()])
        return j, t

    before = flat()
    ids, labels = _ids(1, 512, 2, 32)
    on = decorate is not None
    losses = ([], [])
    for _ in range(steps):
        with jamp.auto_cast(enable=on, level="O2", dtype="bfloat16"):
            _, loss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss.backward()
        jo.step()
        jo.clear_grad()
        losses[0].append(float(np.asarray(loss.numpy(), np.float32)))
        with amp.auto_cast(enable=on, level="O2", dtype="bfloat16"):
            _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        to.step()
        to.clear_grad()
        losses[1].append(loss.item())
    assert all(p.grad is None for p in tm.parameters())
    return losses, before, flat(), to


def test_three_adamw_steps_match_f32():
    jm, tm = _pair(fused_loss=True)
    (j_losses, t_losses), before, after, _ = _train(jm, tm, 3, epsilon=1e-6)
    np.testing.assert_allclose(t_losses, j_losses, atol=TOL, rtol=TOL)
    assert j_losses[-1] < j_losses[0]
    np.testing.assert_array_equal(before[0], before[1])
    np.testing.assert_allclose(after[1], after[0], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("master", [False, True])
def test_three_adamw_steps_match_o2_bf16(master):
    jm, tm = _pair(fused_loss=True)
    (j_losses, t_losses), before, after, opt = _train(jm, tm, 3,
                                                      decorate=master)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    np.testing.assert_array_equal(before[0], before[1])
    dj, dt = after[0] - before[0], after[1] - before[1]
    assert np.linalg.norm(dt - dj) <= 0.1 * np.linalg.norm(dj)
    assert dj @ dt >= 0.995 * np.linalg.norm(dj) * np.linalg.norm(dt)
    # decorate kept the norms f32 and made the rest bf16; the moments
    # follow the parameter's dtype without master weights
    for n, p in tm.named_parameters():
        want = torch.float32 if ".ln" in n else torch.bfloat16
        assert p.dtype == want, n
    accs = opt._accumulators[0]  # the embedding
    assert ("@master" in accs) == master
    assert accs["moment1"].dtype == (torch.float32 if master
                                     else torch.bfloat16)


def test_bf16_state_dict_carries_bit_for_bit():
    """An O2-decorated JAX model's bf16 state_dict (ml_dtypes.bfloat16
    arrays) lands in the port unchanged, compared as int16 patterns."""
    paddle.seed(0)
    jm = jamp.decorate(JaxGPT(jax_gpt_tiny()), level="O2", dtype="bfloat16")
    ref = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert ref["gpt.embeddings.weight"].dtype == ml_dtypes.bfloat16
    assert ref["gpt.ln_f.weight"].dtype == np.float32
    tm = amp.decorate(GPTForCausalLM(gpt_tiny(), device="cpu", seed=1),
                      level="O2", dtype="bfloat16")
    load_reference_state_dict(tm, ref)
    lin = _linear_weights(tm)
    for n, p in tm.named_parameters():
        src = ref[n].T if n in lin else ref[n]
        if src.dtype == ml_dtypes.bfloat16:
            assert p.dtype == torch.bfloat16, n
            np.testing.assert_array_equal(p.detach().view(torch.int16).numpy(),
                                          src.view(np.int16), err_msg=n)
        else:
            np.testing.assert_array_equal(p.detach().numpy(), src, err_msg=n)


def test_bench_small_step_runs_on_cpu():
    """``python -m paddle_tpu_torch.bench --small --device cpu``: the
    record's fields, finite losses, one loss per step run."""
    from paddle_tpu_torch import bench

    rec = bench.bench_gpt13(small=True, device="cpu", steps=1, reps=1)
    for key in ("metric", "value", "config", "params_m", "loss", "step_ms",
                "achieved_tflops_per_s", "mfu", "device"):
        assert key in rec
    assert rec["metric"] == "gpt13_tokens_per_sec_per_chip"
    assert rec["device"] == "cpu" and rec["mfu"] is None
    assert rec["steps_run"] == len(rec["losses"]) == 4
    assert all(np.isfinite(rec["losses"]))


def test_dropout_in_training_only():
    """With dropout on, a training forward draws fresh masks (two calls
    differ) and an eval forward is deterministic and equals the dropout-
    free model; ``F.dropout`` keeps about 1 - p and rescales by it."""
    from paddle_tpu_torch.nn import functional as F

    model = GPTForCausalLM(gpt_tiny(hidden_dropout_prob=0.1,
                                    attention_dropout_prob=0.1),
                           device="cpu", seed=2)
    plain = GPTForCausalLM(gpt_tiny(), device="cpu", seed=2)
    ids = torch.from_numpy(_ids(4, 512, 2, 16)[0])
    a, b = model(ids), model(ids)
    assert not torch.equal(a, b)
    model.eval()
    torch.testing.assert_close(model(ids), plain(ids), atol=0, rtol=0)
    x = torch.ones(200_000)
    y = F.dropout(x, 0.25, generator=torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.all((y == 0) | (y == 1 / 0.75))
    assert F.dropout(x, 0.25, training=False) is x
