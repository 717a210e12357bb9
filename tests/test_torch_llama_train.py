"""paddle_tpu_torch's Llama training path against the JAX package's: the
dense forward with its loss, recompute, AdamW steps under O2, and
``paddle_tpu_torch.bench --model llama``.

The JAX ``llama_tiny`` (GQA: 4 query heads of 32 over 2 kv heads) is
built from its own seed and its ``state_dict`` carried across with
``load_reference_state_dict``; token ids come from numpy. Both packages
run the same forward, backward and AdamW steps eagerly (the bench's
``train_fn``, without ``StaticFunction``). On the CPU the port's flash
attention is its plain version; the JAX package's is its dense reference.

Tolerances (atol = rtol): f32 logits, losses and grads 1e-5 (the same
f32 math over two layers in other summation orders: a few ulps); the
port's grads with recompute against its own without 1e-6 (the same ops
run again); three f32 AdamW steps 1e-5, with ``epsilon=1e-6`` as in
tests/test_torch_gpt.py. O2 bf16 with master weights: losses rtol 1e-3,
and the three steps' updates within 10% of their norm with cosine >=
0.995, as for GPT (bf16 grads carry ~3 digits and Adam turns the sign of
a near-zero grad into a full step).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch import amp, generator
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, gpt_tiny, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW

TOL = 1e-5
S = 32


def _pair(**kw):
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**kw))
    ref = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu", seed=1)
    load_reference_state_dict(tm, ref)
    return jm, tm


def _linear_weights(tm):
    return {f"{n}.weight" for n, m in tm.named_modules()
            if isinstance(m, torch.nn.Linear)}


def _as_jax_layout(tm, name, t):
    a = t.detach().float().numpy()
    return a.T if name in _linear_weights(tm) else a


def _ids(seed, vocab=512, B=2):
    ids = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return ids, np.roll(ids, -1, axis=1)


def _jax_grads(jm, ids, labels):
    _, loss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward()
    return float(loss.numpy()), {n: np.asarray(p.grad.numpy())
                                 for n, p in jm.named_parameters()}


def _torch_grads(tm, ids, labels):
    _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("fused", [False, True])
def test_loss_and_grads_match(fused):
    jm, tm = _pair(fused_loss=fused)
    ids, labels = _ids(0)
    j_logits, j_loss = jm(paddle.to_tensor(ids),
                          labels=paddle.to_tensor(labels))
    j_loss.backward()
    t_logits, t_loss = tm(torch.from_numpy(ids),
                          labels=torch.from_numpy(labels))
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss.numpy()),
                               atol=TOL, rtol=TOL)
    if fused:
        assert j_logits is None and t_logits is None
    else:
        np.testing.assert_allclose(t_logits.detach().numpy(),
                                   np.asarray(j_logits.numpy()),
                                   atol=TOL, rtol=TOL)
    t_params = dict(tm.named_parameters())
    assert {n for n, _ in jm.named_parameters()} == set(t_params)
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(_as_jax_layout(tm, n, t_params[n].grad),
                                   np.asarray(p.grad.numpy()), atol=TOL,
                                   rtol=TOL, err_msg=n)


def test_logits_match_without_labels():
    jm, tm = _pair()
    ids, _ = _ids(3)
    np.testing.assert_allclose(
        tm(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jm(paddle.to_tensor(ids)).numpy()), atol=TOL, rtol=TOL)


def test_recompute_grads_match():
    """Every layer under recompute: the port's grads equal its own without
    recompute and the JAX package's with it; the forward's attention runs
    twice per layer (forward and recomputation), the backward's once."""
    jm, tm = _pair(fused_loss=True, recompute=True)
    ids, labels = _ids(5)
    j_loss, j_grads = _jax_grads(jm, ids, labels)
    tfa.reset_counters()
    t_loss, t_grads = _torch_grads(tm, ids, labels)
    layers = tm.config.num_layers
    assert tfa.plain_calls == {"flash_fwd": 2 * layers, "flash_dq": layers,
                               "flash_dkv": layers}
    tm.zero_grad(set_to_none=True)
    tm.config.recompute = False
    p_loss, p_grads = _torch_grads(tm, ids, labels)
    assert abs(t_loss - p_loss) <= 1e-6 * abs(p_loss)
    np.testing.assert_allclose(t_loss, j_loss, atol=TOL, rtol=TOL)
    for n, g in t_grads.items():
        torch.testing.assert_close(g, p_grads[n], atol=1e-6, rtol=1e-6,
                                   msg=n)
        np.testing.assert_allclose(_as_jax_layout(tm, n, g), j_grads[n],
                                   atol=TOL, rtol=TOL, err_msg=n)


def _train(jm, tm, steps, master=None, **opt_kw):
    """The bench's train_fn on both sides (O2 bf16 when ``master`` is not
    None); returns the losses, the parameters before and after in the JAX
    layout, and the port's optimizer."""
    jo = paddle.optimizer.AdamW(learning_rate=1e-3,
                                parameters=jm.parameters(), **opt_kw)
    to = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(), **opt_kw)
    on = master is not None
    if on:
        jm, jo = jamp.decorate(jm, jo, level="O2", dtype="bfloat16",
                               master_weight=master)
        tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16",
                              master_weight=master)

    def flat():
        j = np.concatenate([np.asarray(p.numpy()).astype(np.float32).ravel()
                            for p in jm.parameters()])
        t = np.concatenate([_as_jax_layout(tm, n, p).ravel()
                            for n, p in tm.named_parameters()])
        return j, t

    before = flat()
    ids, labels = _ids(1)
    losses = ([], [])
    for _ in range(steps):
        with jamp.auto_cast(enable=on, level="O2", dtype="bfloat16"):
            _, loss = jm(paddle.to_tensor(ids),
                         labels=paddle.to_tensor(labels))
        loss.backward()
        jo.step()
        jo.clear_grad()
        losses[0].append(float(np.asarray(loss.numpy(), np.float32)))
        with amp.auto_cast(enable=on, level="O2", dtype="bfloat16"):
            _, loss = tm(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels))
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


@pytest.mark.parametrize("rc", [False, True])
def test_three_adamw_steps_match_o2_bf16_master(rc):
    """``bench_llama``'s precision: O2 bf16 with master weights, without
    and with recompute (under which both packages cast the layer's f32
    norm weights to bf16 on the way into the recomputed block)."""
    jm, tm = _pair(fused_loss=True, recompute=rc)
    (j_losses, t_losses), before, after, opt = _train(jm, tm, 3, master=True)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    np.testing.assert_array_equal(before[0], before[1])
    dj, dt = after[0] - before[0], after[1] - before[1]
    assert np.linalg.norm(dt - dj) <= 0.1 * np.linalg.norm(dj)
    assert dj @ dt >= 0.995 * np.linalg.norm(dj) * np.linalg.norm(dt)
    # decorate kept the norms f32 and made the rest bf16; the moments of
    # a bf16 parameter start bf16 and are f32 after the first update
    for n, p in tm.named_parameters():
        assert p.dtype == (torch.float32 if "norm" in n else torch.bfloat16)
    accs = opt._accumulators[0]  # the embedding
    assert accs["@master"].dtype == torch.float32
    assert accs["moment1"].dtype == accs["moment2"].dtype == torch.float32
    assert "@master" not in opt._accumulators[1]  # an f32 norm weight


def test_o2_cast_points():
    """Under O2 the layer norms compute in f32 (f32 out), RoPE and the
    attention in bf16, the residual stream in bf16."""
    _jm, tm = _pair()
    amp.decorate(tm, level="O2", dtype="bfloat16")
    seen = {}

    def hook(name):
        def fn(_mod, _inp, out):
            seen[name] = out.dtype
        return fn

    layer = tm.llama.layers[0]
    layer.input_layernorm.register_forward_hook(hook("norm"))
    layer.self_attn.register_forward_hook(hook("attn"))
    layer.register_forward_hook(hook("layer"))
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        out = tm(torch.from_numpy(_ids(2)[0]))
    assert seen == {"norm": torch.float32, "attn": torch.bfloat16,
                    "layer": torch.bfloat16}
    assert out.dtype == torch.bfloat16  # the lm_head is a bf16 linear


def test_bench_llama_small_runs_on_cpu():
    """``python -m paddle_tpu_torch.bench --model llama --small --device
    cpu``: the record's fields, finite losses, one loss per step run."""
    from paddle_tpu_torch import bench

    rec = bench.bench_llama(small=True, device="cpu", steps=1, reps=1)
    assert rec["metric"] == "llama_tokens_per_sec_per_chip"
    assert rec["config"] == "llama-h128-l2-b2-s128-bf16-fce"
    assert rec["device"] == "cpu" and rec["mfu"] is None
    assert rec["steps_run"] == len(rec["losses"]) == 4
    assert all(np.isfinite(rec["losses"]))
    cfg = bench.llama_setup(False)[0]
    assert bench.config_name("llama", cfg, 8, 1024) == \
        "llama-h2048-l12-b8-s1024-bf16-rc-fce"


def test_recompute_policies_and_sequence_parallel_raise():
    layer = torch.nn.Linear(4, 4)
    x = torch.ones(2, 4, requires_grad=True)
    for policy in ("dots", "dots_saveable", "dots_no_batch",
                   "dots_with_no_batch_dims"):
        with pytest.raises(NotImplementedError):
            recompute(layer, x, policy=policy)
    with pytest.raises(ValueError):
        recompute(layer, x, policy="bogus")
    assert torch.equal(recompute(layer, x, policy="full"), layer(x))
    with pytest.raises(NotImplementedError):
        LlamaConfig(sequence_parallel=True)


@pytest.mark.parametrize("preserve", [True, False])
def test_recompute_replays_the_dropout_draws(preserve):
    """A GPT layer with dropout: under recompute the backward's rerun
    draws the forward's seeds again (the grads equal those of a plain
    run from the same seed); without ``preserve_rng_state`` it draws new
    ones and the grads part."""
    model = GPTForCausalLM(gpt_tiny(hidden_dropout_prob=0.2,
                                    attention_dropout_prob=0.2),
                           device="cpu", seed=2)
    layer = model.gpt.layers[0]
    x = torch.randn(2, 16, 128, generator=torch.Generator().manual_seed(0))

    def grads(fn):
        generator.seed(9)
        xi = x.clone().requires_grad_()
        fn(xi).square().sum().backward()
        out = [xi.grad] + [p.grad.clone() for p in layer.parameters()]
        layer.zero_grad(set_to_none=True)
        return out

    plain = grads(layer)
    rc = grads(lambda xi: recompute(layer, xi, preserve_rng_state=preserve))
    same = all(torch.allclose(a, b, atol=1e-6, rtol=1e-6)
               for a, b in zip(plain, rc))
    assert same == preserve
