"""The bench's step through ``jit.StaticFunction``, on the CPU.

- ``bench.bench_model("gpt13", small=True, device="cpu")``: the default
  step (the root ``bench.py``'s ``jit.StaticFunction(train_fn,
  observe=[model, opt], warmup=False)`` over ``paddle.to_tensor`` ids)
  and ``eager=True`` (``train_fn`` on torch tensors) give losses equal
  bit for bit (on the CPU both run eagerly), with one signature.
- Its losses follow the JAX package's ``bench_gpt13(small)`` step (the
  root bench's model, decorate, AdamW and ``StaticFunction`` at its small
  configuration) from the same weights, carried by
  ``load_reference_state_dict``, at ``tests/test_torch_facade_train.py``'s
  O2 bf16 tolerance (rtol 1e-3).
- The flash plain versions, given the dropout seed as a 0-d int32
  tensor, equal the JAX package's ``_flash_fwd_bhsd`` and
  ``_flash_bwd_bhsd`` in interpret mode at dropout 0.1, at
  ``tests/test_torch_flash_attention.py``'s tolerance (f32 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import bench, jit
from paddle_tpu_torch.models import load_reference_state_dict
from paddle_tpu_torch.ops import flash_attention as tfa
from torch_suite import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def test_graphed_bench_equals_eager_bench_on_cpu():
    g = bench.bench_model("gpt13", small=True, device="cpu", steps=1,
                          reps=1)
    e = bench.bench_model("gpt13", small=True, device="cpu", steps=1,
                          reps=1, eager=True)
    assert g["losses"] == e["losses"] and len(g["losses"]) == 4
    assert g["compile_counts"] == {"signatures": 1, "captured": 1,
                                   "calls": 4}
    assert g["graphed"] is False and g["capture_s"] is None  # no card
    assert e["compile_counts"] is None


def test_bench_step_follows_the_jax_bench_step():
    """``bench_gpt13(small)``'s step in both packages from the same
    weights, 3 steps."""
    from paddle_tpu import amp as jamp
    from paddle_tpu import jit as jjit
    from paddle_tpu.models import GPTConfig as JaxConfig
    from paddle_tpu.models import GPTForCausalLM as JaxGPT

    cfg, B, S, steps = bench.gpt13_setup(True)
    pt.seed(0)
    jcfg = JaxConfig(vocab_size=cfg.vocab_size, hidden_size=256,
                     num_layers=4, num_heads=2, max_position_embeddings=512,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     fused_loss=True)
    jm = JaxGPT(jcfg)
    jo = pt.optimizer.AdamW(learning_rate=1e-4, parameters=jm.parameters())
    jm, jo = jamp.decorate(jm, jo, level="O2", dtype="bfloat16",
                           master_weight=False)

    def jtrain(ids, labels):
        with jamp.auto_cast(level="O2", dtype="bfloat16"):
            _, loss = jm(ids, labels=labels)
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss

    tm, to = bench.build(cfg, torch.device("cpu"), False)
    load_reference_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in
                                   jm.state_dict().items()})
    jstep = jjit.StaticFunction(jtrain, observe=[jm, jo], warmup=False)
    tstep = jit.StaticFunction(bench.make_train_fn(tm, to),
                               observe=[tm, to], warmup=False)
    ids_np = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    labels_np = np.roll(ids_np, -1, axis=1)
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(np.asarray(jstep(pt.to_tensor(ids_np),
                                         pt.to_tensor(labels_np)).numpy(),
                                   "float32")))
        tl.append(float(np.asarray(tstep(
            paddle.to_tensor(ids_np, place="cpu"),
            paddle.to_tensor(labels_np, place="cpu")).numpy(), "float32")))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    assert len(tstep._cache) == len(jstep._cache) == 1


def _bh(a):
    b, s, h, d = a.shape
    return jnp.swapaxes(jnp.asarray(a), 1, 2).reshape(b * h, s, d)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_with_seed_tensor_matches_pallas(causal):
    """K1-K3's plain versions, the seed a 0-d int32 tensor, against the
    Pallas kernels (``_flash_fwd_bhsd``, ``_flash_bwd_bhsd``) at dropout
    0.1 with the same seed."""
    B, S, H, D, seed, p = 2, 128, 2, 64, 4321, 0.1
    rng = np.random.default_rng(9)
    q, k, v, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    o_j, lse_j = jfa._flash_fwd_bhsd(_bh(q), _bh(k), _bh(v), causal, scale,
                                     drop_p=p, drop_seed=seed)
    dq_j, dk_j, dv_j = jfa._flash_bwd_bhsd(
        _bh(q), _bh(k), _bh(v), o_j, lse_j, _bh(do), causal, scale,
        drop_p=p, drop_seed=seed)
    seed_t = torch.tensor(seed, dtype=torch.int32)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o_t, lse_t = tfa.flash_fwd(qt, kt, vt, causal, scale, p, seed_t)
    dq_t, dk_t, dv_t = tfa.flash_bwd(qt, kt, vt, o_t, lse_t, dot, causal,
                                     scale, p, seed_t)

    def back(x):  # [B*H, S, D] -> [B, S, H, D]
        return np.swapaxes(np.asarray(x, np.float32).reshape(B, H, S, D),
                           1, 2)

    for got, want in ((o_t, back(o_j)), (dq_t, back(dq_j)),
                      (dk_t, back(dk_j)), (dv_t, back(dv_j))):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-5)
    # the seed is read as data: another value drops other elements
    o_other, _ = tfa.flash_fwd(qt, kt, vt, causal, scale, p,
                               torch.tensor(seed + 1, dtype=torch.int32))
    assert not torch.equal(o_other, o_t)
    o_int, _ = tfa.flash_fwd(qt, kt, vt, causal, scale, p, seed)
    assert torch.equal(o_int, o_t)
