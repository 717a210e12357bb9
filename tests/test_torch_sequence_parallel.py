"""The ``sep`` paths of the port's GPT and Llama on four gloo ranks
against the JAX package's on its 8-device host mesh and against the
port's dense models, the JAX models' weights carried across:

- GPT at ``sep`` 4 (``tests/test_pipeline.py:404``): the gathered logits
  against one device and against the JAX package's at ``sep`` 4, at
  rtol 2e-3 / atol 2e-4; and with ``position_ids`` given, which split
  with the ids;
- Llama (``llama_tiny`` at one layer) at ``sep`` 2 beside ``dp`` 2
  (``tests/test_nn_tail.py:279``),
  through ``fleet.distributed_model``, with unequal ignored labels per
  chunk (the first chunk mostly ``-100``): the loss and every gradient
  against JAX's ``sep`` 2 run and the port's dense model, at rtol 2e-4
  (the JAX test's) / atol 1e-6; the loss is the global mean, not a mean
  of the chunks' means; and each ``dp`` group on its half of the batch
  (gradients averaged over ``dp``, summed over ``sep``) against the
  dense model on the whole;
- GPT with attention dropout 0.5 in training at ``sep`` 4: equal to
  ``sep`` 1 (the same dropout bits: the queries run at their global
  rows), at 1e-5.

RoPE's rows and GPT's position ids are the chunk's global positions:
every comparison above fails without them. The ranks are spawned once
for the file (``torch_sep_moe_ranks.sequence_parallel_cases``).
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny

import torch_sep_moe_ranks
from torch_suite import one_torch_thread  # noqa: F401

GPT_CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=32, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0)
# one layer: the JAX package's ring recompiles on every call (its
# backward ~22 s a layer here)
LLAMA_CFG = dict(vocab_size=512, hidden_size=128, num_layers=1,
                 num_heads=4, num_key_value_heads=2,
                 max_position_embeddings=64)


def _init(**degrees):
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    jfleet.fleet._is_initialized = False
    jfleet.init(is_collective=True, strategy=s)


def _reset():
    jdist.set_mesh(None)
    jfleet.fleet._is_initialized = False


def _weights(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _data():
    rng = np.random.default_rng(50)
    gids = rng.integers(0, 128, (2, 32))
    ids = np.random.default_rng(9).integers(0, 512, (2, 64))
    labels = np.roll(ids, -1, 1)
    ignored = labels.copy()
    ignored[:, :28] = -100       # 4 of the first chunk's 32 counted
    ignored[1, 40:44] = -100
    pt.seed(51)
    gpt = JaxGPT(jax_gpt_tiny(**GPT_CFG))
    pt.seed(9)
    llama = JaxLlama(jax_llama_tiny(**LLAMA_CFG))
    data = {"gpt": {"cfg": GPT_CFG, "ids": gids, "weights": _weights(gpt)},
            "llama": {"cfg": LLAMA_CFG, "ids": ids, "labels": labels,
                      "labels_ignored": ignored,
                      "weights": _weights(llama)}}
    return data, gpt, llama


def _jax_llama(model, ids, labels):
    for p in model.parameters():
        p.clear_gradient()
    _, loss = model(pt.to_tensor(ids), labels=pt.to_tensor(labels))
    loss.backward()
    return float(loss.numpy()), {n: np.asarray(p.grad.numpy())
                                 for n, p in model.named_parameters()}


def _jax_side(data, gpt, llama):
    ref = {}
    try:
        gpt.eval()
        ids = pt.to_tensor(data["gpt"]["ids"])
        ref["gpt_sep1"] = np.asarray(gpt(ids).numpy())
        _init(dp=2, sep=4)
        gpt.config.sequence_parallel = True
        ref["gpt_sep4"] = np.asarray(gpt(ids).numpy())
        _reset()
        ll = data["llama"]
        _init(dp=4, sep=2)
        llama.config.sequence_parallel = True
        # one run: the JAX package's ring recompiles on every call
        ref["llama_ignored"] = _jax_llama(llama, ll["ids"],
                                          ll["labels_ignored"])
    finally:
        _reset()
    return ref


@pytest.fixture(scope="module")
def job():
    from paddle_tpu_torch.distributed import spawn

    data, gpt, llama = _data()
    ctx = spawn(torch_sep_moe_ranks.sequence_parallel_cases, args=(data,),
                nprocs=4, join=False, backend="cpu")
    try:
        ref = _jax_side(data, gpt, llama)
    finally:
        ctx.join(timeout=600)
    res = ctx.results()
    return [res[r] for r in range(4)], ref


def test_gpt_sep4_matches_single_device_and_jax(job):
    ranks, ref = job
    np.testing.assert_allclose(ref["gpt_sep4"], ref["gpt_sep1"], rtol=2e-3,
                               atol=2e-4)
    for r in ranks:
        np.testing.assert_allclose(r["gpt_sep4"], r["gpt_sep1"], rtol=2e-3,
                                   atol=2e-4)
        np.testing.assert_allclose(r["gpt_sep4"], ref["gpt_sep4"],
                                   rtol=2e-3, atol=2e-4)


def test_gpt_position_ids_split_with_the_ids(job):
    ranks, _ = job
    for r in ranks:
        np.testing.assert_allclose(r["gpt_positions_sep4"],
                                   r["gpt_positions_sep1"], rtol=2e-3,
                                   atol=2e-4)
        assert np.abs(r["gpt_positions_sep1"] - r["gpt_sep1"]).max() > 1e-3


def _held(got, want, what):
    loss, grads = got
    np.testing.assert_allclose(loss, want[0], rtol=2e-4, err_msg=what)
    assert set(grads) == set(want[1]), what
    for n, g in want[1].items():
        np.testing.assert_allclose(grads[n], g, rtol=2e-4, atol=1e-6,
                                   err_msg=f"{what}: {n}")


def test_llama_sep2_loss_and_grads_match_jax_and_dense(job):
    """Both ``dp`` groups on the whole batch, its first chunk's labels
    mostly ignored: the loss and every gradient against JAX's ``sep`` 2
    run and the dense model."""
    ranks, ref = job
    for r in ranks:
        _held(r["llama_ignored"], ref["llama_ignored"], "against JAX")
        _held(r["llama_ignored"], r["llama_ignored_dense"],
              "against the dense model")


def test_dp_groups_average_and_sep_sums(job):
    """Each ``dp`` group on its half of the batch: the mean of their
    losses and the gradients (averaged over ``dp``, summed over ``sep``)
    are the whole batch's on the dense model."""
    ranks, _ = job
    loss = np.mean([r["llama"][0] for r in ranks])
    for r in ranks:
        _held((loss, r["llama"][1]), r["llama_dense"],
              "against the dense model")


def test_unequal_ignored_labels_per_chunk(job):
    """The ``sep`` ranks' chunks hold 8 and 60 counted labels: the loss is
    the sum over the sequence over the global count, which the mean of
    the chunks' means is not (it is off by more than the loss check's
    tolerance)."""
    ranks, _ = job
    labels = _data()[0]["llama"]["labels_ignored"]
    counts = [(labels[:, c * 32:(c + 1) * 32] != -100).sum()
              for c in range(2)]
    assert counts == [8, 60]
    for r in ranks:
        loss, _ = r["llama_ignored"]
        assert abs(loss - np.mean(r["chunk_means"])) > 2e-4 * abs(loss)
        _held(r["llama_ignored"], r["llama_ignored_dense"],
              "against the dense model")


def test_gpt_attention_dropout_under_sep_equals_sep1(job):
    """Attention dropout in training: every rank's gathered logits at
    ``sep`` 4 equal one device's with the same seed (the keep bits of
    the global rows); dropout did act."""
    ranks, _ = job
    for r in ranks:
        np.testing.assert_allclose(r["gpt_dropout_sep4"],
                                   r["gpt_dropout_sep1"], rtol=1e-5,
                                   atol=1e-5)
        assert np.abs(r["gpt_dropout_sep1"] - r["gpt_sep1"]).max() > 1e-3
