"""``paddle_tpu_torch.DataParallel`` on two gloo ranks against the
single-process full-batch update and the JAX package's ``DataParallel``
on a 2-device sub-mesh (``tests/test_distributed.py:172-205``).

The JAX package's DataParallel shards the global batch and XLA sums the
gradients of its mean loss; the port's ranks each take half the batch,
average their mean loss's gradients in the reducer, and so make the
full batch's update. The ranks are spawned once for the file
(``torch_dist_ranks.data_parallel``, one intra-op thread a rank); the
same Sequential (its JAX weights carried in), Momentum(0.1, 0.9) and
three steps everywhere. Tolerances: 1e-5 (f32 over two halves against
one batch), and bit for bit for a one-rank group against the plain step.
The same ranks then run the tiny Llama at mp 2 (its twin here spreads
the JAX package's eager compiles over two files).
"""
import jax
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF

import torch_dist_ranks
from torch_tp_common import LLAMA, held_against_jax, start_with_jax_models
from torch_suite import one_torch_thread  # noqa: F401

TOL = 1e-5


def _data():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((16, 8)).astype("float32"),
            rng.integers(0, 4, (16,)))


def _jax_model():
    pt.seed(42)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))


def _jax_train(m, x, y):
    o = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                              parameters=m.parameters())
    for _ in range(3):
        loss = jF.cross_entropy(m(pt.to_tensor(x)), pt.to_tensor(y))
        loss.backward()
        o.step()
        o.clear_grad()
    return [np.asarray(p.numpy()) for p in m.parameters()]


@pytest.fixture(scope="module")
def weights():
    return {k: np.asarray(v.numpy()) for k, v in
            _jax_model().state_dict().items()}


@pytest.fixture(scope="module")
def job(weights):
    """The ranks' job (DataParallel, then the tiny Llama at mp 2), with
    the JAX Llama's references worked out while it runs."""
    x, y = _data()
    return start_with_jax_models(torch_dist_ranks.data_parallel,
                                 (weights, x, y), (LLAMA,))


@pytest.fixture(scope="module")
def ranks(job):
    return job[0]


def test_two_ranks_equal_the_full_batch_and_jax_dp(ranks, weights):
    import paddle_tpu_torch as paddle

    x, y = _data()
    paddle.set_device("cpu")
    try:
        m = torch_dist_ranks._mlp(weights)
        torch_dist_ranks._train(m, paddle.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=m.parameters()), x, y)
        single = torch_dist_ranks._params(m)
    finally:
        paddle.set_device(None)
    jdist.set_mesh(jdist.create_mesh({"dp": 2}, devices=jax.devices()[:2]))
    try:
        jm = _jax_model()
        jm = jdist.DataParallel(jm)
        jax_dp = _jax_train(jm, x, y)
    finally:
        jdist.set_mesh(None)
    for a, b in zip(ranks[0]["dp"], ranks[1]["dp"]):
        np.testing.assert_array_equal(a, b)
    for got, s, j in zip(ranks[0]["dp"], single, jax_dp):
        np.testing.assert_allclose(got, s, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, j, rtol=TOL, atol=TOL)
    comm = ranks[0]["comm"]
    assert comm["reductions"] == 3
    assert comm["all_reduces"] == 3 * comm["buckets"]
    assert comm["bytes_reduced"] == 3 * sum(comm["bucket_bytes"])


def test_one_rank_group_equals_the_plain_step_bit_for_bit(ranks):
    for r in ranks:
        assert r["one_rank_equal"]
        assert r["one_rank_all_reduces"] > 0


def test_no_sync_skips_the_reduction(ranks):
    """Inside ``no_sync`` each rank keeps its own gradients (they differ
    and nothing is reduced); the next backward outside it averages both
    backwards' gradients over the ranks."""
    a, b = ranks
    assert a["no_sync_all_reduces"] == b["no_sync_all_reduces"] == 0
    assert any(not np.allclose(p, q) for p, q in
               zip(a["no_sync_grads"], b["no_sync_grads"]))
    for p, q in zip(a["synced_grads"], b["synced_grads"]):
        np.testing.assert_array_equal(p, q)
    # each rank's second backward adds the same local grads as its first
    # (its rows reversed: the mean loss is the same)
    for g, la, lb in zip(a["synced_grads"], a["no_sync_grads"],
                         b["no_sync_grads"]):
        np.testing.assert_allclose(g, (2 * la + 2 * lb) / 2, rtol=TOL,
                                   atol=TOL)


def test_find_unused_parameters(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["unused_grad"], 0.0)
        assert r["used_grad_finite"]
        assert "find_unused_parameters=True" in r["strict_error"]


def test_tiny_llama_at_mp2(job):
    """The tiny Llama (4 heads over 2 KV heads) at mp 2, 2 heads and 1 KV
    head a rank, after the DataParallel cases on the same two ranks: its
    loss, logits and gathered gradients against the JAX Llama on a
    ``{"mp": 2}`` mesh (``torch_tp_common.held_against_jax``)."""
    ranks, ref = job
    for r in ranks:
        held_against_jax(r["tp"]["llama"], ref["llama"])
