"""GPT at ``pp`` 2 on two gloo ranks (``models/gpt.py``'s pipelined
trunk, ``GPTStackedBlocks``) against the JAX package's GPT on a ``pp`` 2
mesh (``tests/test_pipeline.py:122``, its ``pp`` axis alone): 4 layers,
2 a stage, hidden 64, dropout 0. The JAX model's stacked ``[L, ...]``
parameters are carried to the stages (``models/convert.py``: this
stage's rows, each Linear transposed) and gathered back bit for bit;
the loss, the logits and every gradient (the stages' rows gathered
whole) are held at rtol 1e-4. The ranks are spawned once
(``torch_zero_ranks.pipeline_gpt``) and run while the JAX model's
forward and backward are worked out.
"""
import jax
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.models import GPTForCausalLM, gpt_tiny

import torch_zero_ranks
from torch_suite import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def job():
    from paddle_tpu_torch.distributed import spawn

    jdist.set_mesh(jdist.create_mesh({"pp": 2}, devices=jax.devices()[:2]))
    try:
        pt.seed(9)
        cfg = gpt_tiny(vocab_size=256, hidden_size=64, num_layers=4,
                       num_heads=4)
        cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
        jm = GPTForCausalLM(cfg)
        weights = {k: np.asarray(v.numpy())
                   for k, v in jm.state_dict().items()}
        ids = np.random.default_rng(10).integers(0, 256, (8, 16))
        ctx = spawn(torch_zero_ranks.pipeline_gpt, args=(weights, ids),
                    nprocs=2, join=False, backend="cpu")
        logits, loss = jm(pt.to_tensor(ids),
                          labels=pt.to_tensor(np.roll(ids, -1, 1)))
        loss.backward()
        ref = {"loss": float(loss.numpy()),
               "logits": np.asarray(logits.numpy()),
               "grads": {n: np.asarray(p.grad.numpy())
                         for n, p in jm.named_parameters()}}
    finally:
        jdist.set_mesh(None)
    ctx.join()
    res = ctx.results()
    return [res[0], res[1]], ref, weights


def test_weights_cross_to_the_stages_and_back(job):
    ranks, _, weights = job
    assert [r["rows"] for r in ranks] == [[0, 1], [2, 3]]
    for r in ranks:
        assert set(r["back"]) == set(weights)
        for k, v in weights.items():
            np.testing.assert_array_equal(r["back"][k], v, err_msg=k)


def test_gpt_pp2_against_jax(job):
    ranks, ref, _ = job
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(r["logits"], ref["logits"], rtol=1e-4,
                                   atol=1e-5)
        assert set(r["grads"]) == set(ref["grads"])
        for n, g in ref["grads"].items():
            np.testing.assert_allclose(r["grads"][n], g, rtol=1e-4,
                                       atol=1e-6, err_msg=n)
