"""The JAX side of the port's tensor-parallel model twins: the tiny
models' configurations, starting a two-rank job with their JAX weights
while the JAX models on a ``{"mp": 2}`` mesh work out their references,
and holding a rank's results against them. Used by
``tests/test_torch_tensor_parallel.py`` (GPT) and
``tests/test_torch_data_parallel.py`` (Llama)."""
import jax
import numpy as np

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.distributed import spawn

TOL = 1e-5
GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=16)


def _model_inputs(name, cls, tiny, cfg):
    pt.seed(0)
    jm = cls(tiny(**cfg))
    ids = np.random.default_rng(1).integers(0, 64, (2, 16))
    return jm, {"config": cfg, "vocab": cfg["vocab_size"], "ids": ids,
                "labels": np.roll(ids, -1, axis=1),
                "weights": {k: np.asarray(v.numpy())
                            for k, v in jm.state_dict().items()}}


LLAMA_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                 num_key_value_heads=2, intermediate_size=64,
                 max_position_embeddings=16)
GPT = ("gpt", JaxGPT, jax_gpt_tiny, GPT_CFG)
LLAMA = ("llama", JaxLlama, jax_llama_tiny, LLAMA_CFG)


def start_with_jax_models(target, args, models):
    """Start ``target``'s two ranks with ``models``' JAX weights among
    their arguments, then work out the JAX models' loss, logits and grads
    on a ``{"mp": 2}`` mesh while they run: ``(ranks, references)``."""
    jdist.set_mesh(jdist.create_mesh({"mp": 2}, devices=jax.devices()[:2]))
    try:
        built = {name: _model_inputs(name, cls, tiny, cfg)
                 for name, cls, tiny, cfg in models}
        ctx = spawn(target, args=args + ({k: v[1]
                                          for k, v in built.items()},),
                    nprocs=2, join=False, backend="cpu")
        ref = {}
        for name, (jm, spec) in built.items():
            logits, loss = jm(pt.to_tensor(spec["ids"]),
                              labels=pt.to_tensor(spec["labels"]))
            loss.backward()
            ref[name] = {"loss": float(loss.numpy()),
                         "logits": np.asarray(logits.numpy()),
                         "grads": {n: np.asarray(p.grad.numpy())
                                   for n, p in jm.named_parameters()}}
    finally:
        jdist.set_mesh(None)
    ctx.join()
    res = ctx.results()
    return [res[0], res[1]], ref


def held_against_jax(got, j):
    """A rank's tiny model at mp 2 (:func:`start_with_jax_models`)
    against the JAX one: loss, logits and every gradient."""
    assert got["heads"] == 2
    np.testing.assert_allclose(got["loss"], j["loss"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["logits"], j["logits"], rtol=TOL,
                               atol=TOL)
    assert set(got["grads"]) == set(j["grads"])
    for n, g in j["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=2e-5, atol=2e-5,
                                   err_msg=n)
