"""The port's tensor-parallel GPT on two gloo ranks at ``mp`` 2, against
the JAX package's model on a ``{"mp": 2}`` sub-mesh (the four mp layers
alone are held in ``tests/test_torch_collectives.py``, the tiny Llama in
``tests/test_torch_data_parallel.py``).

The JAX model holds whole weights under a GSPMD sharding; the port's
ranks hold Megatron shards. The tiny GPT (4 heads) carries the JAX
model's ``state_dict`` through ``load_reference_state_dict``, which
takes each rank's shard (2 heads a rank), and its gradients are gathered
whole for the comparison (``torch_tp_common``). The ranks are spawned
once for the file (``torch_dist_ranks.tensor_parallel``) and run while
the JAX model works out its references (its eager compiles on the mesh
take most of the file's time). Tolerances: 1e-5 on the loss and the
logits and 2e-5 on the gradients (f32: the all-reduced partial products
sum in another order).
"""
import numpy as np
import pytest

import torch_dist_ranks
from torch_tp_common import GPT, held_against_jax, start_with_jax_models


@pytest.fixture(scope="module")
def job():
    return start_with_jax_models(torch_dist_ranks.tensor_parallel, (),
                                 (GPT,))


@pytest.fixture(scope="module")
def ranks(job):
    return job[0]


@pytest.fixture(scope="module")
def jax_models(job):
    return job[1]


def test_tiny_model_at_mp2(ranks, jax_models):
    """The tiny GPT's loss, its logits gathered over the vocabulary and
    every gradient, gathered whole, against the JAX model on a ``{"mp":
    2}`` mesh; half the heads a rank (the tiny Llama's twin runs in
    ``tests/test_torch_data_parallel.py``, to spread the JAX compiles)."""
    for r in ranks:
        held_against_jax(r["gpt"], jax_models["gpt"])


def test_num_heads_check_is_kept():
    """A model whose heads do not split over ``mp`` is refused with the
    JAX package's message."""
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

    assert not tdist.is_initialized()
    topology.set_mesh(topology.Mesh(np.arange(2).reshape(1, 2), ["dp", "mp"]))
    try:
        with pytest.raises(ValueError, match="num_heads 3 not divisible by "
                                             "mp 2"):
            GPTForCausalLM(gpt_tiny(hidden_size=24, num_heads=3,
                                    num_layers=1), device="cpu")
    finally:
        topology.set_mesh(None)
