"""Every activation layer of ``nn/layer/activation.py`` built in both packages, the port's
from the JAX layer's weights, forward and grads at f32 atol = rtol =
1e-5 (``torch_nn_common.twin`` over ``torch_nn_cases.ACTIVATIONS``)."""
import pytest
import torch

from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_cases import ACTIVATIONS
from torch_nn_common import twin


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_twin(name):
    make, inputs, *rest = ACTIVATIONS[name]
    twin(make, inputs, train=rest[0] if rest else True)
