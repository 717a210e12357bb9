"""``test_layer_twin``'s cases from ``torch_nn_cases.TWIN_SPLIT`` on, in
name order: the second half of ``tests/test_torch_nn_layers.py``'s layer
twins, in a file of its own so that the suite's workers (``--dist
loadfile``) run the halves side by side. Each layer is built in both
packages, the port's from the JAX layer's weights, and its forward and
grads (of the inputs and of every parameter) held at f32 atol = rtol =
1e-5 (``torch_nn_common.twin``)."""
import pytest

from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_cases import LAYERS, TWIN_SPLIT
from torch_nn_common import one_thread, twin  # noqa: F401


@pytest.mark.parametrize("name", [n for n in sorted(LAYERS)
                                  if n >= TWIN_SPLIT])
def test_layer_twin(name):
    make, inputs, *rest = LAYERS[name]
    twin(make, inputs, train=rest[0] if rest else True)
