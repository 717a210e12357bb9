"""Twin tests of ``paddle_tpu/ops/math.py``: every registry case of its ops
through the JAX package and ``paddle_tpu_torch`` (``torch_ops_common``)."""
import pytest

from torch_ops_common import (check_custom, check_grad,
                              check_output, custom_ids, grad_ids,
                              on_cpu, registry_ids)  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

MODULE = "math"


@pytest.mark.parametrize("name", registry_ids(MODULE))
def test_op_output_twin(name):
    check_output(name)


@pytest.mark.parametrize("name", grad_ids(MODULE))
def test_op_grad_twin(name):
    check_grad(name)


@pytest.mark.parametrize("name", custom_ids(MODULE))
def test_op_custom_twin(name):
    check_custom(name)
