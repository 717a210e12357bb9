"""Twin tests of ``paddle_tpu/ops/random.py``: every registry case of its ops
through the JAX package and ``paddle_tpu_torch`` (``torch_ops_common``)."""
import pytest

from torch_ops_common import (check_custom, custom_ids, on_cpu)  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

MODULE = "random"


@pytest.mark.parametrize("name", custom_ids(MODULE))
def test_op_custom_twin(name):
    check_custom(name)
