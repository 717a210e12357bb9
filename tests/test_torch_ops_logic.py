"""Twin tests of ``paddle_tpu/ops/logic.py``: every registry case of its ops
through the JAX package and ``paddle_tpu_torch`` (``torch_ops_common``)."""
import pytest

from torch_ops_common import (check_output, on_cpu, registry_ids)  # noqa: F401

MODULE = "logic"


@pytest.mark.parametrize("name", registry_ids(MODULE))
def test_op_output_twin(name):
    check_output(name)
