"""``paddle_tpu_torch.linalg`` against the JAX package's ``paddle.linalg``
(``paddle_tpu/linalg.py``): ``cond`` under every ``p`` it takes (batched
too, and as ``Tensor.cond``), ``multi_dot`` with matrices and end
vectors, ``lu_unpack`` of ``lu``'s factors (square, batched, wide, the
pivots alone) and ``inv``. Each case of ``LINALG`` in
``paddle_tpu_torch/tools/extended_cases.py`` (which ``chip_smoke.py``
also runs on the card) runs in both packages on the same seeded inputs:
outputs and input grads at f32 atol = rtol = 1e-5."""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.tools.extended_cases import LINALG
from torch_extended_common import check_case
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import one_thread  # noqa: F401


@pytest.mark.parametrize("name", sorted(LINALG))
def test_case(name):
    check_case(name)


def test_namespace_has_the_jax_package_names():
    assert set(paddle.linalg.__all__) == set(pt.linalg.__all__)
    for n in pt.linalg.__all__:
        assert callable(getattr(paddle.linalg, n)), n
    assert paddle.linalg.inv is paddle.linalg.inverse
    assert "linalg" in paddle.__all__


def test_cond_refuses_other_p_in_both():
    x = np.eye(3, dtype="f4")
    for P in (pt, paddle):
        with pytest.raises(ValueError, match="unsupported p for cond"):
            P.linalg.cond(P.to_tensor(x), 3)


def test_lu_unpack_rebuilds_the_matrix_and_drops_on_request():
    x = np.random.default_rng(0).standard_normal((3, 4, 4)).astype("f4")
    t = paddle.to_tensor(x)
    P, L, U = paddle.linalg.lu_unpack(*paddle.linalg.lu(t))
    np.testing.assert_allclose((P @ L @ U).numpy(), x, atol=1e-5)
    lu, piv = paddle.linalg.lu(t)
    P2, L2, U2 = lu.lu_unpack(piv, unpack_pivots=False)
    assert P2 is None and np.array_equal(L2.numpy(), L.numpy())
    m = paddle.to_tensor(x[0])
    np.testing.assert_allclose(m.multi_dot([m, m]).numpy(),
                               x[0] @ x[0] @ x[0], rtol=1e-5, atol=1e-4)
