"""Twin runner of the facade's Tensor and tape tests: a case is a
function of a Paddle namespace ``P`` (``paddle_tpu`` or
``paddle_tpu_torch``) that asserts what holds in both and returns what
it computed; :func:`both` runs it in each package and holds the results
equal (arrays by value at ``tol`` and by dtype name, everything else by
``==``)."""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch import dtypes as tdt


@pytest.fixture(autouse=True)
def on_cpu():
    """``paddle.set_device("cpu")`` for the test, then the device it was
    (another test in the worker expects the card)."""
    prev = paddle.get_device() if paddle.device._current is not None \
        else None
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def name_of(dtype) -> str:
    """A dtype's numpy name, from either package."""
    if isinstance(dtype, paddle.dtypes.float32.__class__):
        return tdt.dtype_name(dtype)
    return np.dtype(dtype).name


def _plain(x):
    if isinstance(x, (pt.Tensor, paddle.Tensor)):
        return ("tensor", name_of(x.dtype), np.asarray(x.numpy()))
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.name, x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _equal(a, b, tol, where):
    if isinstance(a, tuple) and len(a) == 3 and a[0] in ("tensor", "array"):
        assert b[0] == a[0] and b[1] == a[1], \
            f"{where}: dtype {b[1]} != JAX {a[1]}"
        np.testing.assert_allclose(np.asarray(b[2], dtype=a[2].dtype), a[2],
                                   atol=tol, rtol=tol, err_msg=where)
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, tol, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], tol, f"{where}.{k}")
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=tol, abs=tol), where
    else:
        assert a == b, f"{where}: {b!r} != JAX {a!r}"


def both(case, tol=1e-6):
    """Run ``case`` on the JAX package and on the port; equal results."""
    want = _plain(case(pt))
    got = _plain(case(paddle))
    _equal(want, got, tol, case.__name__)
    return got
