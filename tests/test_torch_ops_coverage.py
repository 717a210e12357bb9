"""The port's op library covers the JAX package's, and its numpy-only case
copy is the registry's.

- The coverage gate (twin of ``tests/test_op_suite.py``'s): each op
  module of the port exports exactly its JAX module's ``__all__``, and
  ``paddle_tpu_torch.ops`` their union plus ``getitem``/``setitem``;
  every op is in the twin suite (registry, CUSTOM or EXCLUDED).
- ``paddle_tpu_torch.tools.op_cases`` (what ``chip_smoke.py`` runs on the
  card) has the registry's names, dtypes, grad flags, tolerances and,
  dtype for dtype, input arrays; and each case's call, run on the JAX
  package, gives what the registry's own ``spec.fn`` gives.
- The Paddle namespace exports the names of the JAX package's that the
  port has.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from op_registry import CUSTOM, EXCLUDED, REGISTRY
from paddle_tpu_torch.tools.op_cases import CASES
from torch_ops_common import held, on_cpu  # noqa: F401

MODULES = ("creation", "extras", "linalg", "logic", "manipulation", "math",
           "random", "stat")


@pytest.mark.parametrize("module", MODULES)
def test_module_exports_equal_the_jax_modules(module):
    jax_mod = importlib.import_module(f"paddle_tpu.ops.{module}")
    port_mod = importlib.import_module(f"paddle_tpu_torch.ops.{module}")
    assert list(port_mod.__all__) == list(jax_mod.__all__)
    missing = [n for n in port_mod.__all__ if not callable(
        getattr(port_mod, n, None))]
    assert not missing, missing


def test_every_op_is_ported_and_covered():
    union = set()
    for m in MODULES:
        union |= set(importlib.import_module(f"paddle_tpu.ops.{m}").__all__)
    assert set(paddle.ops.__all__) == union | {"getitem", "setitem"}
    assert set(pt.ops.__all__) == set(paddle.ops.__all__)
    covered = set(REGISTRY) | set(CUSTOM) | set(EXCLUDED)
    assert not sorted(union - covered)
    for name in union:
        assert callable(getattr(paddle, name)), name


def test_case_copy_equals_the_registry():
    assert set(CASES) == set(REGISTRY)
    for name, spec in REGISTRY.items():
        case = CASES[name]
        assert tuple(case.dtypes) == tuple(spec.dtypes), name
        assert case.grad == spec.grad, name
        assert case.atol == spec.atol, name
        for dt in spec.dtypes:
            want, got = spec.make(dt), case.make(dt)
            assert len(want) == len(got), name
            for a, b in zip(want, got):
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("module", MODULES)
def test_case_calls_are_the_registry_calls(module):
    """Each case's ``call(P, ...)`` on the JAX package is its spec's
    ``fn``: the same values and dtypes, bit for bit."""
    names = set(importlib.import_module(f"paddle_tpu.ops.{module}").__all__)
    for name, spec in REGISTRY.items():
        if name not in names:
            continue
        dt = spec.dtypes[0]
        inputs = spec.make(dt)
        want = spec.fn(*[pt.to_tensor(x) for x in inputs])
        got = CASES[name].call(pt, *[pt.to_tensor(x) for x in inputs])
        if name in ("rand", "randn"):
            continue
        jflat = want if isinstance(want, (list, tuple)) else [want]
        gflat = got if isinstance(got, (list, tuple)) else [got]
        assert len(jflat) == len(gflat), name
        for a, b in zip(jflat, gflat):
            np.testing.assert_array_equal(np.asarray(b.numpy()),
                                          np.asarray(a.numpy()), err_msg=name)


def test_namespace_exports():
    """The Paddle names of ``paddle_tpu/__init__.py`` that the port has."""
    for name in ("Tensor", "Parameter", "to_tensor", "seed", "get_rng_state",
                 "set_rng_state", "no_grad", "enable_grad", "grad",
                 "set_grad_enabled", "is_grad_enabled", "set_device",
                 "get_device", "autograd", "nn", "optimizer", "amp",
                 "models", "float32", "bfloat16", "int64", "bool", "dtype",
                 "iinfo", "finfo", "is_tensor", "create_parameter",
                 "get_default_dtype", "set_default_dtype",
                 "in_dynamic_mode"):
        assert hasattr(paddle, name), name
    assert paddle.float32 is paddle.dtypes.float32
    assert paddle.autograd.PyLayer and paddle.autograd.saved_tensors_hooks


def test_held_rejects_a_dtype_or_value_difference():
    """The twin check's reach: a different dtype or a value off by more
    than the tolerance fails it."""
    j = pt.to_tensor(np.array([1.0, 2.0], "float32"))
    with pytest.raises(AssertionError, match="dtype"):
        held(j, paddle.to_tensor([1.0, 2.0], dtype="float64"), 1e-4, 1e-4)
    with pytest.raises(AssertionError):
        held(j, paddle.to_tensor(np.array([1.0, 2.001], "float32")), 1e-4,
             1e-4)
    held(j, paddle.to_tensor(np.array([1.0, 2.00001], "float32")), 1e-4,
         1e-4)
