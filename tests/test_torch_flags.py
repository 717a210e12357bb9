"""paddle_tpu_torch.framework.flags against the JAX package's
``framework/flags.py`` (the cases of ``tests/test_flags.py``), and the
switch ``FLAGS_use_pallas_flash_attention`` on the port's attention
route. Errors are compared by type and message with the JAX package's;
values at f32 1e-6."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.autograd import engine
from paddle_tpu_torch.nn.functional import attention
from paddle_tpu_torch.ops import flash_attention as fa
from torch_facade_common import on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    for P in (pt, paddle):
        P.set_flags({"FLAGS_check_nan_inf": False, "FLAGS_benchmark": False,
                     "FLAGS_use_pallas_flash_attention": True})
    paddle.set_flags({"FLAGS_matmul_precision": "highest"})


def test_set_get_flags_roundtrip():
    for P in (pt, paddle):
        P.set_flags({"FLAGS_benchmark": True})
        assert P.get_flags("FLAGS_benchmark")["FLAGS_benchmark"] is True
        got = P.get_flags(["FLAGS_benchmark", "FLAGS_allocator_strategy"])
        assert got["FLAGS_allocator_strategy"] == "auto_growth"
    assert engine.benchmark_sync_enabled
    want = pt.get_flags(list(pt.framework.flags._DEFS))
    assert paddle.get_flags(list(want)) == dict(want, FLAGS_benchmark=True)


def _errors(fn):
    errs = []
    for P in (pt, paddle):
        with pytest.raises(Exception) as e:
            fn(P)
        errs.append(e)
    assert errs[0].type is errs[1].type
    assert str(errs[0].value) == str(errs[1].value)
    return errs[1]


def test_unknown_flag_and_bad_name():
    assert _errors(lambda P: P.get_flags("FLAGS_not_a_real_flag")).type \
        is ValueError
    assert _errors(lambda P: P.set_flags({"not_flags_prefixed": 1})).type \
        is ValueError
    assert _errors(lambda P: P.set_flags([("FLAGS_benchmark", 1)])).type \
        is TypeError
    paddle.set_flags({"FLAGS_some_reference_only_flag": 3})
    assert paddle.get_flags("FLAGS_some_reference_only_flag") == \
        {"FLAGS_some_reference_only_flag": 3}


def test_check_nan_inf_sweep_raises():
    """The same op name and message in both packages; finite ops pass."""
    def div(P):
        P.set_flags({"FLAGS_check_nan_inf": True})
        x = P.to_tensor(np.array([1.0, 0.0], "float32"))
        return x / 0.0
    e = _errors(div)
    assert e.type is FloatingPointError and "divide" in str(e.value)
    y = paddle.to_tensor(np.array([1.0, 0.0], "float32")) + 1.0
    np.testing.assert_allclose(y.numpy(), [2.0, 1.0])


def test_check_nan_inf_log_of_negative():
    def log(P):
        P.set_flags({"FLAGS_check_nan_inf": True})
        return P.log(P.to_tensor(np.array([-1.0], "float32")))
    assert _errors(log).type is FloatingPointError


def test_sweep_disabled_by_default():
    paddle.set_flags({"FLAGS_check_nan_inf": False})
    bad = paddle.to_tensor(np.array([1.0], "float32")) / 0.0
    assert np.isinf(bad.numpy()).all()
    assert not engine.check_nan_inf_enabled


def test_sweep_checks_every_output_of_an_op():
    """Each output of a multi-output op is swept, named by its index."""
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    t = paddle.to_tensor(np.array([1.0, 2.0], "float32"))
    pair = lambda a: (a, a / 0.0)  # noqa: E731
    with pytest.raises(FloatingPointError, match="output 1 of op 'pair'"):
        engine.apply_op(pair, [t], name="pair")
    ints = engine.apply_op(lambda a: (a.long(), a), [t], name="ints")
    assert [o.numpy().tolist() for o in ints] == [[1, 2], [1.0, 2.0]]


def test_environment_passes_flags_through():
    """A flag in the environment at import is set and wired."""
    probe = ("import paddle_tpu_torch as p\n"
             "from paddle_tpu_torch.autograd import engine\n"
             "from paddle_tpu_torch.nn.functional import attention\n"
             "print(p.get_flags(['FLAGS_check_nan_inf', "
             "'FLAGS_use_pallas_flash_attention']), "
             "engine.check_nan_inf_enabled, attention.pallas_flash_enabled)")
    env = dict(os.environ, FLAGS_check_nan_inf="1",
               FLAGS_use_pallas_flash_attention="false",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [
        "{'FLAGS_check_nan_inf':", "True,",
        "'FLAGS_use_pallas_flash_attention':", "False}", "True", "False"]


def test_matmul_precision_maps_to_torch():
    for value, want in (("high", "high"), ("tensorfloat32", "high"),
                        ("bfloat16", "medium"), ("default", "medium"),
                        ("highest", "highest")):
        paddle.set_flags({"FLAGS_matmul_precision": value})
        assert torch.get_float32_matmul_precision() == want
        assert paddle.get_flags("FLAGS_matmul_precision") == \
            {"FLAGS_matmul_precision": value}
    with pytest.raises(ValueError):
        paddle.set_flags({"FLAGS_matmul_precision": "fastest"})
    assert paddle.get_flags("FLAGS_matmul_precision") == \
        {"FLAGS_matmul_precision": "highest"}


@pytest.mark.parametrize("causal,dropout", [(True, 0.0), (False, 0.3)])
def test_flash_flag_routes_attention(causal, dropout):
    """With the flag off, attention takes the dense plain version (no
    flash call, plain or kernel); with it on, flash attention's. Both
    give the same values (dropout too: one keep hash), and equal the JAX
    package's without dropout."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 16, 2, 32)).astype("f4")
               for _ in range(3))
    outs = {}
    for flag in (True, False):
        paddle.set_flags({"FLAGS_use_pallas_flash_attention": flag})
        assert attention.pallas_flash_enabled is flag
        fa.reset_counters()
        paddle.seed(3)
        ts = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
        out, _ = paddle.nn.functional.flash_attention(
            *ts, dropout=dropout, causal=causal)
        out.sum().backward()
        outs[flag] = [out.numpy()] + [t.grad.numpy() for t in ts]
        assert fa.plain_calls["flash_fwd"] == (1 if flag else 0)
        assert sum(fa.kernel_launches.values()) == 0
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    if not dropout:
        want, _ = pt.nn.functional.flash_attention(
            *(pt.to_tensor(a) for a in (q, k, v)), causal=causal)
        np.testing.assert_allclose(outs[False][0], np.asarray(want.numpy()),
                                   rtol=1e-5, atol=1e-5)
