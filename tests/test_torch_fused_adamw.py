"""paddle_tpu_torch.ops.fused_adamw (K5) against the JAX package's
``fused_adamw_flat`` and ``xla_adamw_flat``.

On the CPU the port's wrapper takes its plain version; the JAX kernel
runs in interpret mode (``PADDLE_TPU_PALLAS_INTERPRET=1``, as
tests/test_flash_attention.py runs it). The same numpy inputs go through
all three. Tolerance rtol 1e-6, atol 1e-7 on w', m' and v' (the JAX
package's own tolerance between its kernel and its XLA form): the same
f32 operations in the same order, the bias corrections' f32 powers
taken by two libraries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.fused_adamw import fused_adamw_flat as jax_fused
from paddle_tpu.ops.pallas.fused_adamw import xla_adamw_flat
from paddle_tpu_torch.ops import fused_adamw as fa

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _inputs(n, seed, zero_grads=False, warm_moments=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(n).astype(np.float32)
    m = np.zeros(n, np.float32)
    v = np.zeros(n, np.float32)
    if warm_moments:
        m = (1e-4 * rng.standard_normal(n)).astype(np.float32)
        v = (1e-8 * rng.random(n)).astype(np.float32)
    g = (np.zeros(n) if zero_grads
         else 1e-3 * rng.standard_normal(n)).astype(np.float32)
    return w, m, v, g


@pytest.mark.parametrize("n", [10_000, 8192])
@pytest.mark.parametrize("step", [1, 5])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_plain_version_matches_jax(n, step, wd):
    """N = 10,000 is not a multiple of the TPU kernel's 8 x 1024 pad;
    8192 is. At step 5 the moments start warm."""
    w, m, v, g = _inputs(n, seed=n + step, warm_moments=step > 1)
    lr = 1e-3
    kw = dict(weight_decay=wd)
    jargs = [jnp.asarray(a) for a in (w, m, v, g)]
    want_kernel = jax_fused(*jargs, jnp.float32(lr), jnp.float32(step), **kw)
    want_xla = xla_adamw_flat(*jargs, jnp.float32(lr), jnp.float32(step),
                              **kw)
    got = fa.fused_adamw_flat(*(torch.from_numpy(a) for a in (w, m, v, g)),
                              lr, step, **kw)
    for name, t, a, b in zip(("w", "m", "v"), got, want_kernel, want_xla):
        assert t.dtype == torch.float32 and tuple(t.shape) == (n,)
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} vs kernel")
        np.testing.assert_allclose(t.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} vs xla")
    # the step moved every weight (decay alone, where wd > 0 and g = 0)
    assert not np.array_equal(got[0].numpy(), w)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_zero_grads(wd):
    """g = 0 from zero moments: m' = v' = 0, the Adam term is 0 / eps = 0,
    and w' is the decay alone, as in the JAX package."""
    w, m, v, g = _inputs(10_000, seed=3, zero_grads=True)
    jargs = [jnp.asarray(a) for a in (w, m, v, g)]
    want = jax_fused(*jargs, jnp.float32(1e-3), jnp.float32(2.0),
                     weight_decay=wd)
    got = fa.fused_adamw_flat(*(torch.from_numpy(a) for a in (w, m, v, g)),
                              1e-3, 2, weight_decay=wd)
    for t, a in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)
    assert not got[1].any() and not got[2].any()
    if wd == 0.0:
        np.testing.assert_array_equal(got[0].numpy(), w)


def test_tensor_scalars_and_bias_corrections():
    """``lr`` and ``step`` given as 0-dim tensors give the numbers' result;
    the bias corrections are f32 powers."""
    w, m, v, g = (torch.from_numpy(a) for a in _inputs(257, seed=5))
    a = fa.fused_adamw_flat(w, m, v, g, 1e-4, 10)
    b = fa.fused_adamw_flat(w, m, v, g, torch.tensor(1e-4), torch.tensor(10))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    bc1, bc2 = fa.bias_corrections(10, 0.9, 0.999, "cpu")
    assert bc1.dtype == bc2.dtype == torch.float32 and bc1.dim() == 0
    f32 = np.float32
    for got, beta in ((bc1, 0.9), (bc2, 0.999)):
        np.testing.assert_allclose(float(got), f32(1) - f32(beta) ** f32(10),
                                   rtol=1e-6)


def test_cpu_counts_plain_calls_and_no_launches():
    fa.reset_counters()
    w, m, v, g = (torch.from_numpy(a) for a in _inputs(100, seed=1))
    for _ in range(3):
        w, m, v = fa.fused_adamw_flat(w, m, v, g, 1e-3, 1)
    assert fa.plain_calls == 3 and fa.kernel_launches == 0
    fa.reset_counters()
    assert fa.plain_calls == 0


def test_other_devices_have_no_path():
    w = torch.zeros(4, device="meta")
    with pytest.raises(RuntimeError, match="no path"):
        fa.fused_adamw_flat(w, w, w, w, 1e-3, 1)


def test_bench_tool_check_runs_on_cpu():
    """``tools.bench_adamw``'s check, K5's plain version against PyTorch's
    fused AdamW set to the same step, holds on the CPU too; the tool's
    timed size is the JAX tool's; the tool itself refuses the CPU."""
    from paddle_tpu_torch.tools import bench_adamw

    errs = bench_adamw.check("cpu", n=20_000)
    assert errs["update_rel_err"] <= bench_adamw.UPDATE_REL_TOL
    assert errs["w_max_abs_err"] <= 1e-6
    assert bench_adamw.N_TIMED == 354_942_976
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_adamw.bench_adamw(device="cpu")
