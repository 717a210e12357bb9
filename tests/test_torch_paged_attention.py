"""paddle_tpu_torch.ops.paged_attention against the JAX package.

The port's plain version (what a CPU tensor runs, and what the CUDA
kernel is held against on the card by chip_smoke.py) must compute what
the JAX package computes: its jnp ``ref_paged_attention`` and its Pallas
kernel ``_paged_attn_kernel``, the latter in interpret mode on the CPU
as tests/test_serving.py runs it. Inputs are drawn once with numpy and
handed to both packages.

Tolerance: atol = rtol = 2e-5 in f32, the bound tests/test_serving.py
holds the Pallas kernel to against the jnp version. Both sides compute
the same masked softmax in f32, but sum in different orders (XLA's
einsum and the kernel's online softmax across pages against torch's
einsum), so they agree to a few f32 ulps of the O(1) outputs, not
bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa

ATOL = RTOL = 2e-5


def _case(name):
    """(q, k_pool, v_pool, block_tables, lens, k_scale, v_scale) numpy
    inputs for one named case. Every case uses ragged block tables into
    a shared pool; rows never reach page 0."""
    rng = np.random.default_rng(CASES.index(name))
    hd, page, pages, width = 64, 8, 20, 4
    nh, nkv = 4, 4
    if name == "decode":            # one row per sequence, MHA
        lens = np.array([3, 17, 32], np.int32)
    elif name == "ragged":          # q_lens [1, 5, 1]: decode, chunk, decode
        q_lens, starts = [1, 5, 1], [12, 7, 0]
        lens = np.concatenate([np.arange(s, s + n) + 1
                               for s, n in zip(starts, q_lens)]).astype(np.int32)
    elif name == "gqa":             # 4 query heads over 2 kv heads
        nkv = 2
        lens = np.array([9, 30, 16, 1], np.int32)
    elif name == "len1":            # rows that see one key only
        lens = np.array([1, 1], np.int32)
    elif name == "int8":            # int8 pages with per-slot f32 scales
        nkv = 2
        lens = np.array([5, 32, 20], np.int32)
    else:
        raise KeyError(name)
    T = lens.size
    if name == "ragged":
        slot_bt = rng.integers(1, pages, (3, width)).astype(np.int32)
        bt = np.concatenate([np.repeat(slot_bt[i:i + 1], n, axis=0)
                             for i, n in enumerate(q_lens)])
    else:
        bt = rng.integers(1, pages, (T, width)).astype(np.int32)
    q = rng.standard_normal((T, nh, hd)).astype(np.float32)
    shape = (pages, page, nkv, hd)
    if name == "int8":
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    return q, kp, vp, bt, lens, ks, vs


CASES = ["decode", "ragged", "gqa", "len1", "int8"]


def _jax_args(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch_args(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_reference(name):
    q, kp, vp, bt, lens, ks, vs = _jax_args(_case(name))
    want = jpa.ref_paged_attention(q, kp, vp, bt, lens, k_scale=ks,
                                   v_scale=vs)
    tq, tk, tv, tbt, tl, tks, tvs = _torch_args(_case(name))
    got = tpa.ref_paged_attention(tq, tk, tv, tbt, tl, k_scale=tks,
                                  v_scale=tvs)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", CASES)
def test_wrapper_matches_pallas_kernel_interpret(name, monkeypatch):
    """The public ragged wrapper on CPU tensors against the Pallas kernel
    itself (interpret mode); counts one plain call and no launch."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    q, kp, vp, bt, lens, ks, vs = _jax_args(_case(name))
    want = jpa.ragged_paged_attention(q, kp, vp, bt, lens, use_kernel=True,
                                      k_scale=ks, v_scale=vs)
    tq, tk, tv, tbt, tl, tks, tvs = _torch_args(_case(name))
    launches, plain = tpa.kernel_launches, tpa.plain_calls
    got = tpa.ragged_paged_attention(tq, tk, tv, tbt, tl, k_scale=tks,
                                     v_scale=tvs)
    assert tpa.plain_calls == plain + 1
    assert tpa.kernel_launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_plain_row_blocking_is_exact(monkeypatch):
    """The plain version bounds its gather by processing rows in blocks;
    one row per block must agree with one block of all rows. Not bitwise:
    torch's einsum orders its f32 sums differently for another batch
    size, so the bound is a few f32 ulps of the O(1) outputs."""
    args = _torch_args(_case("gqa"))
    whole = tpa.ref_paged_attention(*args[:5])
    monkeypatch.setattr(tpa, "_REF_BLOCK_BYTES", 1)
    blocked = tpa.ref_paged_attention(*args[:5])
    torch.testing.assert_close(blocked, whole, atol=1e-6, rtol=1e-5)


def test_scales_must_come_in_pairs():
    q, kp, vp, bt, lens, ks, _ = _torch_args(_case("int8"))
    with pytest.raises(ValueError):
        tpa.paged_attention(q, kp, vp, bt, lens, k_scale=ks)


def test_no_path_for_other_devices():
    """Dispatch is by the tensor's device: CPU takes the plain version,
    CUDA the kernel; anything else raises instead of falling back."""
    q, kp, vp, bt, lens, _, _ = _torch_args(_case("decode"))
    meta = [t.to("meta") for t in (q, kp, vp, bt, lens)]
    with pytest.raises(RuntimeError):
        tpa.paged_attention(*meta)
