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


# ───────────── the kernel's launch plan and its merge of partitions ─────────────


@pytest.mark.parametrize("T, nh, nkv, page_size, pps", [
    (8, 16, 16, 16, 128),      # the served Llama's decode step
    (1, 16, 16, 16, 128),      # one long decode row
    (259, 16, 16, 16, 128),    # 3 decode rows + a 256-token chunk
    (1024, 16, 16, 16, 128),   # a prefill bucket: the rows fill the card
    (4, 32, 8, 16, 128),       # GQA 4
    (3, 16, 1, 8, 5),          # GQA 16, few pages
    (16, 12, 4, 64, 3),        # GQA 3, large pages
    (2, 4, 4, 1, 1000),        # pages of one slot
])
def test_launch_plan_partitions_cover_every_page_once(T, nh, nkv, page_size,
                                                      pps):
    """The plan is a function of shapes alone; its partitions cover each
    page index of a block table exactly once, in order; a tile's query
    vectors stay within 16; rows that fill the card alone are not split."""
    plan = tpa.launch_plan(T, nh, nkv, page_size, pps)
    assert plan == tpa.launch_plan(T, nh, nkv, page_size, pps)
    parts = plan.partitions(pps)
    assert len(parts) == plan.n_split >= 1
    covered = [j for j0, j1 in parts for j in range(j0, j1)]
    assert covered == list(range(pps))
    assert all(j1 > j0 for j0, j1 in parts)
    groups = nh // nkv
    assert 1 <= plan.rows_per_tile <= 8
    assert plan.rows_per_tile * groups <= 16
    if T * nkv >= 4 * 132:
        assert plan.n_split == 1
    # no more partitions than four waves of the card's 132 SMs need, and
    # none shorter than 128 keys unless one partition is the whole table
    assert T * nkv * (plan.n_split - 1) < 4 * 132
    assert plan.part_pages * page_size >= 128 or plan.n_split == 1


def test_wrapper_reads_no_device_value_on_host(monkeypatch):
    """The CUDA wrapper plans from shapes only: on meta tensors, which
    have no values a host read could see, it goes through to the launch
    with the plan and a workspace of the plan's size."""
    T, nh, nkv, hd, page, pps = 8, 16, 16, 128, 16, 128
    meta = torch.device("meta")
    q = torch.empty((T, nh, hd), device=meta)
    kp = torch.empty((100, page, nkv, hd), dtype=torch.bfloat16, device=meta)
    vp = torch.empty_like(kp)
    bt = torch.empty((T, pps), dtype=torch.int32, device=meta)
    lens = torch.empty((T,), dtype=torch.int32, device=meta)
    calls = []
    monkeypatch.setattr(tpa, "_launch",
                        lambda device, *args: calls.append((device, args)) or 0)
    monkeypatch.setattr(torch, "empty", _recording_empty(torch.empty, calls))
    launches = tpa.kernel_launches
    out = tpa._paged_attention_cuda(q, kp, vp, bt, lens, hd ** -0.5, None,
                                    None)
    assert out.shape == q.shape and out.device == meta
    assert tpa.kernel_launches == launches + 1
    plan = tpa.launch_plan(T, nh, nkv, page, pps)
    assert plan.n_split > 1
    ws_sizes = [c[1] for c in calls if c[0] == "empty"]
    assert ws_sizes == [(plan.n_split * T * nh * (hd + 2),)]
    (device, args), = [c for c in calls if c[0] != "empty"]
    assert device == meta
    assert args[9:18] == (T, nh, nkv, hd, page, pps, plan.n_split,
                          plan.part_pages, plan.rows_per_tile)


def _recording_empty(empty, calls):
    def rec(*size, **kw):
        calls.append(("empty", size))
        return empty(*size, **kw)
    return rec


def _split_case(name):
    """Inputs for the merge tests: 8-page tables of 8-key pages, lengths
    at and around the edges of 3-page partitions ([0, 3), [3, 6), [6,
    8)) of the plan ``_SPLIT``."""
    rng = np.random.default_rng(10 + SPLIT_CASES.index(name))
    hd, page, pages, width, nh, nkv = 64, 8, 40, 8, 4, 2
    lens = {"edges": [8, 23, 24, 25, 48, 49, 64],
            "empty_partition": [5, 20, 24],
            "len1": [1, 1, 9],
            "int8": [1, 24, 25, 64]}[name]
    lens = np.array(lens, np.int32)
    T = lens.size
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


SPLIT_CASES = ["edges", "empty_partition", "len1", "int8"]
_SPLIT = tpa.LaunchPlan(n_split=3, part_pages=3, rows_per_tile=1)
MERGE_TOL = 1e-6


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_merge_of_partials_matches_reference(name, monkeypatch):
    """The plain versions of the kernel's two halves, partials per
    partition then the merge, give the plain single-pass version and the
    Pallas kernel (interpret mode). A partition that holds no key of a
    row contributes m = -1e30, l = 0, acc = 0."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    args = _split_case(name)
    tq, tk, tv, tbt, tl, tks, tvs = _torch_args(args)
    m, l, acc = tpa.ref_partials(tq, tk, tv, tbt, tl, _SPLIT, k_scale=tks,
                                 v_scale=tvs)
    assert m.shape == l.shape == (3,) + tuple(tq.shape[:2])
    assert acc.shape == (3,) + tuple(tq.shape)
    empty = l == 0
    assert bool((m[empty] == tpa.NEG_INF).all())
    assert bool((acc[empty] == 0).all())
    got = tpa.ref_merge(m, l, acc, tq.dtype)
    whole = tpa.ref_paged_attention(tq, tk, tv, tbt, tl, k_scale=tks,
                                    v_scale=tvs)
    torch.testing.assert_close(got, whole, atol=MERGE_TOL, rtol=MERGE_TOL)
    q, kp, vp, bt, lens, ks, vs = _jax_args(args)
    want = jpa.ragged_paged_attention(q, kp, vp, bt, lens, use_kernel=True,
                                      k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MERGE_TOL, rtol=MERGE_TOL)
