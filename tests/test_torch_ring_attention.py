"""Ring attention (``paddle_tpu_torch.distributed.ring_attention``) on
gloo ranks against the JAX package's ``ring_attention`` on its 8-device
host mesh, the twins of ``tests/test_ring_attention.py``'s non-fused
tests at their tolerances (rtol 1e-4 / atol 1e-5 for outputs, 1e-3 /
1e-4 for gradients), each at ``sep`` 4 (four ranks) and ``sep`` 2 (the
same four ranks as ``dp`` 2 x ``sep`` 2, against JAX's ``sep`` 2 x ``dp``
4): dense causal and not, the indivisible sequence's ``ValueError``,
the custom scale's fallback; the gradients at both degrees against the
JAX ring's at ``sep`` 4 (the JAX test's); and the fallback without a
mesh. The four ranks are spawned once for the file
(``torch_sep_moe_ranks.ring_attention_cases``); the JAX side runs while
they do.

The block loop itself (``ring_block_forward``/``ring_block_backward``)
runs here in one process at P 4 with ``ListHop``
(``tools/sep_moe_drills.py`` ``block_loop``, as the card's check drives
it with the kernels), against the plain flash versions over the whole
sequence; a merge whose block weights ``e^(lse_i - m)`` are replaced by
1 must fail that check.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import ring_attention as jax_ring

import torch_sep_moe_ranks
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.tools import sep_moe_drills as drills
from torch_suite import one_torch_thread  # noqa: F401

# the module (the package exports its function under the same name)
ra = importlib.import_module("paddle_tpu_torch.distributed.ring_attention")

SEPS = (4, 2)


def _qkv(B=2, S=32, H=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: rng.standard_normal((B, S, H, D)).astype("float32")
    return mk(), mk(), mk()


def _dense_ref(q, k, v, causal):
    qh, kh, vh = [np.swapaxes(x, 1, 2) for x in (q, k, v)]
    s = np.einsum("bhqd,bhkd->bhqk", qh, kh) / np.sqrt(q.shape[-1])
    if causal:
        S = q.shape[1]
        s = np.where(np.tril(np.ones((S, S), bool)), s, -1e9)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.swapaxes(np.einsum("bhqk,bhkd->bhqd", p, vh), 1, 2)


# the indivisible lengths: the JAX test's 30 at sep 4, and 31 at sep 2
DATA = {"dense": _qkv(), "grads": _qkv(seed=1),
        "fallback": _qkv(S=16, seed=2), "scale": _qkv(S=16, seed=7),
        "indivisible_sep4": _qkv(S=30, seed=3),
        "indivisible_sep2": _qkv(S=31, seed=3)}


def _init_sep(sep):
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 8 // sep, "sep_degree": sep}
    jfleet.fleet._is_initialized = False
    jfleet.init(strategy=s)


def _jax_ring(q, k, v, causal, scale=None, grads=False):
    ts = [pt.to_tensor(x) for x in (q, k, v)]
    for t in ts:
        t.stop_gradient = not grads
    out = jax_ring(*ts, causal=causal, scale=scale)
    if not grads:
        return np.asarray(out.numpy())
    (out * out).sum().backward()
    return [np.asarray(t.grad.numpy()) for t in ts]


def _jax_side():
    ref = {}
    try:
        for sep in SEPS:
            _init_sep(sep)
            for causal in (False, True):
                ref[f"dense_{causal}_sep{sep}"] = _jax_ring(*DATA["dense"],
                                                            causal)
            if sep == 4:  # the JAX test's degree (a JAX ring backward
                # recompiles on every call, ~20 s)
                ref["grads"] = _jax_ring(*DATA["grads"], True, grads=True)
            ref[f"scale_sep{sep}"] = _jax_ring(*DATA["scale"], False,
                                               scale=0.5)
            try:
                _jax_ring(*DATA[f"indivisible_sep{sep}"], False)
                ref[f"indivisible_sep{sep}"] = None
            except ValueError as e:
                ref[f"indivisible_sep{sep}"] = str(e)
            jdist.set_mesh(None)
        ref["fallback"] = _jax_ring(*DATA["fallback"], False)
        ref["scale_fallback"] = _jax_ring(*DATA["scale"], False, scale=0.5)
    finally:
        jdist.set_mesh(None)
        jfleet.fleet._is_initialized = False
    return ref


@pytest.fixture(scope="module")
def job():
    from paddle_tpu_torch.distributed import spawn

    ctx = spawn(torch_sep_moe_ranks.ring_attention_cases, args=(DATA,),
                nprocs=4, join=False, backend="cpu")
    try:
        ref = _jax_side()
    finally:
        ctx.join(timeout=600)
    res = ctx.results()
    return [res[r] for r in range(4)], ref


@pytest.mark.parametrize("sep", SEPS)
@pytest.mark.parametrize("causal", [False, True])
def test_matches_dense(job, sep, causal):
    ranks, ref = job
    key = f"dense_{causal}_sep{sep}"
    want = _dense_ref(*DATA["dense"], causal)
    for r in ranks:
        np.testing.assert_allclose(r[key], ref[key], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r[key], want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sep", SEPS)
def test_gradients_match_dense(job, sep):
    """Every rank's gradients of the whole q, k and v (the loss computed
    on the gathered output) against the JAX ring's at ``sep`` 4, the JAX
    test's degree (its gradients are the dense ones within this
    tolerance at any degree)."""
    ranks, ref = job
    for r in ranks:
        for a, b in zip(r[f"grads_sep{sep}"], ref["grads"]):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_fallback_without_mesh(job):
    ranks, ref = job
    want = _dense_ref(*DATA["fallback"], False)
    for r in ranks:
        np.testing.assert_allclose(r["fallback"], ref["fallback"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["fallback"], want, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("sep", SEPS)
def test_indivisible_seq_raises(job, sep):
    ranks, ref = job
    assert ref[f"indivisible_sep{sep}"]
    for r in ranks:
        assert r[f"indivisible_sep{sep}"] == ref[f"indivisible_sep{sep}"]


def test_composes_with_dp(job):
    """``sep`` 2 beside ``dp`` 2, causal (the JAX test's ``sep`` 2 x ``dp``
    4): every rank, both ``dp`` groups, gives the dense output."""
    ranks, ref = job
    want = _dense_ref(*DATA["dense"], True)
    for r in ranks:
        np.testing.assert_allclose(r["dense_True_sep2"], want, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("sep", SEPS)
def test_custom_scale_fallback_parity(job, sep):
    ranks, ref = job
    for r in ranks:
        np.testing.assert_allclose(r["scale_fallback"], r[f"scale_sep{sep}"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r[f"scale_sep{sep}"], ref[f"scale_sep{sep}"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["scale_fallback"], ref["scale_fallback"],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sep", SEPS)
def test_backward_runs_k2_k3_per_block(job, sep):
    """Causal: rank ``r`` of the ``sep`` group runs K1, K2 and K3 once per
    block it attends (``r + 1`` of them) and never on a future block."""
    ranks, _ = job
    for r in ranks:
        i = r["rank"] % sep
        assert r[f"flash_calls_sep{sep}"] == dict.fromkeys(fa.KERNELS, i + 1)


# ------------------------------------------------ the block loop alone
def _whole(q, k, v, do, causal):
    o, lse = fa.ref_flash_fwd(q, k, v, causal, 1.0 / math.sqrt(q.shape[-1]))
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
    return o, dq, dk, dv


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("causal", [False, True])
def test_block_loop_in_one_process_matches_whole_sequence(causal):
    """``sep_moe_drills.block_loop``: every rank of a ring of 4 through
    ``ListHop`` in turn, as the card's check drives it."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(1, 64, 2, 16, generator=g) for _ in range(4))
    for got, want in zip(drills.block_loop(q, k, v, do, causal),
                         _whole(q, k, v, do, causal)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_block_loop_bf16_within_its_rounding():
    """bf16 blocks merge from bf16 ``O_i`` (K1 returns q's dtype), so the
    loop is held by relative norm (2e-2) against the whole sequence in
    bf16, not bit for bit."""
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(1, 64, 2, 16, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    for got, want in zip(drills.block_loop(q, k, v, do, True),
                         _whole(q, k, v, do, True)):
        assert _rel(got, want) < 2e-2


def test_a_merge_without_the_block_weights_fails(monkeypatch):
    """The control of the card's check: the merge with ``e^(lse_i - m)``
    replaced by 1 gives another output."""
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(1, 64, 2, 16, generator=g) for _ in range(4))
    want = _whole(q, k, v, do, True)[0]
    monkeypatch.setattr(ra, "_merge", drills._unweighted_merge)
    assert _rel(drills.block_loop(q, k, v, do, True)[0], want) > 1e-2
