"""paddle_tpu_torch.ops.flash_attention against the JAX package's Pallas
flash kernels.

The port's plain versions (what a CPU tensor runs, and what the CUDA
kernels are held against on the card by chip_smoke.py) must compute what
the Pallas kernels compute: the forward's O and LSE against
``_flash_fwd_bhsd`` (K1), and dQ/dK/dV through the port's autograd
Function against ``jax.vjp`` of ``flash_attention_bshd`` (K2, K3). The
Pallas kernels run in interpret mode on the CPU, as
tests/test_flash_attention.py runs them. Inputs and the output cotangent
are drawn once with numpy and handed to both packages.

Tolerances. f32: atol = rtol = 1e-5. Both sides do the same f32 math
(the Pallas blocks cover these whole sequences, so even the softmax max
is the same), summed in other orders. bf16: atol = rtol = 2e-2 for O and
the grads (a few bf16 ulps of O(1) values: both sides round p and dS to
bf16 at the same points, and a value whose f32 sum lands near a rounding
boundary may round one ulp apart), 1e-5 for the f32 LSE.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as jF
from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ops import flash_attention as tfa
from torch_suite import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


# name: (B, Sq, Sk, H, D, causal, key padding, dropout, dtype)
CASES = {
    "causal": (2, 128, 128, 2, 32, True, False, 0.0, "f32"),
    "full": (2, 128, 128, 2, 32, False, False, 0.0, "f32"),
    "sq_lt_sk": (1, 64, 160, 2, 32, True, False, 0.0, "f32"),
    "sq_gt_sk": (1, 96, 40, 2, 32, True, False, 0.0, "f32"),
    "s100": (2, 100, 100, 2, 64, True, False, 0.0, "f32"),
    "kpad_empty_row": (2, 128, 128, 2, 32, False, True, 0.0, "f32"),
    "kpad_causal": (2, 100, 100, 2, 32, True, True, 0.0, "f32"),
    "dropout": (1, 128, 128, 2, 32, True, False, 0.3, "f32"),
    "d128": (1, 128, 128, 1, 128, True, False, 0.0, "f32"),
    "causal_bf16": (2, 128, 128, 2, 32, True, False, 0.0, "bf16"),
    "d128_bf16": (1, 100, 100, 2, 128, True, False, 0.0, "bf16"),
    "dropout_bf16": (1, 128, 128, 1, 64, False, False, 0.3, "bf16"),
}
SEED = 1234
TOL = {"f32": 1e-5, "bf16": 2e-2}


def _inputs(name):
    B, sq, sk, H, D, causal, kpad, drop, dt = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, sk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, sk, H, D)).astype(np.float32)
    g = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    keep = None
    if kpad:
        keep = np.ones((B, sk), bool)
        keep[0, sk - 37:] = False
        keep[1, :] = False  # batch row 1: every key padded out
    if dt == "bf16":
        q, k, v, g = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v, g))
    return (q, k, v, g, keep), dict(causal=causal, dropout_p=drop,
                                    dropout_seed=SEED if drop else 0)


def _t(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return (x.float() if isinstance(x, torch.Tensor) else
            np.asarray(x, np.float32))


def _close(got, want, tol):
    got = np.asarray(_np(got), np.float32)
    want = np.asarray(_np(want), np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _bh(a):
    b, s, h, d = a.shape
    return jnp.swapaxes(jnp.asarray(a), 1, 2).reshape(b * h, s, d)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_pallas(name):
    (q, k, v, _g, keep), kw = _inputs(name)
    B, sq, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    kpad = None if keep is None else jnp.asarray(keep, jnp.float32)
    o_j, lse_j = fa._flash_fwd_bhsd(
        _bh(q), _bh(k), _bh(v), kw["causal"], scale,
        drop_p=kw["dropout_p"], drop_seed=kw["dropout_seed"], kpad=kpad,
        kpad_heads=H)
    o_j = np.swapaxes(np.asarray(o_j, np.float32).reshape(B, H, sq, D), 1, 2)
    o_t, lse_t = tfa.flash_fwd(_t(q), _t(k), _t(v), key_padding_mask=_t(keep),
                               scale=scale, **kw)
    assert o_t.dtype == _t(q).dtype and o_t.shape == (B, sq, H, D)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (B * H, sq)
    _close(o_t, o_j, TOL[CASES[name][-1]])
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-5)
    if keep is not None:  # a row with no key gives 0
        assert float(o_t[1].float().abs().max()) == 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_pallas(name):
    (q, k, v, g, keep), kw = _inputs(name)
    kpad_j = None if keep is None else jnp.asarray(keep)
    _, vjp = jax.vjp(lambda a, b, c: fa.flash_attention_bshd(
        a, b, c, key_padding_mask=kpad_j, **kw), *(jnp.asarray(x)
                                                   for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    before = dict(tfa.plain_calls)
    out = tfa.flash_attention_bshd(qt, kt, vt, key_padding_mask=_t(keep),
                                   **kw)
    out.backward(_t(g))
    for t, w in zip((qt, kt, vt), want):
        assert t.grad.dtype == t.dtype
        _close(t.grad, w, TOL[CASES[name][-1]])
    for kname in tfa.KERNELS:  # the CPU path is the plain version
        assert tfa.plain_calls[kname] == before[kname] + 1


@pytest.mark.parametrize("seed,bh,bq,bk,qi,ki", [
    (0, 0, 128, 128, 0, 0), (7, 3, 128, 256, 1, 2), (99, 31, 256, 128, 3, 0),
    ((1 << 24) - 1, 255, 128, 128, 5, 7), (42, 1, 64, 512, 9, 1)])
def test_keep_mask_bit_for_bit(seed, bh, bq, bk, qi, ki):
    want = np.asarray(fa._keep_mask(jnp.float32(seed), bh, qi, ki, bq, bk,
                                    0.3))
    rows = (qi * bq + torch.arange(bq, dtype=torch.int32))[:, None]
    cols = (ki * bk + torch.arange(bk, dtype=torch.int32))[None, :]
    got = tfa.keep_mask(seed, torch.tensor(bh, dtype=torch.int32), rows, cols,
                        0.3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_mask_is_global():
    """The JAX blocks of two layouts tile the port's one global mask."""
    s, seed, bh, p = 512, 5, 2, 0.25
    full = tfa.keep_mask(seed, torch.tensor(bh, dtype=torch.int32),
                         torch.arange(s, dtype=torch.int32)[:, None],
                         torch.arange(s, dtype=torch.int32)[None, :], p).numpy()
    for bq, bk in ((128, 256), (256, 128)):
        tiled = np.block([[np.asarray(fa._keep_mask(jnp.float32(seed), bh, i,
                                                    j, bq, bk, p))
                           for j in range(s // bk)] for i in range(s // bq)])
        np.testing.assert_array_equal(full, tiled)
    assert 0.7 < full.mean() < 0.8


def test_kernel_path_refuses_what_it_does_not_take():
    """The CUDA wrapper checks before it launches: a head dim the kernels
    were not built for, mixed dtypes, or a strided head dim raise."""
    q = torch.zeros(1, 8, 1, 48)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check_inputs(q, q, q, None)
    q = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="dtype"):
        tfa._check_inputs(q, q.double(), q, None)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_inputs(q, torch.zeros(1, 8, 1, 64)[..., ::2], q, None)
    tfa._check_inputs(torch.zeros(1, 8, 3, 32)[:, :, :1], q, q, None)


@pytest.mark.parametrize("form", ["key_padding", "bool_sq_sk", "additive"])
def test_sdpa_masks_match_jax(form):
    """``scaled_dot_product_attention`` with a mask: the key-padding form
    ``[B, 1, 1, Sk]`` routes to flash attention, any other mask to the
    dense ``_sdpa_ref``; both match the JAX package's function (its dense
    path, off the TPU) at f32 1e-5."""
    B, S, H, D = 2, 48, 2, 32
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    if form == "key_padding":
        mask = np.ones((B, 1, 1, S), bool)
        mask[0, ..., 30:] = False
    elif form == "bool_sq_sk":
        mask = rng.random((S, S)) < 0.7
        mask[:, 0] = True
    else:
        mask = (-2.0 * rng.random((B, H, S, S))).astype(np.float32)
    want = jF.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)), attn_mask=paddle.to_tensor(mask),
        is_causal=True)
    tfa.reset_counters()
    got = tF.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        attn_mask=torch.from_numpy(mask), is_causal=True)
    assert tfa.plain_calls["flash_fwd"] == (form == "key_padding")
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=1e-5, rtol=1e-5)


def _misaligned(which):
    """bf16 ``[2, 8, 2, 32]`` views with one 16-byte rule broken."""
    bf = torch.bfloat16
    n = 2 * 8 * 2 * 32
    if which == "data_pointer":  # 2 bytes past an aligned allocation
        return torch.zeros(n + 1, dtype=bf)[1:].view(2, 8, 2, 32)
    if which == "batch_stride":  # 516 elements = 1032 bytes
        return torch.zeros(2 * 516, dtype=bf).as_strided(
            (2, 8, 2, 32), (516, 64, 32, 1))
    if which == "sequence_stride":  # 68 elements = 136 bytes
        return torch.zeros(2, 8, 68, dtype=bf)[..., :64].unflatten(-1, (2, 32))
    assert which == "head_stride"  # 36 elements = 72 bytes
    return torch.zeros(2, 8, 2, 36, dtype=bf)[..., :32]


@pytest.mark.parametrize("which", ["data_pointer", "batch_stride",
                                   "sequence_stride", "head_stride"])
@pytest.mark.parametrize("slot", ["q", "k", "v", "dO"])
def test_kernel_path_refuses_misaligned_bf16(which, slot):
    """The bf16 forward and dK/dV kernels copy 16 bytes at a time: the
    wrapper refuses a bf16 q, k, v or dO whose data pointer or batch,
    sequence or head stride is off 16 bytes; the same layout in f32, which
    the f32 kernels take, passes."""
    good = torch.zeros(2, 8, 2, 32, dtype=torch.bfloat16)
    bad = _misaligned(which)
    assert bad.shape == good.shape and bad.stride(-1) == 1
    args = {"q": good, "k": good, "v": good, "dO": good}
    args[slot] = bad
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_inputs(args["q"], args["k"], args["v"], None,
                          extra=(args["dO"],))
    f32 = {n: t.float() if n != slot else _misaligned_f32(which)
           for n, t in args.items()}
    tfa._check_inputs(f32["q"], f32["k"], f32["v"], None,
                      extra=(f32["dO"],))


def _misaligned_f32(which):
    t = _misaligned(which)
    return torch.zeros(t.untyped_storage().nbytes() // 2).as_strided(
        t.shape, t.stride(), t.storage_offset())


def _captured_qkv(attn, x, monkeypatch):
    """The q, k, v that ``attn`` hands to ``F.flash_attention``."""
    seen = {}

    def capture(q, k, v, **kw):
        seen.update(q=q, k=k, v=v)
        return torch.zeros_like(q), None

    monkeypatch.setattr(tF, "flash_attention", capture)
    attn(x)
    return seen["q"], seen["k"], seen["v"]


@pytest.mark.parametrize("model", ["gpt", "llama_gqa", "llama_mha"])
def test_kernel_path_takes_model_qkv(model, monkeypatch):
    """The kernels take the models' own q/k/v without a copy: GPT's
    strided views of one QKV projection and Llama's post-RoPE (and, with
    GQA, repeated) heads, in bf16, built at a tiny size through the
    port's GPTAttention and LlamaAttention."""
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.models import llama as tllama

    torch.manual_seed(0)
    if model == "gpt":
        attn = tgpt.GPTAttention(tgpt.gpt_tiny())
    else:
        nkv = 2 if model == "llama_gqa" else 4
        attn = tllama.LlamaAttention(tllama.llama_tiny(num_key_value_heads=nkv))
    attn = attn.to(torch.bfloat16)
    x = torch.randn(2, 24, 128).to(torch.bfloat16)
    q, k, v = _captured_qkv(attn, x, monkeypatch)
    assert q.dtype == torch.bfloat16 and q.shape == (2, 24, 4, 32)
    if model == "gpt":  # views into the [B, S, 3H] projection
        assert q.stride(1) == 3 * 128 and not q.is_contiguous()
        assert k.data_ptr() - q.data_ptr() == 128 * 2
    tfa._check_inputs(q, k, v, None, extra=(torch.zeros_like(q),))
