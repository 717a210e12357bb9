"""``incubate.nn`` (the fused layers and functionals), ``autotune``,
``nn.functional.flash_attn_unpadded`` and the namespaces of this slice,
against the JAX package.

Each case builds a layer (or takes raw weights) in both packages, the
port's from the JAX layer's ``state_dict``, runs both on the same seeded
numpy inputs, puts a seeded cotangent on every float output and holds
the outputs (f32: rtol 1e-5, atol 1e-6) and every input and parameter
gradient (rtol and atol 1e-4) equal. The JAX side of every case runs
once, in a module-scoped fixture. Dropout is 0 throughout: the port's
dropout draws from torch generators, not the JAX package's keys. Masks:
none and the bool ``[B, 1, 1, S]`` key-padding form take the port's
flash path (its plain version on the CPU), a float mask the dense
version; the JAX package's CPU arrays take its dense version for all.
"""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

E, H, FF, B, S = 32, 4, 64, 2, 6
TOL, GRAD_TOL = (1e-5, 1e-6), 1e-4


def R(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype("f4")


def _kpad():
    m = np.ones((B, 1, 1, S), bool)
    m[0, ..., 4:] = False
    m[1, ..., 5:] = False
    return m


def _float_causal():
    return np.triu(np.full((S, S), -1e9, "f4"), 1)[None, None]


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out] if out is not None and hasattr(out, "numpy") else []


def _run(P, layer, call, inputs):
    ts = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f") for a in inputs]
    outs = _flat(call(P, layer, *ts))
    rng = np.random.default_rng(7)
    loss = None
    for o in outs:
        if o.stop_gradient:
            continue
        term = (o * P.to_tensor(rng.standard_normal(o.shape).astype(
            "f4"))).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    grads = {f"input{i}": np.asarray(t.grad.numpy())
             for i, t in enumerate(ts) if t.grad is not None}
    if layer is not None:
        grads.update({n: np.asarray(p.grad.numpy())
                      for n, p in layer.named_parameters()
                      if p.grad is not None})
    return [np.asarray(o.numpy()) for o in outs], grads


def _mha(**kw):
    return lambda P: P.incubate.nn.FusedMultiHeadAttention(
        E, H, dropout_rate=0.0, attn_dropout_rate=0.0, **kw)


def _call_mask(P, layer, x, m):
    return layer(x, attn_mask=m)


def _call_cache(P, layer, x, kp, vp):
    return layer(x, cache=(kp, vp))


def _decode(P, layer, x0, x1, x2, m, k0, v0):
    """A prefill through empty caches under a float causal mask, then two
    one-token steps that carry the returned caches."""
    caches = [(k0, v0)] * layer.num_layers
    o0, caches = layer(x0, attn_mask=m, caches=caches)
    o1, caches = layer(x1, caches=caches)
    o2, caches = layer(x2, caches=caches)
    return [o0, o1, o2] + [t for c in caches for t in c]


LAYER_CASES = {
    "mha_post_ln": (_mha(), lambda P, l, x: l(x), [R(B, S, E)]),
    "mha_pre_ln": (_mha(normalize_before=True), lambda P, l, x: l(x),
                   [R(B, S, E)]),
    "mha_transpose_qkv_wb": (_mha(transpose_qkv_wb=True),
                             lambda P, l, x: l(x), [R(B, S, E)]),
    "mha_key_padding": (_mha(), _call_mask, [R(B, S, E), _kpad()]),
    "mha_pre_ln_key_padding": (_mha(normalize_before=True), _call_mask,
                               [R(B, S, E), _kpad()]),
    "mha_float_mask": (_mha(normalize_before=True), _call_mask,
                       [R(B, S, E), _float_causal()]),
    "mha_cache": (_mha(normalize_before=True), _call_cache,
                  [R(B, 1, E), R(B, S, H, E // H, seed=1),
                   R(B, S, H, E // H, seed=2)]),
    "ffn_relu": (lambda P: P.incubate.nn.FusedFeedForward(
        E, FF, dropout_rate=0.0), lambda P, l, x: l(x), [R(B, S, E)]),
    "ffn_gelu_pre_ln": (lambda P: P.incubate.nn.FusedFeedForward(
        E, FF, dropout_rate=0.0, activation="gelu", normalize_before=True),
        lambda P, l, x: l(x), [R(B, S, E)]),
    "encoder_layer": (lambda P: P.incubate.nn.FusedTransformerEncoderLayer(
        E, H, FF, dropout_rate=0.0, activation="gelu"),
        lambda P, l, x, m: l(x, src_mask=m), [R(B, S, E), _kpad()]),
    "encoder_layer_pre_ln": (
        lambda P: P.incubate.nn.FusedTransformerEncoderLayer(
            E, H, FF, dropout_rate=0.0, normalize_before=True),
        lambda P, l, x: l(x), [R(B, S, E)]),
    "multi_transformer": (lambda P: P.incubate.nn.FusedMultiTransformer(
        E, H, FF, num_layers=2), lambda P, l, x: l(x), [R(B, S, E)]),
    "multi_transformer_decode": (
        lambda P: P.incubate.nn.FusedMultiTransformer(E, H, FF,
                                                      num_layers=2),
        _decode, [R(B, S, E), R(B, 1, E, seed=1), R(B, 1, E, seed=2),
                  _float_causal(), np.zeros((B, 0, H, E // H), "f4"),
                  np.zeros((B, 0, H, E // H), "f4")]),
    "linear": (lambda P: P.incubate.nn.FusedLinear(E, FF),
               lambda P, l, x: l(x), [R(B, S, E)]),
    "linear_transposed": (lambda P: P.incubate.nn.FusedLinear(
        E, FF, transpose_weight=True), lambda P, l, x: l(x), [R(B, S, E)]),
    "dropout_add": (lambda P: P.incubate.nn.FusedDropoutAdd(p=0.0),
                    lambda P, l, x, y: l(x, y), [R(B, S, E),
                                                 R(B, S, E, seed=1)]),
    "bias_dropout_residual_ln": (
        lambda P: P.incubate.nn.FusedBiasDropoutResidualLayerNorm(
            E, dropout_rate=0.0), lambda P, l, x, y: l(x, y),
        [R(B, S, E), R(B, S, E, seed=1)]),
    "ec_moe": (lambda P: P.incubate.nn.FusedEcMoe(E, FF, 4),
               lambda P, l, x, g: l(x, g), [R(B, S, E), R(B, S, 4, seed=1)]),
}

_W = dict(qkv=R(3, H, E // H, E, seed=3) * 0.2, qkv_b=R(3, H, E // H, seed=4),
          lin=R(E, E, seed=5) * 0.2, lin_b=R(E, seed=6),
          w1=R(E, FF, seed=7) * 0.2, b1=R(FF, seed=8),
          w2=R(FF, E, seed=9) * 0.2, b2=R(E, seed=10),
          g=R(E, seed=11), gb=R(E, seed=12))


def _fmha(P, x, qkv, qkv_b, lin, lin_b, g, gb, *rest, pre=False, **kw):
    mask = rest[0] if rest else None
    return P.incubate.nn.functional.fused_multi_head_attention(
        x, qkv, lin, pre_layer_norm=pre, pre_ln_scale=g, pre_ln_bias=gb,
        ln_scale=g, ln_bias=gb, qkv_bias=qkv_b, linear_bias=lin_b,
        attn_mask=mask, dropout_rate=0.0, attn_dropout_rate=0.0, **kw)


def _fmha_cache(P, x, qkv, qkv_b, lin, lin_b, g, gb, cache):
    return _fmha(P, x, qkv, qkv_b, lin, lin_b, g, gb, pre=True,
                 cache_kv=cache)


def _fmt(P, x, qkv, qkv_b, lin, lin_b, g, gb, w1, b1, w2, b2, *cache):
    two = lambda t: [t, t * 0.5]  # noqa: E731  two layers of weights
    return P.incubate.nn.functional.fused_multi_transformer(
        x, two(g), two(gb), two(qkv), two(qkv_b), two(lin), two(lin_b),
        two(g), two(gb), two(w1), two(b1), two(w2), two(b2),
        cache_kvs=list(cache) or None)


_MHA_W = [_W[k] for k in ("qkv", "qkv_b", "lin", "lin_b", "g", "gb")]
_FFN_W = [_W[k] for k in ("w1", "b1", "w2", "b2")]

FUNCTIONAL_CASES = {
    "matmul_bias": (lambda P, x, y, b: P.incubate.nn.functional
                    .fused_matmul_bias(x, y, b), [R(S, E), R(E, FF, seed=1),
                                                  R(FF, seed=2)]),
    "matmul_bias_transposed": (
        lambda P, x, y: P.incubate.nn.functional.fused_matmul_bias(
            x, y, transpose_x=True, transpose_y=True),
        [R(E, S), R(FF, E, seed=1)]),
    "linear_transposed": (lambda P, x, w, b: P.incubate.nn.functional
                          .fused_linear(x, w, b, transpose_weight=True),
                          [R(B, S, E), R(FF, E, seed=1), R(FF, seed=2)]),
    "dropout_add": (lambda P, x, y: P.incubate.nn.functional
                    .fused_dropout_add(x, y, p=0.0),
                    [R(B, S, E), R(B, S, E, seed=1)]),
    "bias_dropout_residual_ln": (
        lambda P, x, r, b, g, gb: P.incubate.nn.functional
        .fused_bias_dropout_residual_layer_norm(x, r, b, g, gb,
                                                dropout_rate=0.0),
        [R(B, S, E), R(B, S, E, seed=1), _W["b2"], _W["g"], _W["gb"]]),
    "mha_post_ln": (_fmha, [R(B, S, E)] + _MHA_W),
    "mha_pre_ln_key_padding": (
        lambda P, *a: _fmha(P, *a, pre=True), [R(B, S, E)] + _MHA_W
        + [_kpad()]),
    "mha_float_mask": (_fmha, [R(B, S, E)] + _MHA_W + [_float_causal()]),
    "mha_cache": (_fmha_cache, [R(B, 1, E)] + _MHA_W
                  + [R(2, B, S, H, E // H, seed=13)]),
    "feedforward": (lambda P, x, w1, b1, w2, b2, g, gb: P.incubate.nn
                    .functional.fused_feedforward(
                        x, w1, w2, b1, b2, g, gb, g, gb, dropout1_rate=0.0,
                        dropout2_rate=0.0, activation="gelu"),
                    [R(B, S, E)] + _FFN_W + [_W["g"], _W["gb"]]),
    "feedforward_pre_ln": (lambda P, x, w1, b1, w2, b2, g, gb: P.incubate
                           .nn.functional.fused_feedforward(
                               x, w1, w2, b1, b2, g, gb, g, gb,
                               dropout1_rate=0.0, dropout2_rate=0.0,
                               pre_layer_norm=True),
                           [R(B, S, E)] + _FFN_W + [_W["g"], _W["gb"]]),
    "multi_transformer": (_fmt, [R(B, S, E)] + _MHA_W + _FFN_W),
    "multi_transformer_cache": (
        _fmt, [R(B, 1, E)] + _MHA_W + _FFN_W
        + [R(2, B, S, H, E // H, seed=14), R(2, B, S, H, E // H, seed=15)]),
    "ec_moe": (lambda P, x, g, w0, b0, w1, b1: P.incubate.nn.functional
               .fused_ec_moe(x, g, w0, b0, w1, b1, act_type="gelu"),
               [R(B, S, E), R(B, S, 4, seed=1), R(4, E, FF, seed=2) * 0.2,
                R(4, FF, seed=3), R(4, FF, E, seed=4) * 0.2,
                R(4, E, seed=5)]),
    "ec_moe_relu": (lambda P, x, g, w0, b0, w1, b1: P.incubate.nn
                    .functional.fused_ec_moe(x, g, w0, b0, w1, b1,
                                             act_type="relu"),
                    [R(B, S, E), R(B, S, 4, seed=1),
                     R(4, E, FF, seed=2) * 0.2, R(4, FF, seed=3),
                     R(4, FF, E, seed=4) * 0.2, R(4, E, seed=5)]),
}


def _packed(seed=0):
    lens = [3, 5, 4]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype("int32")
    T = int(cu[-1])
    return [R(T, H, 8, seed=seed), R(T, H, 8, seed=seed + 1),
            R(T, H, 8, seed=seed + 2), cu]


def _unpadded(causal):
    def fn(P, q, k, v, cu):
        return P.nn.functional.flash_attn_unpadded(
            q, k, v, cu, cu, 5, 5, causal=causal)[0]
    return fn


UNPADDED_CASES = {"full": (_unpadded(False), _packed()),
                  "causal": (_unpadded(True), _packed(3))}


@pytest.fixture(scope="module")
def jax_side():
    """Every case's JAX outputs, gradients and (for layers) state."""
    out = {}
    for name, (make, call, inputs) in LAYER_CASES.items():
        pt.seed(0)
        layer = make(pt)
        layer.train()
        state = {k: np.asarray(v.numpy())
                 for k, v in layer.state_dict().items()}
        out["layer", name] = (state, *_run(pt, layer, call, inputs))
    for table, cases in (("functional", FUNCTIONAL_CASES),
                         ("unpadded", UNPADDED_CASES)):
        for name, (fn, inputs) in cases.items():
            out[table, name] = (None, *_run(
                pt, None, lambda P, _, *ts, fn=fn: fn(P, *ts), inputs))
    return out


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                               err_msg=what)


def _hold(jax_side, key, layer, call, inputs):
    state, jo, jg = jax_side[key]
    if state is not None:
        missing, unexpected = layer.set_state_dict(state)
        assert not missing and not unexpected, (missing, unexpected)
    to, tg = _run(paddle, layer, call, inputs)
    assert len(to) == len(jo) and tg.keys() == jg.keys(), (
        len(to), len(jo), tg.keys() ^ jg.keys())
    for i, (a, b) in enumerate(zip(jo, to)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        _close(b, a, TOL, f"{key} output {i}")
    for k in jg:
        _close(tg[k], jg[k], (GRAD_TOL, GRAD_TOL), f"{key} grad {k}")


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_fused_layer_matches_jax(jax_side, name):
    make, call, inputs = LAYER_CASES[name]
    layer = make(paddle)
    layer.train()
    _hold(jax_side, ("layer", name), layer, call, inputs)


@pytest.mark.parametrize("name", list(FUNCTIONAL_CASES))
def test_fused_functional_matches_jax(jax_side, name):
    fn, inputs = FUNCTIONAL_CASES[name]
    _hold(jax_side, ("functional", name), None,
          lambda P, _, *ts: fn(P, *ts), inputs)


@pytest.mark.parametrize("name", list(UNPADDED_CASES))
def test_flash_attn_unpadded_matches_jax(jax_side, name):
    fn, inputs = UNPADDED_CASES[name]
    _hold(jax_side, ("unpadded", name), None,
          lambda P, _, *ts: fn(P, *ts), inputs)


def test_fused_layers_keep_the_jax_state_dict_keys():
    """Names and shapes of every parameter, ``FusedMultiTransformer``'s
    blocks as sublayers ``"0"``, ``"1"``."""
    for name in ("multi_transformer", "ec_moe", "linear",
                 "bias_dropout_residual_ln", "mha_transpose_qkv_wb"):
        make = LAYER_CASES[name][0]
        want = {k: tuple(v.shape) for k, v in make(pt).state_dict().items()}
        got = {k: tuple(v.shape) for k, v in
               make(paddle).state_dict().items()}
        assert got == want, name
        if name == "multi_transformer":
            assert {"0.fused_attn.qkv_weight", "1.ffn.ln2_bias"} <= set(got)


def test_fused_layers_refuse_as_the_jax_ones():
    for P in (pt, paddle):
        with pytest.raises(ValueError):
            P.incubate.nn.FusedMultiHeadAttention(30, 4)
        with pytest.raises(NotImplementedError):
            P.incubate.nn.FusedMultiTransformer(E, H, FF,
                                                normalize_before=False)
        mt = P.incubate.nn.FusedMultiTransformer(E, H, FF, num_layers=2)
        empty = P.to_tensor(np.zeros((1, 0, H, E // H), "f4"))
        with pytest.raises(ValueError):
            mt(P.to_tensor(R(1, 2, E)), caches=[(empty, empty)])
        with pytest.raises(ValueError):
            P.incubate.nn.functional.fused_ec_moe(
                *[P.to_tensor(R(1, 2, 2))] * 6, act_type="tanh")


def test_decode_caches_are_b_s_h_d():
    """The caches grow along axis 1, ``[B, S_past, H, D]``, as the JAX
    code concatenates them (its docstring says ``[B, H, S, D]``)."""
    mt = paddle.incubate.nn.FusedMultiTransformer(E, H, FF, num_layers=1)
    mt.eval()
    empty = paddle.to_tensor(np.zeros((B, 0, H, E // H), "f4"))
    _, caches = mt(paddle.to_tensor(R(B, 3, E)), caches=[(empty, empty)])
    _, caches = mt(paddle.to_tensor(R(B, 1, E)), caches=caches)
    assert caches[0][0].shape == [B, 4, H, E // H]


def test_autotune_routes_the_flash_switch(tmp_path):
    from paddle_tpu_torch.nn.functional import attention

    inc = paddle.incubate
    try:
        inc.set_config({"kernel": {"enable": False}})
        assert attention.pallas_flash_enabled is False
        assert inc.autotune_status()["kernel"]["enable"] is False
        path = tmp_path / "tune.json"
        path.write_text(json.dumps({"kernel": {"enable": True},
                                    "dataloader": {"tuning_steps": 5}}))
        inc.set_config(str(path))
        assert attention.pallas_flash_enabled is True
        assert inc.autotune_status()["dataloader"]["tuning_steps"] == 5
        with pytest.raises(TypeError):
            inc.set_config(42)
        with pytest.raises(TypeError):
            inc.set_config({"layout": True})
    finally:
        inc.set_config(None)
    assert attention.pallas_flash_enabled is True
    assert inc.autotune_status() == {
        "kernel": {"enable": True}, "layout": {"enable": True},
        "dataloader": {"enable": True, "tuning_steps": 5}}


def test_kernel_switch_sends_attention_to_the_dense_version():
    """With ``kernel.enable`` False the fused layer's attention takes the
    dense version (no flash plain call), with equal outputs."""
    from paddle_tpu_torch.ops import flash_attention as fa

    layer = _mha()(paddle)
    x = paddle.to_tensor(R(B, S, E))
    fa.reset_counters()
    on = np.asarray(layer(x, attn_mask=paddle.to_tensor(_kpad())).numpy())
    assert fa.plain_calls["flash_fwd"] == 1
    try:
        paddle.incubate.set_config({"kernel": {"enable": False}})
        off = np.asarray(layer(x, attn_mask=paddle.to_tensor(
            _kpad())).numpy())
    finally:
        paddle.incubate.set_config(None)
    assert fa.plain_calls["flash_fwd"] == 1
    _close(off, on, TOL, "kernel switched off")


@pytest.mark.parametrize("ns", ["incubate", "incubate.nn",
                                "incubate.nn.functional",
                                "incubate.optimizer", "incubate.asp",
                                "incubate.autograd", "geometric"])
def test_namespace_equals_the_jax_packages(ns):
    import importlib

    jm = importlib.import_module(f"paddle_tpu.{ns}")
    tm = importlib.import_module(f"paddle_tpu_torch.{ns}")
    assert list(tm.__all__) == list(jm.__all__)
    for name in tm.__all__:
        assert hasattr(tm, name), name


def test_the_slices_names_are_exposed():
    assert "flash_attn_unpadded" in paddle.nn.functional.__all__
    assert "geometric" in paddle.__all__
    for name in ("nn", "optimizer", "asp", "autograd", "set_config",
                 "autotune_status", "segment_sum", "graph_send_recv",
                 "softmax_mask_fuse"):
        assert hasattr(paddle.incubate, name), name
    of = paddle.incubate.optimizer.functional
    assert {"minimize_bfgs", "minimize_lbfgs"} <= set(of.__all__)


def test_the_card_phase_needs_a_card_unless_told_cpu(monkeypatch):
    """``tools/incubate_drills.py`` (``chip_smoke.py`` phase 26) runs on
    the card by default and raises without one; the fused layers are made
    on the card unless the device is set to the CPU."""
    import torch

    from paddle_tpu_torch.tools import incubate_drills

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paddle.set_device(None)
    with pytest.raises(RuntimeError):
        incubate_drills.run(small=True)
    with pytest.raises(RuntimeError):
        paddle.incubate.nn.FusedMultiTransformer(E, H, FF)
    paddle.set_device("cpu")
    paddle.incubate.nn.FusedMultiTransformer(E, H, FF)
