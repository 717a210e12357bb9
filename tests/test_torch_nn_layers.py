"""The port's ``nn`` layers against the JAX package's, on the CPU.

- ``TestLayerBase``, ``TestFunctional``, ``TestTransformer``, ``TestClip``:
  the cases of ``tests/test_nn.py`` whose layers this slice ports, each
  run through both packages (``torch_facade_common.both``: equal results
  at the stated tolerance) or, where a value is random, on the port with
  the JAX test's assertions.
- ``test_layer_twin`` (its cases split in name order at
  ``torch_nn_cases.TWIN_SPLIT`` with ``test_torch_nn_layer_twins.py``,
  so that the suite's workers can run the halves side by side): every
  layer class of the ported
  ``nn/layer/{common,container,conv,norm,pooling,rnn,transformer}.py``
  built in both
  packages, the port's from the JAX layer's weights (``set_state_dict``),
  forward and grads (of the inputs and of every parameter) at f32 atol =
  rtol = 1e-5 (``torch_nn_common.twin``; the cases are
  ``torch_nn_cases.py``'s, the activations' and losses' in
  ``test_torch_nn_activations.py`` and ``test_torch_nn_losses.py``).
- The dropouts and ``RReLU`` in training draw from different generators
  in the two packages: their keep rate and scaling are checked on the
  port, and their eval forward as a twin.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import both, on_cpu  # noqa: F401
from torch_nn_cases import CASES, LAYERS, TWIN_SPLIT, R
from torch_nn_common import TOL, state_of, twin


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------- Layer base
class TestLayerBase:
    def test_parameter_registry(self):
        def case(P):
            lin = P.nn.Linear(4, 3)
            names = sorted(dict(lin.named_parameters()))
            return names, lin.weight.shape, lin.weight.stop_gradient
        assert both(case) == [["bias", "weight"], [4, 3], False]

    def test_sublayer_traversal(self):
        def case(P):
            nn = P.nn
            m = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
            return ([n for n, _ in m.named_parameters()],
                    [type(l).__name__ for l in m.sublayers(True)])
        both(case)

    def test_state_dict_roundtrip(self):
        def case(P):
            nn = P.nn
            m1 = nn.Sequential(nn.Linear(4, 8), nn.Linear(8, 2))
            m2 = nn.Sequential(nn.Linear(4, 8), nn.Linear(8, 2))
            missing, unexpected = m2.set_state_dict(m1.state_dict())
            assert not missing and not unexpected
            return [np.array_equal(p1.numpy(), p2.numpy()) for p1, p2 in
                    zip(m1.parameters(), m2.parameters())]
        assert all(both(case))

    def test_set_state_dict_writes_in_place_from_numpy(self):
        """Arrays (bf16 ones by bit pattern) land in the same cells and
        storage; a bad shape raises."""
        import ml_dtypes

        lin = paddle.nn.Linear(4, 3)
        cell, ptr = lin.weight, lin.weight._value.data_ptr()
        w = R(4, 3)
        missing, unexpected = lin.set_state_dict(
            {"weight": w, "bias": np.ones(3, ml_dtypes.bfloat16),
             "extra": w})
        assert missing == [] and unexpected == ["extra"]
        assert lin.weight is cell and cell._value.data_ptr() == ptr
        np.testing.assert_array_equal(lin.weight.numpy(), w)
        lin.bfloat16()
        lin.set_state_dict({"weight": w.astype(ml_dtypes.bfloat16)})
        np.testing.assert_array_equal(
            lin.weight.numpy(), w.astype(ml_dtypes.bfloat16).astype("f4"))
        with pytest.raises(ValueError):
            lin.set_state_dict({"weight": R(3, 4)})

    def test_train_eval_mode(self):
        model = paddle.nn.Sequential(paddle.nn.Linear(4, 4),
                                     paddle.nn.Dropout(0.5))
        model.eval()
        assert not model[1].training
        x = paddle.to_tensor(R(8, 4))
        np.testing.assert_array_equal(model(x).numpy(), model(x).numpy())
        model.train()
        assert model[1].training and model.training

    def test_buffers_in_state_dict(self):
        def case(P):
            bn = P.nn.BatchNorm1D(4)
            sd = bn.state_dict()
            bn.register_buffer("scratch", P.to_tensor(np.zeros(2, "f4")),
                               persistable=False)
            return (list(sd), list(bn.state_dict()),
                    [n for n, _ in bn.named_buffers()])
        both(case)

    def test_forward_hooks(self):
        def case(P):
            lin = P.nn.Linear(2, 2)
            calls = []
            h = lin.register_forward_post_hook(
                lambda l, i, o: calls.append("post"))
            g = lin.register_forward_pre_hook(
                lambda l, i: (i[0] * 2,))
            x = P.to_tensor(np.ones((1, 2), "f4"))
            y = lin(x)
            h.remove()
            g.remove()
            z = lin(x)
            return calls, np.allclose(y.numpy(), (lin(x * 2)).numpy()), \
                z.shape
        assert both(case)[0] == ["post"]

    def test_apply_and_astype(self):
        def case(P):
            model = P.nn.Sequential(P.nn.Linear(3, 3), P.nn.LayerNorm(3))
            seen = []
            model.apply(lambda l: seen.append(type(l).__name__))
            model.astype("bfloat16")
            return seen, [str(p.dtype).split(".")[-1]
                          for p in model.parameters()]
        both(case)

    def test_clear_gradients_and_cells_keep_identity(self):
        lin = paddle.nn.Linear(3, 2)
        v = lin.weight._value
        lin(paddle.to_tensor(R(2, 3))).sum().backward()
        assert lin.weight.grad is not None
        lin.astype("bfloat16")
        assert lin.weight._value is v and v.dtype == torch.bfloat16
        lin.clear_gradients()
        assert lin.weight.grad is None


# --------------------------------------------------------------- functional
class TestFunctional:
    def test_linear_matches_numpy(self):
        x, w, b = R(5, 4), R(4, 3, seed=1), R(3, seed=2)
        both(lambda P: P.nn.functional.linear(
            P.to_tensor(x), P.to_tensor(w), P.to_tensor(b)), TOL)

    def test_softmax_log_softmax(self):
        x = R(3, 5)
        both(lambda P: [P.nn.functional.softmax(P.to_tensor(x), axis=-1),
                        P.nn.functional.log_softmax(P.to_tensor(x))], TOL)

    def test_dropout_train_vs_eval(self):
        F = paddle.nn.functional
        x = paddle.to_tensor(np.ones((1000,), "float32"))
        y = F.dropout(x, 0.5, training=True).numpy()
        assert 0.3 < (y != 0).mean() < 0.7
        assert abs(y.mean() - 1.0) < 0.2
        np.testing.assert_array_equal(
            F.dropout(x, 0.5, training=False).numpy(), x.numpy())
        both(lambda P: P.nn.functional.dropout(
            P.to_tensor(np.ones((4, 5), "f4")), 0.3, training=False,
            mode="downscale_in_infer"), TOL)
        y = F.dropout(paddle.to_tensor(np.ones((64, 8), "f4")), 0.5,
                      axis=0).numpy()
        assert all(len(set(row)) == 1 for row in y)  # whole rows kept

    def test_batch_norm_running_stats(self):
        x = R(8, 4, 3, 3)

        def case(P):
            bn = P.nn.BatchNorm2D(4, momentum=0.5)
            bn.train()
            y1 = bn(P.to_tensor(x))
            m1 = bn._mean.numpy().copy()
            bn.eval()
            y2 = bn(P.to_tensor(x))
            return y1, m1, bn._variance.numpy(), y2, bn._mean.numpy()
        got = both(case, TOL)
        assert not np.allclose(got[1][2], 0)

    def test_batch_norm_buffers_update_in_place(self):
        bn = paddle.nn.BatchNorm1D(4)
        mean = bn._mean
        ptr = mean._value.data_ptr()
        bn(paddle.to_tensor(R(6, 4)))
        assert bn._mean is mean and mean._value.data_ptr() == ptr
        assert not np.allclose(mean.numpy(), 0)

    def test_layer_norm_matches_numpy(self):
        x = R(4, 6)
        both(lambda P: P.nn.LayerNorm(6)(P.to_tensor(x)), TOL)

    def test_group_instance_norm(self):
        x = R(2, 8, 4, 4)
        both(lambda P: [P.nn.GroupNorm(2, 8)(P.to_tensor(x)),
                        P.nn.InstanceNorm2D(8)(P.to_tensor(x)),
                        P.nn.functional.group_norm(P.to_tensor(x), 4)], TOL)

    def test_cross_entropy_matches_reference(self):
        logits, labels = R(8, 10), np.random.default_rng(1).integers(0, 10, 8)
        w = np.random.default_rng(2).random(10).astype("f4") + 0.5
        lbl = labels.copy()
        lbl[[2, 5]] = -100
        both(lambda P: [
            P.nn.functional.cross_entropy(P.to_tensor(logits),
                                          P.to_tensor(labels)),
            P.nn.functional.cross_entropy(P.to_tensor(logits),
                                          P.to_tensor(lbl),
                                          weight=P.to_tensor(w)),
            P.nn.functional.cross_entropy(P.to_tensor(logits),
                                          P.to_tensor(labels),
                                          label_smoothing=0.1,
                                          reduction="none"),
            P.nn.functional.softmax_with_cross_entropy(
                P.to_tensor(logits), P.to_tensor(labels[:, None]))], TOL)

    def test_cross_entropy_soft_label(self):
        logits, soft = R(4, 6), R(4, 6, seed=1)
        both(lambda P: P.nn.functional.cross_entropy(
            P.to_tensor(logits),
            P.nn.functional.softmax(P.to_tensor(soft), axis=-1),
            soft_label=True), TOL)

    def test_bce_kl_smooth_l1(self):
        z, y = R(6, 3), np.random.default_rng(1).integers(0, 2, (6, 3))
        a, b = R(4, 5, seed=2), R(4, 5, seed=3)
        p = 1 / (1 + np.exp(-z))
        both(lambda P: [
            P.nn.functional.binary_cross_entropy_with_logits(
                P.to_tensor(z), P.to_tensor(y.astype("f4"))),
            P.nn.functional.binary_cross_entropy(
                P.to_tensor(p), P.to_tensor(y.astype("f4"))),
            P.nn.functional.smooth_l1_loss(P.to_tensor(a), P.to_tensor(b)),
            P.nn.functional.kl_div(P.to_tensor(a),
                                   P.to_tensor(np.abs(b)),
                                   reduction="batchmean")], TOL)

    def test_embedding_padding_idx(self):
        ids = np.array([[0, 1, 2, 0]])
        emb = twin(lambda P: P.nn.Embedding(10, 4, padding_idx=0), [ids])
        np.testing.assert_array_equal(emb.weight.numpy()[0], np.zeros(4))
        emb.clear_gradients()
        out = emb(paddle.to_tensor(ids))
        out.sum().backward()
        g = emb.weight.grad.numpy()
        assert np.all(out.numpy()[0, 0] == 0) and np.all(g[0] == 0)
        assert not np.allclose(g[1], 0)
        twin(lambda P: P.nn.Embedding(10, 4, padding_idx=-1),
             [np.array([[9, 1, 2]])])

    def test_one_hot(self):
        both(lambda P: P.nn.functional.one_hot(
            P.to_tensor(np.array([0, 2])), 3))

    def test_pad_modes(self):
        x = R(1, 2, 3, 3)
        both(lambda P: [P.nn.functional.pad(P.to_tensor(x), [1, 1, 2, 2]),
                        P.nn.functional.pad(P.to_tensor(x), [1, 1, 1, 1],
                                            mode="reflect"),
                        P.nn.functional.pad(P.to_tensor(x), [1, 0, 0, 1],
                                            mode="replicate"),
                        P.nn.functional.pad(P.to_tensor(x), [2, 1, 0, 2],
                                            mode="circular"),
                        P.nn.functional.pad(P.to_tensor(x),
                                            [0, 0, 1, 0, 1, 2, 0, 1],
                                            value=3.0)], TOL)

    def test_interpolate(self):
        x = R(1, 3, 4, 4)
        both(lambda P: [
            P.nn.functional.interpolate(P.to_tensor(x), size=[8, 8]),
            P.nn.functional.interpolate(P.to_tensor(x), scale_factor=2,
                                        mode="bilinear"),
            P.nn.functional.interpolate(P.to_tensor(x), size=[7, 9],
                                        mode="bilinear",
                                        align_corners=True),
            P.nn.functional.interpolate(P.to_tensor(x), size=[2, 2],
                                        mode="bilinear"),
            P.nn.functional.interpolate(P.to_tensor(x), size=[6, 5],
                                        data_format="NHWC")], TOL)

    def test_unfold_fold_roundtrip(self):
        x = R(2, 3, 6, 6)
        got = both(lambda P: [
            P.nn.functional.unfold(P.to_tensor(x), 2, strides=2),
            P.nn.functional.fold(P.nn.functional.unfold(
                P.to_tensor(x), 2, strides=2), (6, 6), 2, strides=2),
            P.nn.functional.unfold(P.to_tensor(x), [3, 2], 1, [1, 0, 2, 1],
                                   [1, 2])], TOL)
        np.testing.assert_allclose(got[1][2], x, rtol=1e-6)


# ------------------------------------------------------------- transformer
class TestTransformer:
    def test_mha_self_attention(self):
        twin(lambda P: P.nn.MultiHeadAttention(16, 4), [R(2, 6, 16)])

    def test_mha_mask(self):
        mask = np.tril(np.ones((4, 4), bool))
        kpad = np.ones((2, 1, 1, 4), bool)
        kpad[1, ..., 2:] = False
        twin(lambda P: _Call(P.nn.MultiHeadAttention(8, 2),
                             attn_mask=P.to_tensor(mask)),
             [R(1, 4, 8)], train=False)
        # key padding (the flash route in the port) and an additive mask
        twin(lambda P: _Call(P.nn.MultiHeadAttention(8, 2),
                             attn_mask=P.to_tensor(kpad)), [R(2, 4, 8)])
        twin(lambda P: _Call(P.nn.MultiHeadAttention(8, 2),
                             attn_mask=P.to_tensor(R(4, 4, seed=3))),
             [R(1, 4, 8)])

    def test_mha_cache_incremental_decode(self):
        x = R(1, 3, 8)

        def case(P):
            mha = P.nn.MultiHeadAttention(8, 2)
            mha.eval()
            full = mha(P.to_tensor(x),
                       attn_mask=P.to_tensor(np.tril(np.ones((3, 3), bool))))
            cache = mha.gen_cache(P.to_tensor(x),
                                  type=P.nn.MultiHeadAttention.Cache)
            outs = []
            for t in range(3):
                step = P.to_tensor(x[:, t: t + 1])
                o, cache = mha(step, step, step, None, cache)
                outs.append(o.numpy())
            static = mha.gen_cache(P.to_tensor(x), P.to_tensor(x))
            o2, _ = mha(P.to_tensor(x), None, None, None, static)
            return full, np.concatenate(outs, 1), o2
        got = both(case_with_weights(case), TOL)
        np.testing.assert_allclose(got[1][2], got[0][2], rtol=1e-4,
                                   atol=1e-5)

    def test_encoder_decoder_stack(self):
        twin(lambda P: P.nn.Transformer(d_model=16, nhead=4,
                                        num_encoder_layers=2,
                                        num_decoder_layers=2,
                                        dim_feedforward=32, dropout=0.0),
             [R(2, 5, 16), R(2, 4, 16, seed=1)])
        for P in (pt, paddle):
            enc = P.nn.TransformerEncoder(
                P.nn.TransformerEncoderLayer(8, 2, 16), 2)
            assert len(enc.parameters()) == 32

    def test_sdpa_matches_naive(self):
        q, k, v = R(2, 5, 4, 8), R(2, 5, 4, 8, seed=1), R(2, 5, 4, 8, seed=2)
        both(lambda P: P.nn.functional.scaled_dot_product_attention(
            P.to_tensor(q), P.to_tensor(k), P.to_tensor(v)), TOL)

    def test_convert_attention_mask(self):
        from paddle_tpu_torch.nn.layer.transformer import (
            _convert_attention_mask, _normalize_attention_mask)

        m = paddle.to_tensor(np.array([[True, False, True]]))
        out = _convert_attention_mask(m, "float32")
        np.testing.assert_allclose(out.numpy(), [[0.0, -1e9, 0.0]])
        add = paddle.to_tensor(np.zeros((1, 3), "float32"))
        assert _convert_attention_mask(add, "float32") is add
        assert _normalize_attention_mask(m).dtype == torch.bool
        sq = paddle.nn.Transformer.generate_square_subsequent_mask(3)
        np.testing.assert_array_equal(sq.numpy(), np.asarray(
            pt.nn.Transformer.generate_square_subsequent_mask(3).numpy()))


def case_with_weights(case):
    """``case`` run on an MHA whose JAX weights the port's carries: the
    MHA ``case`` builds is swapped for one loaded from the JAX state."""
    weights = {}

    def run(P):
        pt.seed(0)
        real = P.nn.MultiHeadAttention

        class MHA(real):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                if P is pt:
                    weights.update(state_of(self))
                else:
                    self.set_state_dict(weights)

        P.nn.MultiHeadAttention = MHA
        try:
            return case(P)
        finally:
            P.nn.MultiHeadAttention = real
    run.__name__ = case.__name__
    return run


class _Call:
    """A layer called with fixed keyword arguments (a mask), as a Layer
    the twin runner can carry weights into."""

    def __init__(self, layer, **kw):
        self.layer, self.kw = layer, kw

    def __call__(self, *args):
        return self.layer(*args, **self.kw)

    def __getattr__(self, name):
        return getattr(self.__dict__["layer"], name)


# --------------------------------------------------------------------- clip
class TestClip:
    def test_global_norm_clip(self):
        def case(P):
            p1 = P.Parameter(np.ones((3,), "float32") * 3.0)
            p2 = P.Parameter(np.ones((4,), "float32") * 4.0)
            g1 = P.to_tensor(np.ones((3,), "float32") * 3.0)
            g2 = P.to_tensor(np.ones((4,), "float32") * 4.0)
            out = P.nn.ClipGradByGlobalNorm(1.0)([(p1, g1), (p2, g2)])
            return [g for _, g in out]
        got = both(case, TOL)
        total = np.sqrt(sum((g[2] ** 2).sum() for g in got))
        np.testing.assert_allclose(total, 1.0, rtol=1e-5)

    def test_weight_norm(self):
        x = R(2, 4)

        def case(P):
            pt.seed(0)
            lin = P.nn.Linear(4, 3)
            if P is pt:
                case.w = state_of(lin)
            else:
                lin.set_state_dict(case.w)
            P.nn.utils.weight_norm(lin, dim=1)
            y = lin(P.to_tensor(x))
            y.sum().backward()
            names = [n for n, _ in lin.named_parameters()]
            grads = [lin.weight_g.grad, lin.weight_v.grad]
            P.nn.utils.remove_weight_norm(lin)
            return y, names, grads, "weight" in dict(lin.named_parameters())
        got = both(case, TOL)
        assert got[3] is True and "weight_g" in got[1]

    def test_spectral_norm_and_vector_round_trip(self):
        lin = paddle.nn.Linear(5, 4)
        w = lin.weight.numpy()
        paddle.nn.utils.spectral_norm(lin, n_power_iterations=30)
        sigma = np.linalg.svd(w, compute_uv=False)[0]
        y = lin(paddle.to_tensor(np.eye(5, dtype="f4")))
        np.testing.assert_allclose(y.numpy() - lin.bias.numpy(),
                                   w / sigma, rtol=1e-4, atol=1e-5)
        params = lin.parameters()
        vec = paddle.nn.utils.parameters_to_vector(params)
        assert vec.shape == [sum(p.size for p in params)]
        paddle.nn.utils.vector_to_parameters(vec * 0 + 1, params)
        assert all(np.all(p.numpy() == 1) for p in params)

    def test_clip_grad_norm_and_value(self):
        def case(P):
            ps = [P.Parameter(np.full((3,), 3.0, "f4")),
                  P.Parameter(np.full((4,), 4.0, "f4"))]
            ((ps[0] * ps[0]).sum() + (ps[1] * ps[1]).sum()).backward()
            total = P.nn.utils.clip_grad_norm_(ps, 1.0)
            g = [p.grad.numpy().copy() for p in ps]
            P.nn.utils.clip_grad_value_(ps, 0.1)
            return total, g, [p.grad for p in ps]
        both(case, TOL)


@pytest.mark.parametrize("name", [n for n in sorted(LAYERS)
                                  if n < TWIN_SPLIT])
def test_layer_twin(name):
    """The cases before ``TWIN_SPLIT`` in name order; the others are in
    ``test_torch_nn_layer_twins.py``."""
    make, inputs, *rest = LAYERS[name]
    twin(make, inputs, train=rest[0] if rest else True)


def test_every_ported_layer_class_has_a_twin():
    """Each class of the ported layer modules is built by a case (or is
    a base class: ``Layer``, ``RNNCellBase``)."""
    from paddle_tpu_torch.nn import layer as L

    built = set()
    for make, *_ in CASES.values():
        layer = make(paddle)
        built.update(type(l).__name__ for l in layer.sublayers(True))
    names = set()
    for mod in (L.common, L.activation, L.container, L.conv, L.norm,
                L.loss, L.pooling, L.rnn, L.transformer, L.extended):
        names.update(mod.__all__)
    # not Layers: beam search has its twin in test_torch_nn_extended.py
    names -= {"RNNCellBase", "BeamSearchDecoder", "dynamic_decode"}
    assert not names - built, names - built


def test_dropouts_and_rrelu_in_training():
    """Keep rate and scaling of each training-mode draw on the port (the
    two packages' generators differ)."""
    nn = paddle.nn
    x = paddle.to_tensor(np.ones((200, 50), "f4"))
    y = nn.Dropout(0.25)(x).numpy()
    assert abs((y != 0).mean() - 0.75) < 0.02
    assert set(np.unique(y)) <= {0.0, np.float32(1 / 0.75)}
    y = nn.Dropout(0.25, mode="downscale_in_infer")(x).numpy()
    assert set(np.unique(y)) <= {0.0, 1.0}
    x4 = paddle.to_tensor(np.ones((40, 30, 3, 3), "f4"))
    y = nn.Dropout2D(0.5)(x4).numpy()
    assert np.all(y.reshape(40, 30, 9).std(-1) == 0)
    y = nn.Dropout3D(0.5)(paddle.to_tensor(np.ones((20, 10, 2, 2, 2),
                                                   "f4"))).numpy()
    assert np.all(y.reshape(20, 10, 8).std(-1) == 0)
    z = paddle.to_tensor(R(400, 100))
    y = nn.AlphaDropout(0.2)(z).numpy()
    assert abs(y.mean() - z.numpy().mean()) < 0.05
    assert abs(y.std() - z.numpy().std()) < 0.05
    neg = nn.RReLU(0.1, 0.3)(paddle.to_tensor(-np.ones((1000,), "f4")))
    slopes = -neg.numpy()
    assert slopes.min() >= 0.1 and slopes.max() <= 0.3
    paddle.seed(5)
    a = nn.Dropout(0.5)(x).numpy()
    paddle.seed(5)
    np.testing.assert_array_equal(nn.Dropout(0.5)(x).numpy(), a)
