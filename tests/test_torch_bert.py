"""The port's BERT (a Paddle ``Layer`` model) against the JAX package's,
on the CPU, at ``bert_tiny`` (hidden 128, 2 layers, 4 heads of 32, vocab
512, no dropout), with the JAX model's ``state_dict`` carried by
``models.load_reference_state_dict``.

- ``BertModel``'s sequence and pooled outputs at f32 1e-5, without and
  with an ``attention_mask`` whose second row is padded (the port sends
  that key-padding mask to flash attention's plain version, the JAX
  package to its dense ``_sdpa_ref``).
- ``BertForPretraining``'s loss (MLM with ignored positions, NSP), then
  3 AdamW steps in each package (the root bench's ``train_fn``): losses
  and every parameter within 1e-5 (the key projections' biases, whose
  grads are round-off that Adam normalises, within 1e-4), with and
  without the mask.
- The same 3 steps through the port's ``jit.StaticFunction`` (on the CPU
  each call runs eagerly, with the signature cache and seed tape) equal
  the eager port run bit for bit; a Layer's ``training`` flags join the
  signature.
- The cases of ``tests/test_bert.py``, each through both packages.

The JAX model's encoder layers are deep copies of its first, whose cells
share the first's tape ids; each is given its own
(``torch_nn_common.fresh_uids``) so that the JAX model trains every
layer, as its code means to.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import models as jmodels
from paddle_tpu_torch import amp, jit, models
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import fresh_uids

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(cls="BertForPretraining", seed=0, **cfg):
    """The JAX model from ``pt.seed(seed)`` (its encoder layers' cells
    each with a tape id of its own: ``torch_nn_common.fresh_uids``) and
    the port's with its weights."""
    pt.seed(seed)
    jm = fresh_uids(getattr(jmodels, cls)(jmodels.bert_tiny(**cfg)))
    tm = getattr(models, cls)(models.bert_tiny(**cfg))
    models.load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _data(B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (B, S))
    mask = np.ones((B, S), np.int64)
    mask[1, S - 5:] = 0
    mlm = np.full((B, S), -100)
    mlm[:, 3] = 7
    mlm[1, 6] = ids[1, 6]
    return ids, mask, mlm, rng.integers(0, 2, (B,))


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def test_state_dict_names_and_shapes_match():
    jm, tm = _pair()
    js, ts = jm.state_dict(), tm.state_dict()
    assert list(js) == list(ts)
    assert all(list(js[k].shape) == ts[k].shape for k in js)
    with pytest.raises(KeyError):
        models.load_reference_state_dict(tm, {})
    with pytest.raises(ValueError):
        models.load_reference_state_dict(
            tm, dict(js, **{"bert.pooler.weight": np.zeros(3)}))


@pytest.mark.parametrize("masked", [False, True])
def test_bert_model_outputs(masked):
    jm, tm = _pair("BertModel")
    ids, mask, _, _ = _data()
    outs = []
    for P, m in ((pt, jm), (paddle, tm)):
        kw = {"attention_mask": P.to_tensor(mask)} if masked else {}
        seq, pooled = m(P.to_tensor(ids), **kw)
        outs.append((_np(seq), _np(pooled)))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def _train(P, amp_, m, opt, ids, mask, mlm, nsp, steps, step_fn=None):
    def train_fn(i, ml, ns, am):
        with amp_.auto_cast(enable=False):
            _, loss = m(i, attention_mask=am, masked_lm_labels=ml,
                        next_sentence_labels=ns)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = step_fn(train_fn) if step_fn else train_fn
    args = [P.to_tensor(a) for a in (ids, mlm, nsp)] + [
        None if mask is None else P.to_tensor(mask)]
    return [float(_np(step(*args))) for _ in range(steps)]


@pytest.mark.parametrize("masked", [False, True])
def test_pretraining_loss_and_three_adamw_steps(masked):
    jm, tm = _pair()
    ids, mask, mlm, nsp = _data()
    mask = mask if masked else None
    jo = pt.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    to = paddle.optimizer.AdamW(learning_rate=1e-3,
                                parameters=tm.parameters())
    from paddle_tpu import amp as jamp

    jl = _train(pt, jamp, jm, jo, ids, mask, mlm, nsp, 3)
    tl = _train(paddle, amp, tm, to, ids, mask, mlm, nsp, 3)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert tl[-1] < tl[0]
    for (n, jp), (_, tp) in zip(jm.named_parameters(),
                                tm.named_parameters()):
        # the key bias's grad is zero but for round-off (a softmax row is
        # invariant to the constant it adds), and Adam divides that
        # round-off by its own root mean square: its steps are noise of
        # up to lr, held at 10 * TOL
        tol = 10 * TOL if n.endswith("k_proj.bias") else TOL
        np.testing.assert_allclose(_np(tp), _np(jp), rtol=TOL, atol=tol,
                                   err_msg=n)


def test_static_function_equals_eager_bit_for_bit():
    ids, mask, mlm, nsp = _data()
    runs = []
    for graphed in (False, True):
        _, tm = _pair()
        to = paddle.optimizer.AdamW(learning_rate=1e-3,
                                    parameters=tm.parameters())
        holder = {}

        def wrap(fn):
            holder["sf"] = jit.StaticFunction(fn, observe=[tm, to],
                                              warmup=False)
            return holder["sf"]
        losses = _train(paddle, amp, tm, to, ids, mask, mlm, nsp, 3,
                        wrap if graphed else None)
        runs.append((losses, [_np(p) for p in tm.parameters()]))
        if graphed:
            sf = holder["sf"]
            assert sf.compile_counts() == {"signatures": 1, "captured": 1,
                                           "calls": 3}
            assert any(m is tm for m in sf._modules)
            tm.eval()
            _train(paddle, amp, tm, to, ids, mask, mlm, nsp, 1, lambda f: sf)
            assert sf.compile_counts()["signatures"] == 2
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)


def test_o2_decorate_keeps_norms_f32_and_trains():
    """``amp.decorate(level="O2")`` casts the Layer's parameters to bf16
    in place, norms excepted, as the JAX package's does; the bench's
    step trains under it."""
    jm, tm = _pair()
    ids, _, mlm, nsp = _data()
    cells = [p._value for p in tm.parameters()]
    to = paddle.optimizer.AdamW(learning_rate=1e-3,
                                parameters=tm.parameters())
    from paddle_tpu import amp as jamp

    jm = jamp.decorate(jm, level="O2", dtype="bfloat16")
    tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16")
    jd = {n: str(p.dtype).split(".")[-1] for n, p in jm.named_parameters()}
    td = {n: str(p.dtype).split(".")[-1] for n, p in tm.named_parameters()}
    assert jd == td and td["bert.encoder.layers.0.norm1.weight"] == \
        "float32" and td["transform.weight"] == "bfloat16"
    assert all(p._value is c for p, c in zip(tm.parameters(), cells))
    from paddle_tpu_torch import bench

    step = bench.make_bert_train_fn(tm, to)
    losses = [float(_np(step(*(paddle.to_tensor(a)
                                for a in (ids, mlm, nsp)))))
              for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ------------------------------------------------------- test_bert.py twins
def test_bert_model_shapes_and_pooled():
    jm, tm = _pair("BertModel")
    ids = np.random.default_rng(0).integers(0, 512, (2, 24))
    for P, m in ((pt, jm), (paddle, tm)):
        seq, pooled = m(P.to_tensor(ids))
        assert tuple(seq.shape) == (2, 24, 128)
        assert tuple(pooled.shape) == (2, 128)
        assert np.all(np.abs(_np(pooled)) <= 1.0)


def test_attention_mask_blocks_padding():
    jm, tm = _pair("BertModel", seed=1)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 512, (1, 16))
    ids2 = ids.copy()
    ids2[0, 8:] = rng.integers(1, 512, 8)
    mask = np.zeros((1, 16), np.int64)
    mask[0, :8] = 1
    got = []
    for P, m in ((pt, jm), (paddle, tm)):
        m.eval()
        o1, _ = m(P.to_tensor(ids), attention_mask=P.to_tensor(mask))
        o2, _ = m(P.to_tensor(ids2), attention_mask=P.to_tensor(mask))
        np.testing.assert_allclose(_np(o1)[0, :8], _np(o2)[0, :8],
                                   rtol=1e-4, atol=1e-5)
        got.append(_np(o1))
    np.testing.assert_allclose(got[1], got[0], rtol=TOL, atol=TOL)


def test_pretraining_loss_and_ignore_index():
    jm, tm = _pair(seed=2)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 512, (2, 16))
    mlm_labels = np.full((2, 16), -100, np.int64)
    mlm_labels[:, 3] = 7
    losses = []
    for P, m in ((pt, jm), (paddle, tm)):
        (mlm, nsp_logits), loss = m(
            P.to_tensor(ids), masked_lm_labels=P.to_tensor(mlm_labels),
            next_sentence_labels=P.to_tensor(np.array([0, 1], np.int64)))
        assert tuple(mlm.shape) == (2, 16, 512)
        assert tuple(nsp_logits.shape) == (2, 2)
        losses.append(float(_np(loss)))
    assert np.isfinite(losses[1])
    np.testing.assert_allclose(losses[1], losses[0], rtol=TOL, atol=TOL)


def test_mlm_head_tied_to_embeddings():
    for P, cls in ((pt, jmodels), (paddle, models)):
        P.seed(3)
        model = cls.BertForPretraining(cls.bert_tiny())
        if P is pt:
            fresh_uids(model)
        names = [n for n, _ in model.named_parameters()]
        assert not any("lm_head" in n or "decoder" in n for n in names)
        seq, _ = model.bert(P.to_tensor(np.zeros((1, 4), np.int64)))
        before = _np(model.mlm_logits(seq))
        w = model.bert.embeddings.word_embeddings.weight
        if P is pt:
            w._set_value(w._value * 2.0)
        else:
            with torch.no_grad():
                w._value.mul_(2.0)
        assert not np.allclose(before, _np(model.mlm_logits(seq)))


def test_sequence_classification_trains():
    """``tests/test_bert.py``'s fine-tune loop through the port's
    ``StaticFunction``: 30 steps on the parity rule, the loss halves, and
    the first 5 losses equal the JAX package's."""
    jm, tm = _pair("BertForSequenceClassification", seed=4)
    rng = np.random.default_rng(4)
    ids_np = rng.integers(0, 512, (8, 12))
    labels_np = (ids_np[:, 0] % 2).astype(np.int64)
    got = []
    for P, m, J in ((pt, jm, pt.jit), (paddle, tm, jit)):
        opt = P.optimizer.AdamW(learning_rate=1e-3,
                                parameters=m.parameters())

        def step(ids, labels, m=m, opt=opt):
            _, loss = m(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        sf = J.StaticFunction(step, observe=[m, opt], warmup=False)
        ids, labels = P.to_tensor(ids_np), P.to_tensor(labels_np)
        got.append([float(_np(sf(ids, labels))) for _ in range(30)])
    assert got[1][-1] < got[1][0] * 0.5, got[1][::10]
    np.testing.assert_allclose(got[1][:5], got[0][:5], rtol=1e-4, atol=1e-4)
