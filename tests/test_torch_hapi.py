"""``paddle_tpu_torch.hapi.Model`` and its callbacks against the JAX
package's, on the CPU, the JAX model's weights carried into the port's.

- ``Model.fit`` / ``evaluate`` / ``predict`` on ``bert_tiny``
  classification (dropout 0, AdamW, cross entropy, ``Accuracy``, a
  shuffled ``DataLoader`` whose batch order both packages draw alike):
  every step's loss and accuracy, the evaluation's logs and the
  predictions within 1e-5.
- The JAX ``tests/test_hapi.py`` MLP through both packages: fit with
  evaluation and ``ModelCheckpoint``, ``save``/``load`` resume,
  ``train_batch``, ``summary``, ``EarlyStopping``, ``ReduceLROnPlateau``
  (and its warning under a scheduler), the ``VisualDL`` and
  ``WandbCallback`` JSONL fallbacks, and the callback brackets of a
  standalone ``evaluate`` and ``predict``: losses within 1e-5, the same
  callbacks fired, the same files written.
- ``fit(sentinel=)`` on the JAX sentinel tests' regression net with a
  NaN batch: the skip, the logs and the journal as the JAX ``fit``'s; a
  rollback that restarts the epoch, a rollback mid-epoch that leaves the
  epoch unrecorded, and a cross-epoch rollback that replaces the epoch's
  marker, each with the same committed steps.
- ``fit(checkpoint_dir=, resume=True)`` after an epoch killed mid-way
  (with dropout 0.1, so the RNG state must come back) equals an
  uninterrupted fit bit for bit.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import models as jmodels
from paddle_tpu_torch import models
from torch_facade_common import on_cpu  # noqa: F401 (autouse)
from torch_nn_common import fresh_uids

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Side:
    def __init__(self, name):
        self.name = name
        self.P = importlib.import_module(name)
        self.io = importlib.import_module(f"{name}.io")
        self.hapi = importlib.import_module(f"{name}.hapi")
        self.cb = importlib.import_module(f"{name}.hapi.callbacks")
        self.metric = importlib.import_module(f"{name}.metric")
        self.faults = importlib.import_module(f"{name}.faults")
        self.ck = importlib.import_module(f"{name}.checkpoint")
        self.port = name == "paddle_tpu_torch"

    def mgr(self, d):
        kw = {"device": "cpu"} if self.port else {}
        return self.ck.CheckpointManager(d, **kw)


SIDES = (Side("paddle_tpu"), Side("paddle_tpu_torch"))


def _carry(jnet, tnet):
    missing, unexpected = tnet.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()})
    assert missing == [] and unexpected == []
    return tnet


def _toy(io, n=64, seed=0):
    class Toy(io.Dataset):
        def __init__(self):
            rng = np.random.default_rng(seed)
            self.y = (rng.random(n) > 0.5).astype("int64")
            self.x = (rng.standard_normal((n, 8)).astype("float32")
                      + 3.0 * self.y[:, None].astype("float32"))

        def __len__(self):
            return n

        def __getitem__(self, i):
            return self.x[i], self.y[i]
    return Toy()


class _Spy:
    """A callback recording each train step's logs and each hook."""

    def __new__(cls, side):
        class Spy(side.cb.Callback):
            def __init__(self):
                super().__init__()
                self.steps, self.hooks = [], []

            def on_train_batch_end(self, step, logs=None):
                self.steps.append({k: v for k, v in (logs or {}).items()})

            def on_epoch_end(self, epoch, logs=None):
                self.hooks.append(("epoch_end", epoch))

            def on_eval_end(self, logs=None):
                self.hooks.append(("eval_end", sorted(logs or {})))

            def on_predict_begin(self, logs=None):
                self.hooks.append("predict_begin")

            def on_predict_batch_end(self, step, logs=None):
                self.hooks.append(("predict_batch", step))

            def on_predict_end(self, logs=None):
                self.hooks.append("predict_end")
        return Spy()


def _mlp_models(lr=0.05):
    """The JAX test's MLP in both packages, the port carrying its
    weights: ``[(side, Model)]``."""
    out = []
    jnet = None
    for side in SIDES:
        side.P.seed(0)
        nn = side.P.nn
        net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))
        if jnet is None:
            jnet = net
        else:
            _carry(jnet, net)
        model = side.hapi.Model(net)
        opt = side.P.optimizer.Adam(learning_rate=lr,
                                    parameters=net.parameters())
        model.prepare(opt, nn.CrossEntropyLoss(), side.metric.Accuracy())
        out.append((side, model))
    return out


def _close_steps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k], np.float64),
                                       np.asarray(w[k], np.float64),
                                       rtol=TOL, atol=TOL, err_msg=k)


def test_mlp_fit_evaluate_predict_match(tmp_path):
    recs = []
    for side, model in _mlp_models():
        spy = _Spy(side)
        d = str(tmp_path / side.name)
        model.fit(_toy(side.io, 64, 0), _toy(side.io, 32, 1), batch_size=16,
                  epochs=3, verbose=0, save_dir=d, callbacks=[spy])
        logs = model.evaluate(_toy(side.io, 32, 1), batch_size=16, verbose=0)
        preds = model.predict(_toy(side.io, 32, 1), batch_size=16,
                              stack_outputs=True, verbose=0)
        out = model.train_batch(np.stack([_toy(side.io)[i][0]
                                          for i in range(4)]),
                                np.stack([_toy(side.io)[i][1]
                                          for i in range(4)]))
        recs.append((spy, logs, preds[0], sorted(os.listdir(d)), out,
                     model.summary()))
    (js, jl, jp, jf, jo, jsum), (ts, tl, tp, tf, to, tsum) = recs
    _close_steps(ts.steps, js.steps)
    assert ts.hooks == js.hooks
    _close_steps([tl], [jl])
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)
    assert tf == jf and "final.pdparams" in tf and "final.pdopt" in tf
    np.testing.assert_allclose(to, jo, rtol=TOL, atol=TOL)
    assert tsum == jsum == {"total_params": 178, "trainable_params": 178}
    assert tl["acc"] > 0.9


def test_save_load_resume_matches(tmp_path):
    preds = []
    for side, model in _mlp_models():
        model.fit(_toy(side.io), batch_size=16, epochs=2, verbose=0)
        path = str(tmp_path / side.name / "snap")
        model.save(path)
        fresh = [m for s, m in _mlp_models() if s.name == side.name][0]
        fresh.load(path)
        xs = [_toy(side.io, 8, 2)[i][0] for i in range(8)]
        a = model.predict(xs, batch_size=8, stack_outputs=True)[0]
        b = fresh.predict(xs, batch_size=8, stack_outputs=True)[0]
        np.testing.assert_array_equal(a, b)
        assert sorted(fresh._optimizer.state_dict()) == \
            sorted(model._optimizer.state_dict())
        preds.append(a)
    np.testing.assert_allclose(preds[1], preds[0], rtol=TOL, atol=TOL)


def test_early_stopping_and_reduce_lr_match():
    recs = []
    for side, model in _mlp_models():
        es = side.cb.EarlyStopping(monitor="loss", patience=0, verbose=0,
                                   save_best_model=False)
        rl = side.cb.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                       patience=1, min_delta=1e9, verbose=0)
        spy = _Spy(side)
        model.fit(_toy(side.io), _toy(side.io, 32, 1), batch_size=16,
                  epochs=50, verbose=0, callbacks=[es, rl, spy])
        recs.append((model.stop_training, spy.hooks,
                     model._optimizer.get_lr(), len(spy.steps)))
        with pytest.raises(ValueError):
            side.cb.ReduceLROnPlateau(factor=1.0)
        sched = [m for s, m in _mlp_models() if s.name == side.name][0]
        sched._optimizer._learning_rate = \
            side.P.optimizer.lr.StepDecay(0.01, step_size=10)
        cb2 = side.cb.ReduceLROnPlateau(monitor="loss", patience=0,
                                        min_delta=1e9, verbose=0)
        with pytest.warns(UserWarning, match="float learning rate"):
            sched.fit(_toy(side.io), _toy(side.io, 32, 1), batch_size=16,
                      epochs=2, verbose=0, callbacks=[cb2])
    assert recs[1] == recs[0] and recs[1][0] and recs[1][2] < 0.05


def test_telemetry_fallbacks_and_brackets_match(tmp_path):
    recs = []
    for side, model in _mlp_models():
        d = tmp_path / side.name
        model.fit(_toy(side.io, 32, 0), _toy(side.io, 16, 1), batch_size=16,
                  epochs=2, verbose=0,
                  callbacks=[side.cb.VisualDL(str(d / "vdl")),
                             side.cb.WandbCallback(project="p", name="r1",
                                                   dir=str(d / "wb"))])
        model.evaluate(_toy(side.io, 16, 1), batch_size=8, verbose=0,
                       callbacks=[side.cb.VisualDL(str(d / "vdl_eval"))])
        spy = _Spy(side)
        model.predict(_toy(side.io, 16, 1), batch_size=8, verbose=0,
                      callbacks=[spy])
        rows = {}
        for sub in ("vdl", "vdl_eval", "wb/wandb-offline/r1"):
            rows[sub] = [(r["tag"], r["step"], r["value"]) for r in map(
                json.loads, open(d / sub / "scalars.jsonl"))]
        cfg = json.load(open(d / "wb" / "wandb-offline" / "r1" /
                             "config.json"))
        cfg.pop("dir")
        recs.append((rows, cfg, spy.hooks))
    (jr, jc, jh), (tr, tc, th) = recs
    assert tc == jc and th == jh and th[0] == "predict_begin"
    for sub in jr:
        assert [r[:2] for r in tr[sub]] == [r[:2] for r in jr[sub]]
        np.testing.assert_allclose([r[2] for r in tr[sub]],
                                   [r[2] for r in jr[sub]], rtol=TOL,
                                   atol=TOL)
    assert any(t.startswith("eval/") for t, _, _ in tr["vdl"])
    assert paddle.callbacks.EarlyStopping is paddle.hapi.EarlyStopping


def _bert_models(dropout=0.0, seed=0):
    cfg = dict(hidden_dropout_prob=dropout, attention_dropout_prob=dropout,
               max_position_embeddings=64)
    pt.seed(seed)
    jnet = fresh_uids(jmodels.BertForSequenceClassification(
        jmodels.bert_tiny(**cfg), num_classes=2))
    tnet = models.BertForSequenceClassification(models.bert_tiny(**cfg),
                                                num_classes=2)
    _carry(jnet, tnet)
    return {"paddle_tpu": jnet, "paddle_tpu_torch": tnet}


def _rows(io, n=16, S=16, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (n, S)).astype("int64")
    y = rng.integers(0, 2, (n,)).astype("int64")

    class Rows(io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return ids[i], y[i]
    return Rows()


def test_bert_tiny_fit_evaluate_predict_match():
    nets = _bert_models()
    recs = []
    for side in SIDES:
        side.P.seed(11)
        net = nets[side.name]
        model = side.hapi.Model(net)
        model.prepare(side.P.optimizer.AdamW(learning_rate=1e-3,
                                             parameters=net.parameters()),
                      side.P.nn.CrossEntropyLoss(), side.metric.Accuracy())
        spy = _Spy(side)
        loader = side.io.DataLoader(_rows(side.io), batch_size=4,
                                    shuffle=True)
        model.fit(loader, epochs=2, verbose=0, callbacks=[spy])
        logs = model.evaluate(_rows(side.io, 8, seed=6), batch_size=4,
                              verbose=0)
        preds = model.predict(_rows(side.io, 8, seed=6), batch_size=4,
                              stack_outputs=True, verbose=0)
        recs.append((spy.steps, logs, preds[0]))
    (js, jl, jp), (ts, tl, tp) = recs
    assert len(ts) == 8
    _close_steps(ts, js)
    _close_steps([tl], [jl])
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)


def _reg_models():
    """The JAX sentinel tests' regression net in both packages."""
    out = []
    jnet = None
    for side in SIDES:
        side.P.seed(0)
        net = side.P.nn.Linear(3, 1)
        if jnet is None:
            jnet = net
        else:
            _carry(jnet, net)
        m = side.hapi.Model(net)
        m.prepare(side.P.optimizer.AdamW(learning_rate=0.05,
                                         parameters=net.parameters()),
                  side.P.nn.MSELoss())
        out.append((side, m))
    return out


def _reg_ds(io):
    class DS(io.Dataset):
        def __len__(self):
            return 32

        def __getitem__(self, i):
            x = np.float32([i / 32.0, 1.0 - i / 32.0, (i % 5) / 5.0])
            return x, np.float32([x @ np.float32([0.5, -0.25, 1.0])])
    return DS()


def _nan_weight_grad(side, net):
    if side.port:
        return lambda: net.weight._value.grad.fill_(float("nan"))

    import jax.numpy as jnp
    from paddle_tpu.tensor import Tensor

    def poison():
        net.weight.grad = Tensor(jnp.full_like(net.weight.grad._value,
                                               jnp.nan))
    return poison


@pytest.mark.parametrize("case", [
    ("skip", dict(skip_limit=5, healthy_window=2), 3, 1, dict(epochs=1)),
    ("rollback_restarts_epoch", dict(skip_limit=0, healthy_window=2), 3, 1,
     dict(epochs=2, ckpt=True)),
    ("rollback_mid_epoch_unrecorded", dict(skip_limit=0, healthy_window=2),
     3, 1, dict(epochs=2, ckpt=True, num_iters=4)),
    ("cross_epoch_rollback", dict(skip_limit=1, healthy_window=2,
                                  min_history=4), 5, 4,
     dict(epochs=3, ckpt=True)),
], ids=lambda c: c[0])
def test_fit_with_a_sentinel_matches(tmp_path, case):
    _name, cfg, after, times, kw = case
    recs = []
    for side, model in _reg_models():
        s = side.faults.TrainSentinel(**cfg)
        spy = _Spy(side)
        d = str(tmp_path / side.name / "ck")
        extra = {"checkpoint_dir": d} if kw.get("ckpt") else {}
        if "num_iters" in kw:
            extra["num_iters"] = kw["num_iters"]
        abort = None
        try:
            with side.faults.inject(
                    "train.grads", call=_nan_weight_grad(side, model.network),
                    after=after, times=times):
                model.fit(_reg_ds(side.io), batch_size=4,
                          epochs=kw["epochs"], verbose=0, sentinel=s,
                          callbacks=[spy], **extra)
        except side.faults.SentinelAbort as e:
            abort = e.reason
        finally:
            side.faults.reset()
        steps = side.mgr(d).all_steps() if kw.get("ckpt") else None
        recs.append((spy.steps, s.journal(), s.rollbacks,
                     s.skipped_batches, steps, abort))
    (js, jj, jr, jk, jst, ja), (ts, tj, tr, tk, tst, ta) = recs
    _close_steps(ts, js)
    assert (tr, tk, tst, ta) == (jr, jk, jst, ja)
    assert [{k: v for k, v in e.items() if k not in ("loss", "grad_norm")}
            for e in tj] == \
        [{k: v for k, v in e.items() if k not in ("loss", "grad_norm")}
         for e in jj]
    assert tk >= 1


class _Killed(Exception):
    pass


def _fit_once(tmp_path, kill_at=None):
    """bert_tiny at dropout 0.1 through ``fit(checkpoint_dir=)``: a
    callback raises at ``kill_at = (epoch, step)`` (the process dying
    mid-epoch, no cleanup). Returns the model, optimizer and losses."""
    side = SIDES[1]
    net = _bert_models(dropout=0.1, seed=2)["paddle_tpu_torch"]
    paddle.seed(3)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters())
    model = side.hapi.Model(net)
    model.prepare(opt, paddle.nn.CrossEntropyLoss(), side.metric.Accuracy())
    losses = []

    class Rec(side.cb.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch

        def on_train_batch_end(self, step, logs=None):
            losses.append((self.epoch, step, logs["loss"]))
            if (self.epoch, step) == kill_at:
                raise _Killed()
    loader = side.io.DataLoader(_rows(side.io), batch_size=4, shuffle=True)
    try:
        model.fit(loader, epochs=2, verbose=0, callbacks=[Rec()],
                  checkpoint_dir=str(tmp_path),
                  sentinel=side.faults.TrainSentinel())
    except _Killed:
        pass
    return net, opt, losses, model


def test_fit_resumes_after_a_killed_epoch_bit_for_bit(tmp_path):
    ref_net, ref_opt, ref_losses, ref_model = _fit_once(tmp_path / "ref")
    _n, _o, killed, _m = _fit_once(tmp_path / "run", kill_at=(1, 1))
    assert killed[-1][:2] == (1, 1)
    assert SIDES[1].mgr(str(tmp_path / "run")).all_steps() == [0]
    net, opt, resumed, model = _fit_once(tmp_path / "run")
    assert [x for x in ref_losses if x[0] == 1] == resumed
    for k, v in ref_net.state_dict().items():
        assert torch.equal(net.state_dict()[k]._value, v._value), k
    for k, v in ref_opt.state_dict().items():
        if hasattr(v, "shape"):
            assert torch.equal(opt.state_dict()[k], v), k
    assert model._metrics[0].accumulate() == \
        ref_model._metrics[0].accumulate()


def test_prepare_amp_configs_runs_under_auto_cast():
    """``prepare(amp_configs=)`` opens ``amp.auto_cast`` around every
    batch's forward (train, eval, predict), as the reference Model does;
    the JAX Model ignores it (ROADMAP Queue 3). None turns it off."""
    from paddle_tpu_torch import amp

    seen = []

    class Probe(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = paddle.nn.Linear(4, 2)

        def forward(self, x):
            st = amp.current_state()
            seen.append(None if st is None else (st.level, str(st.dtype)))
            return self.fc(x)
    net = Probe()
    model = paddle.Model(net)
    opt = paddle.optimizer.SGD(parameters=net.parameters())
    x, y = np.ones((2, 4), np.float32), np.zeros((2,), np.int64)
    model.prepare(opt, paddle.nn.CrossEntropyLoss(),
                  amp_configs={"level": "O1", "dtype": "bfloat16"})
    model.train_batch([x], [y])
    model.eval_batch([x], [y])
    model.predict_batch([x])
    model.prepare(opt, paddle.nn.CrossEntropyLoss(), amp_configs="O2")
    model.train_batch([x], [y])
    model.prepare(opt, paddle.nn.CrossEntropyLoss())
    model.train_batch([x], [y])
    assert seen == [("O1", "torch.bfloat16")] * 3 + [
        ("O2", "torch.bfloat16"), None]
