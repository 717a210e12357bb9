"""``paddle_tpu_torch.faults.TrainSentinel`` against the JAX package's, on
the CPU. The detectors and the escalation ladder are pure Python in both
packages, so they are held exactly: each case below runs once per
package (each with its own regression net, loader and manager) and the
verdicts, journals, ``state_dict`` payloads, rollback infos, exceptions
and counter deltas (each from its package's registry) must be equal.

- The detectors on synthetic series (non-finite loss and grad, loss and
  grad spikes, a plateau, EWMA divergence with positive and negative
  losses, a spike not entering the baseline) and the config checks.
- The ladder: skip then rollback with exact counters, skipping with no
  mark then aborting, region rollbacks re-ramping the LR then aborting,
  the re-ramp back to the base LR, the widened skip, a persistence round
  trip mid-incident through a real checkpoint, a restore-then-bind that
  re-acquires the mark, a fallback from a corrupt mark re-keyed on the
  step actually restored, and ``bind`` pruning marks ahead of a resumed
  timeline.

What the port has to show beyond that:

- a guarded skip and rollback on ``bert_tiny`` with dropout 0.1 end
  bit-identical to a clean replay (``tools/train_chaos.py``'s
  ``guard-skip-rollback`` drill at its small size);
- an in-memory mark survives in-place optimizer steps (it clones every
  cell) and rollback truly rewinds;
- ``_grad_health`` makes one host copy and no ``.item()``;
- a sentinel skip goes through ``_found_inf`` (a bool on the device)
  without moving the AMP skip counter, and changes no state.
"""
import importlib
import json
import math
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.faults import sentinel as tsentinel
from torch_facade_common import on_cpu  # noqa: F401 (autouse)

NAN = float("nan")


class Side:
    def __init__(self, name, root):
        self.P = importlib.import_module(name)
        self.io = importlib.import_module(f"{name}.io")
        self.ck = importlib.import_module(f"{name}.checkpoint")
        self.faults = importlib.import_module(f"{name}.faults")
        self.metrics = importlib.import_module(f"{name}.metrics")
        self.port = name == "paddle_tpu_torch"
        self.root = root / name

    def sentinel(self, *a, **kw):
        return self.faults.TrainSentinel(*a, **kw)

    def build(self, lr=0.05):
        self.P.seed(0)
        net = self.P.nn.Linear(3, 1)
        opt = self.P.optimizer.AdamW(learning_rate=lr,
                                     parameters=net.parameters())
        return net, opt

    def loader(self):
        io = self.io

        class DS(io.Dataset):
            def __len__(self):
                return 32

            def __getitem__(self, i):
                x = np.float32([i / 32.0, 1.0 - i / 32.0, (i % 5) / 5.0])
                return x, np.float32([x @ np.float32([0.5, -0.25, 1.0])])
        return io.DataLoader(DS(), batch_size=4)

    def mgr(self, name):
        kw = {"device": "cpu"} if self.port else {}
        return self.ck.CheckpointManager(str(self.root / name), **kw)

    def counters(self):
        reg = self.metrics.get_registry()
        out = {}
        for name in ("anomalies", "rollbacks", "skipped_batches",
                     "lr_reramps", "aborts"):
            fam = reg.get(f"paddle_tpu_train_{name}_total")
            out[name] = 0.0 if fam is None else (
                fam.sum_labels() if fam.label_names else fam.value)
        return out


def _both(tmp_path, drill):
    """Run ``drill(side)`` in both packages; the results and the
    counters' deltas must be equal."""
    out = []
    for name in ("paddle_tpu", "paddle_tpu_torch"):
        side = Side(name, tmp_path)
        side.faults.reset()
        c0 = side.counters()
        rec = drill(side)
        c1 = side.counters()
        out.append((rec, {k: c1[k] - c0[k] for k in c0}))
    assert out[1] == out[0]
    return out[1][0]


def _feed(s, series):
    """Observe each ``(loss, grad_norm, finite)``; apply OK/SKIP, roll
    back on ROLLBACK; an abort ends the run. Returns the record."""
    verdicts, infos, abort = [], [], None
    try:
        for loss, gnorm, finite in series:
            v = s.observe(loss, grad_norm=gnorm, grads_finite=finite)
            verdicts.append(v)
            if v == s.ROLLBACK:
                infos.append(s.rollback())
            else:
                s.after_update(v == s.OK)
    except Exception as e:  # noqa: BLE001 - compared across packages
        abort = (type(e).__name__, getattr(e, "reason", None))
    return {"verdicts": verdicts, "infos": infos, "abort": abort,
            "journal": s.journal(), "state": json.loads(
                s.state_dict()["json"]), "health": s.health(),
            "counts": (s.rollbacks, s.skipped_batches, s.aborts,
                       dict(s.anomalies))}


def _series(kind):
    ok = [(1.0 + 0.001 * ((i % 5) - 2), 1.0 + 0.01 * (i % 3), True)
          for i in range(12)]
    return {
        "nonfinite": [(NAN, None, True), (float("inf"), None, True),
                      (1.0, NAN, True), (1.0, 1.0, False)],
        "loss_spike": ok + [(50.0, 1.0, True)],
        "grad_spike": ok + [(1.0, 500.0, True)],
        "plateau": [(0.5 + 1e-4 * (i % 2), 0.01, True) for i in range(200)],
        "divergence": [(1.0 + 0.1 * i, None, True) for i in range(40)],
        "negative": [(-5.0, None, True)] * 50
        + [(-5.0 + 0.5 * i, None, True) for i in range(60)],
        "baseline": [(1.0, None, True)] * 10 + [(80.0, None, True),
                                                (1.0, None, True),
                                                (80.0, None, True)],
    }[kind]


_CONFIGS = {
    "nonfinite": dict(skip_limit=5),
    "loss_spike": dict(min_history=8, skip_limit=5),
    "grad_spike": dict(min_history=8, skip_limit=5),
    "plateau": dict(min_history=8),
    "divergence": dict(min_history=4, ewma_alpha=0.5, divergence_factor=1.5,
                       skip_limit=5),
    "negative": dict(min_history=4, ewma_alpha=0.5, divergence_factor=3.0,
                     skip_limit=5, z_threshold=1e9),
    "baseline": dict(min_history=8, skip_limit=5),
}


@pytest.mark.parametrize("kind", list(_CONFIGS))
def test_detectors_match(tmp_path, kind):
    rec = _both(tmp_path, lambda side: _feed(
        side.sentinel(**_CONFIGS[kind]), _series(kind)))
    if kind == "plateau":
        assert rec["journal"] == []
    else:
        assert rec["journal"]


def test_config_validation_matches(tmp_path):
    def drill(side):
        errs = []
        for bad in (dict(ewma_alpha=2.0), dict(divergence_factor=1.0),
                    dict(window=1), dict(reramp_factor=0.0),
                    dict(healthy_window=0), dict(widen_factor=0)):
            try:
                side.faults.SentinelConfig(**bad)
            except ValueError as e:
                errs.append(str(e))
        try:
            side.sentinel(side.faults.SentinelConfig(), skip_limit=1)
        except ValueError as e:
            errs.append(str(e))
        return errs
    assert len(_both(tmp_path, drill)) == 7


def _bound(side, cfg, manager=True, lr=0.05):
    net, opt = side.build(lr)
    loader = side.loader()
    s = side.sentinel(**cfg)
    s.bind(model=net, optimizer=opt, dataloader=loader,
           manager=side.mgr("marks") if manager else None)
    s.note_epoch(0)
    return s, net, opt, loader


@pytest.mark.parametrize("case", [
    ("skip_then_rollback", dict(skip_limit=2, healthy_window=2),
     [(NAN, None, True)] * 3),
    ("region_reramp_abort", dict(skip_limit=0, lr_reramp_after=2,
                                 abort_after_rollbacks=3),
     [(NAN, None, True)] * 4),
    ("widened_skip", dict(skip_limit=0, lr_reramp_after=2, widen_factor=2,
                          abort_after_rollbacks=10),
     [(NAN, None, True)] * 3),
    ("reramp_back", dict(skip_limit=0, lr_reramp_after=1, reramp_steps=4),
     [(NAN, None, True)] + [(0.5, None, True)] * 4),
    ("marks_then_incident", dict(skip_limit=1, healthy_window=2,
                                 mark_every=2),
     [(0.5, 0.1, True)] * 5 + [(NAN, 0.1, True)] * 2 + [(0.5, 0.1, True)]
     * 3 + [(1.0, NAN, True)] * 2),
], ids=lambda c: c[0])
def test_escalation_ladder_matches(tmp_path, case):
    _name, cfg, series = case

    def drill(side):
        s, _net, opt, loader = _bound(side, cfg)
        rec = _feed(s, series)
        rec["lr"] = opt.get_lr()
        rec["pending_skip"] = loader._resume_batches
        return rec
    rec = _both(tmp_path, drill)
    assert rec["infos"]


def test_no_mark_keeps_skipping_then_aborts(tmp_path):
    rec = _both(tmp_path, lambda side: _feed(
        side.sentinel(skip_limit=1, max_unrecoverable_skips=3),
        [(NAN, None, True)] * 5))
    assert rec["abort"] == ("SentinelAbort", "no_rollback_target")


def test_state_round_trip_mid_incident(tmp_path):
    def drill(side):
        s, net, opt, loader = _bound(side, dict(
            skip_limit=0, lr_reramp_after=10, abort_after_rollbacks=10))
        _feed(s, [(0.5, None, True)] * 6 + [(NAN, None, True)])
        state = side.ck.capture_train_state(model=net, optimizer=opt,
                                            dataloader=loader, sentinel=s)
        mgr2 = side.mgr("ckpt")
        mgr2.save(7, state)
        restored, _ = mgr2.restore(7)
        s2 = side.sentinel(skip_limit=0, lr_reramp_after=10,
                           abort_after_rollbacks=10)
        s2.bind(manager=side.mgr("marks"), prune_future=False)
        side.ck.restore_train_state(restored, sentinel=s2)
        same = s2.journal() == s.journal()
        rec = _feed(s2, [(NAN, None, True)])
        return same, rec
    same, rec = _both(tmp_path, drill)
    assert same and rec["infos"][0]["region_rollbacks"] == 2


def test_restore_then_bind_reacquires_the_mark(tmp_path):
    def drill(side):
        s, net, opt, loader = _bound(side, dict(skip_limit=0))
        _feed(s, [(0.5, None, True)] * 3)
        s.observe(NAN)
        saved = s.state_dict()
        s2 = side.sentinel(skip_limit=0)
        s2.set_state_dict(saved)
        s2.bind(model=net, optimizer=opt, dataloader=loader,
                manager=side.mgr("marks"))
        return _feed(s2, [(NAN, None, True)])
    assert _both(tmp_path, drill)["infos"][0]["step"] == 0


def test_rollback_fallback_rekeys_on_the_actual_step(tmp_path):
    def drill(side):
        s, net, opt, loader = _bound(side, dict(skip_limit=0,
                                                healthy_window=2,
                                                mark_every=2))
        _feed(s, [(0.5, None, True)] * 4)
        mgr = s._manager
        steps = mgr.all_steps()
        victim = os.path.join(mgr.step_path(4), "model__weight.p0.s0.npy")
        with open(victim, "r+b") as fh:
            fh.seek(-1, os.SEEK_END)
            last = fh.read(1)
            fh.seek(-1, os.SEEK_END)
            fh.write(bytes([last[0] ^ 0xFF]))
        rec = _feed(s, [(NAN, None, True)])
        return steps, rec, s.global_step, s._region_step
    steps, rec, at, region = _both(tmp_path, drill)
    assert steps == [0, 2, 4] and at == region == 2
    assert rec["infos"][0]["skipped"] == 3
    assert rec["journal"][-1]["fallback_from"] == 4


def test_bind_prunes_marks_ahead_of_a_resumed_timeline(tmp_path):
    def drill(side):
        s, net, opt, _loader = _bound(side, dict(healthy_window=1,
                                                 mark_every=1))
        _feed(s, [(0.5, None, True)] * 3)
        before = s._manager.all_steps()
        s2 = side.sentinel()
        s2.global_step = 1
        s2.bind(model=net, optimizer=opt, manager=s._manager)
        return before, s._manager.all_steps()
    assert _both(tmp_path, drill) == ([0, 1, 2, 3], [0, 1])


# ───────────────────────────── the port alone ─────────────────────────────


def test_guarded_skip_and_rollback_on_bert_tiny_equal_a_clean_replay(
        tmp_path):
    from paddle_tpu_torch.tools import train_chaos

    torch.set_num_threads(2)
    logs = []
    rec = train_chaos.drill_guard_skip_rollback(
        torch.device("cpu"), True, str(tmp_path), logs.append)
    assert rec["actions"][2] == "skip" and "rollback" in rec["actions"]
    assert rec["forward_only"] and rec["tensors_compared"] > 100
    assert rec["state_bytes"] > 0 and rec["verify_ok"]


def test_an_in_memory_mark_survives_in_place_steps(tmp_path):
    side = Side("paddle_tpu_torch", tmp_path)
    net, opt = side.build()
    loader = side.loader()
    s = side.sentinel(skip_limit=0, healthy_window=2, mark_every=100)
    s.bind(model=net, optimizer=opt, dataloader=loader)
    s.note_epoch(0)
    opt._materialize_accumulators()
    marked = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    mark_state = s._mark["state"]
    assert mark_state["model"]["weight"]._value.data_ptr() != \
        net.weight._value.data_ptr()
    lossf = paddle.nn.MSELoss()
    guarded = s.guard(lambda x, y: lossf(net(x), y), optimizer=opt)
    it = iter(loader)
    for _ in range(4):
        guarded(*next(it))
    assert not np.array_equal(net.weight.numpy(), marked["weight"])
    moments = {k: v.clone() for k, v in
               mark_state["optimizer"].items() if hasattr(v, "shape")}

    def poison():
        net.weight._value.grad.fill_(NAN)
    with side.faults.inject("train.grads", call=poison, times=1):
        rep = guarded(*next(it))
    side.faults.reset()
    assert rep.rolled_back and rep.info["step"] == 0
    for k, v in marked.items():
        np.testing.assert_array_equal(net.state_dict()[k].numpy(), v)
    for k, v in opt.state_dict().items():
        if k in moments:
            assert torch.equal(v, getattr(moments[k], "_value",
                                          moments[k])), k


def test_grad_health_is_one_host_copy(monkeypatch):
    paddle.seed(0)
    net = paddle.nn.Linear(8, 4)
    opt = paddle.optimizer.AdamW(parameters=net.parameters())
    loss = net(paddle.to_tensor(np.ones((2, 8), np.float32))).sum()
    loss.backward()
    grads = [p._value.grad.double() for p in net.parameters()]
    calls = {"cpu": 0, "item": 0}
    cpu, item = torch.Tensor.cpu, torch.Tensor.item

    def count_cpu(self, *a, **k):
        calls["cpu"] += 1
        return cpu(self, *a, **k)

    def count_item(self, *a, **k):
        calls["item"] += 1
        return item(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", count_cpu)
    monkeypatch.setattr(torch.Tensor, "item", count_item)
    lv, gnorm, finite = tsentinel._grad_health(loss, opt)
    monkeypatch.undo()
    assert calls == {"cpu": 1, "item": 0}
    want = math.sqrt(sum(float((g * g).sum()) for g in grads))
    assert finite and abs(gnorm - want) < 1e-5 * want
    assert lv == float(loss._value.detach())
    net.weight._value.grad.fill_(NAN)
    assert tsentinel._grad_health(loss, opt)[2] is False


def test_a_sentinel_skip_is_not_an_amp_skip():
    from paddle_tpu_torch import metrics

    paddle.seed(0)
    net = paddle.nn.Linear(3, 2)
    opt = paddle.optimizer.AdamW(parameters=net.parameters())
    net(paddle.to_tensor(np.ones((2, 3), np.float32))).sum().backward()
    opt.step()
    net(paddle.to_tensor(np.ones((2, 3), np.float32))).sum().backward()
    before = {k: v.clone() for k, v in opt.state_dict().items()
              if hasattr(v, "shape")}
    w = net.weight.numpy().copy()
    fam = metrics.get_registry().get("paddle_tpu_amp_skipped_steps_total")
    amp0 = 0.0 if fam is None else fam.value
    tsentinel._suppress_update(opt)
    fam = metrics.get_registry().get("paddle_tpu_amp_skipped_steps_total")
    assert (0.0 if fam is None else fam.value) == amp0
    np.testing.assert_array_equal(net.weight.numpy(), w)
    for k, v in opt.state_dict().items():
        if k in before:
            assert torch.equal(v, before[k]), k
    assert opt._found_inf is None and opt._found_inf_origin == "amp"
