"""The training resilience stack's chaos drills.

    python -m paddle_tpu_torch.tools.train_chaos [--model regression]
        [--device cuda] [--scenarios a,b]
    python -m paddle_tpu_torch.tools.train_chaos --model bert_base
        [--device cuda] [--small] [--drills a,b]

Counterpart of the JAX package's ``tools/chaos_train.py``. With ``--model
regression`` (the JAX tool's ``Linear(3, 1)``, AdamW, MSE over a 32-row
dataset) it runs that tool's eight scenarios (``SCENARIOS``), each
asserting what its JAX counterpart asserts:

1. crash matrix: a fault at every save phase (shard write, fsync,
   manifest, COMMIT marker, publish rename; sync and async) leaves the
   previous committed step the loadable latest, bit for bit;
2. corruption: a flipped byte in the newest step is caught by its CRC32,
   the step quarantined, and restore falls back one step;
3. preemption: SIGTERM mid-run checkpoints through ``save_on_signal``; a
   fresh resume equals an uninterrupted 10-step run (params and moments
   bit for bit);
4. retention: GC keeps exactly ``max_to_keep`` committed steps;
5. telemetry: every failure path moved its counter;
6. sentinel skip: NaN gradients at one scheduled step are suppressed;
   params and moments bit-identical to a clean run without that batch;
7. sentinel rollback: a persistent NaN region rolls back to the last
   committed mark and skips past the quarantined window; bit-identical to
   a clean run on the healthy batches, ``paddle_tpu_jit_compiles_total``
   unmoved;
8. sentinel abort: anomalies surviving every rollback walk the ladder
   (skip, rollback, LR re-ramp and widened skip, abort), counters exact.

With ``--model bert_base`` it runs the same contracts at BERT-base's
full width (``bench.bert_setup``: hidden 768, 12 heads, B 32, S 128, O2
bf16 with master weights, dropout 0.1, AdamW) and its first
``CHAOS_LAYERS`` of 12 layers (``--small``: ``bert_tiny``
at B 4, for a rehearsal on the CPU), ``BERT_DRILLS``:

- ``fit-resume``: ``BertForSequenceClassification`` (2 labels) through
  ``hapi.Model.fit(epochs=2, checkpoint_dir=, sentinel=TrainSentinel())``
  over an ``io.DataLoader`` of 8 batches of seeded rows (256 at B 32),
  ``shuffle=True``. A child
  process runs the fit and is SIGKILLed mid-epoch 1, once epoch 0's step
  is committed; the same command run again resumes from that step. The
  final parameters, AdamW moments, epoch 1's losses and the accuracy
  equal an uninterrupted run's (another child) bit for bit.
- ``guard-skip-rollback``: ``BertForPretraining``, the bench's train step
  split as ``TrainSentinel.guard`` wants it, marks committed by a
  ``CheckpointManager`` (``max_to_keep=2``). NaN goes into the grads
  through the ``train.grads`` fault point at one scheduled call (the
  verdict must be SKIP), then through a persistent region (SKIP, then
  ROLLBACK to the committed mark and a skip past the quarantined
  window). Params and moments equal a clean run trained on the healthy
  batches only bit for bit (its forward runs on each batch the sentinel
  skipped outside a rollback window, under ``no_grad``, since that
  batch's forward drew its dropout seeds); ``paddle_tpu_jit_compiles_total``
  unmoved. It also times the checkpoint: the state's bytes, sync and
  async save seconds and GB/s, restore and verify seconds, the eager
  step while an async save drains against one without, and the guarded
  step against the unguarded one.
- ``preemption``: a child runs the guarded loop with ``save_on_signal``
  and gets SIGTERM mid-run (the child starts with SIGTERM blocked in
  every thread and unblocks it only between two steps, so the handler
  never sees half an update or a batch drawn and not trained on); a
  fresh child resumes through
  ``restore_or_init``. After 10 steps in all, params, moments and the
  dropout-bearing losses equal an uninterrupted child's bit for bit.

Every check that fails raises :class:`DrillFailed`; the exit code is 0
only when every scenario or drill passed. ``--device`` defaults to
``cuda`` (a card is needed unless ``--device cpu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import checkpoint as ck
from .. import faults, metrics
from ..device import resolve_device, using_device
from ..hapi.callbacks import Callback
from ..io import DataLoader, Dataset
from ..tensor import Tensor

__all__ = ["DrillFailed", "SCENARIOS", "BERT_DRILLS", "run_scenarios",
           "run_bert_drills", "main"]

SEED = int(os.environ.get("CHAOS_SEED", "0"))


class DrillFailed(AssertionError):
    """A train chaos check failed."""


def _check(cond, what):
    if not cond:
        raise DrillFailed(what)


def _counter(name, **labels):
    fam = metrics.get_registry().get(name)
    if fam is None:
        return 0.0
    if labels and set(labels) != set(fam.label_names):
        return fam.sum_labels(**labels)
    if not labels and fam.label_names:
        return fam.sum_labels()
    return (fam.labels(**labels) if labels else fam).value


def _on(t, device):
    """A batch Tensor (on the CPU, as the dataloader makes it) on
    ``device``."""
    return Tensor._wrap(t._value.to(device))


def _np(v) -> np.ndarray:
    return Tensor._wrap(getattr(v, "_value", v).detach()).numpy()


def params_of(net, opt) -> Dict[str, np.ndarray]:
    """Every parameter and optimizer tensor as host arrays (bf16 exact as
    f32)."""
    out = {f"net.{k}": _np(v) for k, v in net.state_dict().items()}
    for k, v in opt.state_dict().items():
        if hasattr(v, "shape"):
            out[f"opt.{k}"] = _np(v)
    return out


def digest_of(net, opt) -> Dict[str, str]:
    """sha256 of every parameter's and optimizer tensor's bytes, for a
    bit-for-bit comparison across processes."""
    out = {}
    for k, v in list(net.state_dict().items()) + [
            (f"opt.{k}", v) for k, v in opt.state_dict().items()
            if hasattr(v, "shape")]:
        t = getattr(v, "_value", v).detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[k] = hashlib.sha256(t.cpu().contiguous().numpy().tobytes()
                                ).hexdigest()
    return out


def _same(got: Dict, want: Dict) -> List[str]:
    return [k for k, v in want.items()
            if k not in got or not np.array_equal(got[k], v)]


# ───────────────────────────── regression model ─────────────────────────────


class _RegressionDS(Dataset):
    """The JAX tool's 32 rows: ``y = x . [0.5, -0.25, 1]``."""

    def __len__(self):
        return 32

    def __getitem__(self, i):
        x = np.float32([i / 32.0, 1.0 - i / 32.0, (i % 5) / 5.0])
        return x, np.float32([x @ np.float32([0.5, -0.25, 1.0])])


class _Regression:
    """The JAX tool's model, dataset and loop on ``device``."""

    def __init__(self, device):
        self.device = resolve_device(device)

    def loader(self, shuffle=True):
        return DataLoader(_RegressionDS(), batch_size=4, shuffle=shuffle)

    def build(self, seed=None):
        import paddle_tpu_torch as paddle
        from .. import nn

        paddle.seed(SEED if seed is None else seed)
        with using_device(self.device):
            net = nn.Linear(3, 1)
        opt = paddle.optimizer.AdamW(learning_rate=0.05,
                                     parameters=net.parameters())
        return net, opt, nn.MSELoss()

    def steps(self, net, opt, loss, loader, n, it=None):
        for _ in range(n):
            if it is None:
                it = iter(loader)
            try:
                x, y = next(it)
            except StopIteration:
                it = iter(loader)
                x, y = next(it)
            out = loss(net(_on(x, self.device)), _on(y, self.device))
            out.backward()
            opt.step()
            opt.clear_grad()
        return it

    def manager(self, path, **kw):
        return ck.CheckpointManager(path, device=self.device, **kw)


def state_of(net, opt, loader, step):
    return ck.capture_train_state(model=net, optimizer=opt,
                                  dataloader=loader, step=step)


PHASES = [
    ("shard write", "ckpt.write", {"times": 1}),
    ("fsync", "ckpt.fsync", {"times": 1}),
    ("manifest write", "ckpt.manifest", {"times": 1}),
    ("COMMIT marker", "ckpt.commit", {"times": 1}),
    ("commit rename", "ckpt.commit", {"times": 1, "after": 1}),
]


def scenario_crash_matrix(rg, root):
    mgr = rg.manager(os.path.join(root, "matrix"))
    net, opt, loss = rg.build()
    loader = rg.loader()
    rg.steps(net, opt, loss, loader, 3)
    golden = params_of(net, opt)
    mgr.save(0, state_of(net, opt, loader, 0))
    step = 1
    for mode in ("sync", "async"):
        for label, point, sched in PHASES:
            with faults.inject(point, raise_=faults.FaultInjected,
                               seed=SEED, **sched) as spec:
                try:
                    if mode == "async":
                        mgr.save(step, state_of(net, opt, loader, step),
                                 async_save=True).wait()
                    else:
                        mgr.save(step, state_of(net, opt, loader, step))
                    _check(False, f"{mode}/{label}: save survived the fault")
                except faults.FaultInjected:
                    pass
                _check(spec.fired == 1, f"{mode}/{label}: fault never fired")
            _check(mgr.latest_step() == 0,
                   f"{mode}/{label}: latest_step {mgr.latest_step()} != 0")
            res = mgr.restore_or_init()
            _check(res.restored and res.step == 0,
                   f"{mode}/{label}: restore_or_init missed step 0")
            n2, o2, _ = rg.build(seed=SEED + 1)
            ck.restore_train_state(res.state, model=n2, optimizer=o2)
            bad = _same(params_of(n2, o2), golden)
            _check(not bad, f"{mode}/{label}: restored {bad} not bit-exact")
    return f"{len(PHASES)} phases x sync+async, step 0 never lost"


def scenario_corruption(rg, root):
    mgr = rg.manager(os.path.join(root, "bitrot"))
    net, opt, loss = rg.build()
    loader = rg.loader()
    mgr.save(0, state_of(net, opt, loader, 0))
    golden = params_of(net, opt)
    rg.steps(net, opt, loss, loader, 2)
    mgr.save(1, state_of(net, opt, loader, 1))
    step_dir = mgr.step_path(1)
    victim = next(os.path.join(step_dir, f) for f in sorted(
        os.listdir(step_dir)) if f.endswith(".npy"))
    with open(victim, "r+b") as fh:
        fh.seek(-1, os.SEEK_END)
        last = fh.read(1)
        fh.seek(-1, os.SEEK_END)
        fh.write(bytes([last[0] ^ 0xFF]))
    c0 = _counter("paddle_tpu_ckpt_corrupt_total")
    f0 = _counter("paddle_tpu_ckpt_restore_fallback_total")
    res = mgr.restore_or_init()
    _check(res.step == 0, f"fallback step {res.step} != 0")
    n2, o2, _ = rg.build(seed=SEED + 1)
    ck.restore_train_state(res.state, model=n2, optimizer=o2)
    _check(not _same(params_of(n2, o2), golden),
           "fallback state not bit-exact")
    _check(mgr.latest_step() == 0, "corrupt step still visible")
    _check(_counter("paddle_tpu_ckpt_corrupt_total") == c0 + 1,
           "corrupt_total did not move")
    _check(_counter("paddle_tpu_ckpt_restore_fallback_total") == f0 + 1,
           "fallback counter did not move")
    return "CRC caught bit-rot, quarantined, fell back bit-exact"


def scenario_preemption(rg, root):
    net, opt, loss = rg.build()
    loader = rg.loader()
    rg.steps(net, opt, loss, loader, 10)
    golden = params_of(net, opt)
    mgr = rg.manager(os.path.join(root, "preempt"))
    net1, opt1, loss1 = rg.build()
    loader1 = rg.loader()
    rg.steps(net1, opt1, loss1, loader1, 5)
    scope = mgr.save_on_signal(
        lambda: (5, state_of(net1, opt1, loader1, 5)), exit_on_save=False)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        scope.uninstall()
    _check(mgr.preempted, "preemption flag not set")
    _check(mgr.latest_step() == 5, "signal handler did not commit step 5")
    net2, opt2, loss2 = rg.build(seed=SEED + 77)
    loader2 = rg.loader()
    res = mgr.restore_or_init()
    _check(res.restored and res.step == 5, "resume missed step 5")
    ck.restore_train_state(res.state, model=net2, optimizer=opt2,
                           dataloader=loader2)
    rg.steps(net2, opt2, loss2, loader2, 5)
    bad = _same(params_of(net2, opt2), golden)
    _check(not bad, f"resumed run diverged from uninterrupted: {bad}")
    return "SIGTERM checkpointed; resume = uninterrupted 10 steps bitwise"


def scenario_retention(rg, root):
    mgr = rg.manager(os.path.join(root, "gc"), max_to_keep=3)
    net, opt, loss = rg.build()
    loader = rg.loader()
    for s in range(7):
        rg.steps(net, opt, loss, loader, 1)
        mgr.save(s, state_of(net, opt, loader, s))
    _check(mgr.all_steps() == [4, 5, 6],
           f"retention kept {mgr.all_steps()}, wanted [4, 5, 6]")
    return "GC kept the last 3 of 7 committed steps"


def scenario_telemetry(rg, root):
    mgr = rg.manager(os.path.join(root, "telemetry"))
    net, opt, _loss = rg.build()
    loader = rg.loader()
    ok0 = _counter("paddle_tpu_ckpt_saves_total", result="committed")
    fail0 = _counter("paddle_tpu_ckpt_saves_total", result="failed")
    mgr.save(0, state_of(net, opt, loader, 0))
    with faults.inject("ckpt.write", raise_=faults.FaultInjected, times=1):
        try:
            mgr.save(1, state_of(net, opt, loader, 1))
        except faults.FaultInjected:
            pass
    _check(_counter("paddle_tpu_ckpt_saves_total",
                    result="committed") == ok0 + 1, "committed did not move")
    _check(_counter("paddle_tpu_ckpt_saves_total",
                    result="failed") == fail0 + 1, "failed did not move")
    gauge = metrics.get_registry().get("paddle_tpu_ckpt_last_committed_step")
    _check(gauge is not None and gauge.value == 0,
           "last_committed_step gauge wrong")
    hist = metrics.get_registry().get("paddle_tpu_ckpt_save_seconds")
    _check(hist is not None and hist.labels(mode="sync").count >= 1,
           "save histogram empty")
    return "saves_total{committed,failed}, gauge, histogram all moved"


def _nan_grads(param):
    """Fault-point callback: NaN into ``param``'s live gradient, in
    place (the seeded schedule on ``train.grads`` decides when)."""
    def poison():
        g = getattr(param, "_value", param).grad
        if g is not None:
            g.fill_(float("nan"))
    return poison


def _guarded_run(rg, sentinel, net, opt, loss, steps):
    loader = rg.loader(shuffle=False)
    sentinel.bind(model=net, optimizer=opt, dataloader=loader)
    sentinel.note_epoch(0)
    guarded = sentinel.guard(
        lambda x, y: loss(net(_on(x, rg.device)), _on(y, rg.device)),
        optimizer=opt)
    it, done = iter(loader), 0
    while done < steps:
        try:
            x, y = next(it)
        except StopIteration:
            it = iter(loader)
            continue
        if guarded(x, y).rolled_back:
            it = iter(loader)
        done += 1
    return loader


def excluded_from_journal(journal):
    """``(excluded, consumed)``: the ``(epoch, batch)`` pairs the sentinel
    kept out of the update, and those of them whose forward ran and was
    not rewound by a rollback (a skip outside every quarantine window)."""
    windows, skips = set(), set()
    for e in journal:
        if e["event"] == "rollback":
            d = e["data"]
            windows.update((d["epoch"], i) for i in
                           range(d["batch"], d["batch"] + e["skipped"]))
        elif e.get("action") == "skip":
            skips.add((e["data"]["epoch"], e["data"]["batch"] - 1))
    return windows | skips, skips - windows


def _clean_replay(rg, excluded, final):
    net, opt, loss = rg.build()
    loader = rg.loader(shuffle=False)
    it, ep, b = iter(loader), 0, 0
    while (ep, b) != (final["epoch"], final["batch"]):
        try:
            x, y = next(it)
        except StopIteration:
            it, ep, b = iter(loader), ep + 1, 0
            continue
        cur, b = (ep, b), b + 1
        if cur in excluded:
            continue
        out = loss(net(_on(x, rg.device)), _on(y, rg.device))
        out.backward()
        opt.step()
        opt.clear_grad()
    return net, opt


def scenario_sentinel_skip(rg, root):
    from ..faults import TrainSentinel

    net, opt, loss = rg.build()
    sent = TrainSentinel(skip_limit=2, healthy_window=2, min_history=4)
    a0 = _counter("paddle_tpu_train_anomalies_total", kind="nonfinite_grad")
    s0 = _counter("paddle_tpu_train_skipped_batches_total")
    with faults.inject("train.grads", call=_nan_grads(net.weight), seed=SEED,
                       after=5, times=1) as spec:
        loader = _guarded_run(rg, sent, net, opt, loss, steps=14)
    _check(spec.fired == 1, "NaN fault never fired")
    _check(sent.skipped_batches == 1 and sent.rollbacks == 0,
           f"wanted 1 skip, 0 rollbacks; got "
           f"{sent.skipped_batches}/{sent.rollbacks}")
    _check(_counter("paddle_tpu_train_anomalies_total",
                    kind="nonfinite_grad") == a0 + 1,
           "anomalies_total{nonfinite_grad} did not move exactly once")
    _check(_counter("paddle_tpu_train_skipped_batches_total") == s0 + 1,
           "skipped_batches_total did not move exactly once")
    excluded, _ = excluded_from_journal(sent.journal())
    _check(len(excluded) == 1, f"journal window wrong: {excluded}")
    n2, o2 = _clean_replay(rg, excluded, loader.state_dict())
    bad = _same(params_of(net, opt), params_of(n2, o2))
    _check(not bad, f"guarded run diverged from clean run: {bad}")
    return "1 NaN batch suppressed, counters exact, bit-identical to clean"


def scenario_sentinel_rollback(rg, root):
    from ..faults import TrainSentinel

    compiles0 = _counter("paddle_tpu_jit_compiles_total")
    net, opt, loss = rg.build()
    mgr = rg.manager(os.path.join(root, "marks"))
    sent = TrainSentinel(skip_limit=1, healthy_window=2, mark_every=2,
                         min_history=4)
    sent.bind(manager=mgr)
    r0 = _counter("paddle_tpu_train_rollbacks_total")
    with faults.inject("train.grads", call=_nan_grads(net.weight), seed=SEED,
                       after=5, times=3) as spec:
        loader = _guarded_run(rg, sent, net, opt, loss, steps=18)
    _check(spec.fired == 3, f"region fault fired {spec.fired} != 3")
    _check(sent.rollbacks == 1, f"wanted 1 rollback, got {sent.rollbacks}")
    _check(_counter("paddle_tpu_train_rollbacks_total") == r0 + 1,
           "rollbacks_total did not move exactly once")
    _check(sent.last_good_step is not None
           and sent.last_good_step in mgr.all_steps() + [sent.global_step],
           "last-known-good mark not committed")
    _check(_counter("paddle_tpu_jit_compiles_total") == compiles0,
           "guarding cost an extra step-program capture")
    excluded, _ = excluded_from_journal(sent.journal())
    _check(excluded, "journal recorded no quarantine window")
    n2, o2 = _clean_replay(rg, excluded, loader.state_dict())
    bad = _same(params_of(net, opt), params_of(n2, o2))
    _check(not bad, f"rolled-back run diverged from clean run: {bad}")
    return (f"restored the committed mark, skipped {sorted(excluded)}, "
            "bit-identical to the clean run, no capture")


def scenario_sentinel_abort(rg, root):
    from ..faults import SentinelAbort, TrainSentinel

    net, opt, loss = rg.build()
    sent = TrainSentinel(skip_limit=0, lr_reramp_after=2,
                         abort_after_rollbacks=2, healthy_window=2)
    a0 = _counter("paddle_tpu_train_anomalies_total", kind="nonfinite_grad")
    r0 = _counter("paddle_tpu_train_rollbacks_total")
    rr0 = _counter("paddle_tpu_train_lr_reramps_total")
    ab0 = _counter("paddle_tpu_train_aborts_total", reason="rollback_limit")
    aborted = False
    try:
        with faults.inject("train.grads", call=_nan_grads(net.weight),
                           seed=SEED, after=3):
            _guarded_run(rg, sent, net, opt, loss, steps=30)
    except SentinelAbort as exc:
        aborted = True
        _check(exc.reason == "rollback_limit",
               f"abort reason {exc.reason!r} != 'rollback_limit'")
        _check(exc.journal and exc.journal[-1]["event"] == "abort",
               "abort journal missing its terminal entry")
    _check(aborted, "escalation never reached abort")
    _check(sent.rollbacks == 2, f"rollbacks {sent.rollbacks} != 2")
    _check(_counter("paddle_tpu_train_anomalies_total",
                    kind="nonfinite_grad") == a0 + 3,
           "anomaly counter not exactly 3 (rollback, rollback, abort)")
    _check(_counter("paddle_tpu_train_rollbacks_total") == r0 + 2,
           "rollbacks_total not exactly 2")
    _check(_counter("paddle_tpu_train_lr_reramps_total") == rr0 + 1,
           "lr_reramps_total not exactly 1")
    _check(_counter("paddle_tpu_train_aborts_total",
                    reason="rollback_limit") == ab0 + 1,
           "aborts_total{rollback_limit} not exactly 1")
    _check(opt.get_lr() < 0.05, "LR re-ramp never reduced the LR")
    return "2 rollbacks + re-ramp + widened skip, then SentinelAbort"


SCENARIOS = [
    ("crash-matrix", scenario_crash_matrix),
    ("corruption", scenario_corruption),
    ("preemption", scenario_preemption),
    ("retention", scenario_retention),
    ("telemetry", scenario_telemetry),
    ("sentinel-skip", scenario_sentinel_skip),
    ("sentinel-rollback", scenario_sentinel_rollback),
    ("sentinel-abort", scenario_sentinel_abort),
]


def run_scenarios(device="cuda", names=None, log=print) -> int:
    """Run the regression scenarios (all by default) on ``device``;
    returns the number that failed."""
    rg = _Regression(device)
    failures = 0
    with tempfile.TemporaryDirectory() as root:
        for name, fn in SCENARIOS:
            if names is not None and name not in names:
                continue
            faults.reset()
            try:
                log(f"[train_chaos] {name}: {fn(rg, os.path.join(root, name))}")
            except Exception as exc:  # noqa: BLE001 - drill report
                failures += 1
                log(f"[train_chaos] {name}: FAIL {type(exc).__name__}: {exc}")
            finally:
                faults.reset()
    return failures


# ──────────────────────────────── BERT-base ────────────────────────────────

FIT_STEPS = 8   # a fit epoch's steps: 256 rows at B 32
# BERT-base's depth in the drills: widths and checks as at 12 layers, the
# depth cut so the smoke's run stays well inside its time limit
CHAOS_LAYERS = 2
FIT_LR = 5e-5
PRETRAIN_LR = 1e-4


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bert_shapes(small: bool):
    from .. import bench

    cfg, B, S, _steps = bench.bert_setup(small)
    if not small:
        cfg = dataclasses.replace(cfg, num_layers=CHAOS_LAYERS)
    return cfg, B, S


def _state_bytes(state) -> int:
    from ..distributed.checkpoint import _flatten

    return int(sum(getattr(v, "_value", v).numel()
                   * getattr(v, "_value", v).element_size()
                   for v in _flatten(state).values()
                   if isinstance(getattr(v, "_value", v), torch.Tensor)))


def need_disk(path: str, nbytes: int, what: str) -> None:
    """Fail (never skip) when ``path``'s file system has less room than
    ``nbytes``."""
    os.makedirs(path, exist_ok=True)
    free = shutil.disk_usage(path).free
    _check(free >= nbytes,
           f"{what}: needs {nbytes} bytes of disk under {path}, has {free}")


class _Rows(Dataset):
    """Seeded in-memory rows of int64 arrays."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)


def fit_data(cfg, B: int, S: int):
    """``FIT_STEPS`` batches of seeded rows: ids and a label."""
    rows = FIT_STEPS * B
    rng = np.random.default_rng(1234)
    ids = rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int64)
    labels = rng.integers(0, 2, (rows,)).astype(np.int64)
    return _Rows([ids, labels])


def build_classifier(cfg, device, seed: int = 7):
    """BERT sequence classifier, AdamW, O2 bf16 with master weights."""
    import paddle_tpu_torch as paddle
    from .. import amp
    from ..models import BertForSequenceClassification

    paddle.seed(seed)
    with using_device(device):
        net = BertForSequenceClassification(cfg, num_classes=2)
    opt = paddle.optimizer.AdamW(learning_rate=FIT_LR,
                                 parameters=net.parameters())
    return amp.decorate(net, opt, level="O2", dtype="bfloat16")


class _Record(Callback):
    """A hapi callback keeping each train step's loss, and pausing (for
    the parent's SIGKILL) at ``pause_at = (epoch, step)`` after writing
    ``marker``."""

    def __init__(self, pause_at=None, marker=None):
        super().__init__()
        self.pause_at, self.marker = pause_at, marker
        self.losses = []
        self.epoch = 0

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        self.losses.append((self.epoch, step, float(logs["loss"])))
        if self.pause_at is not None and (self.epoch, step) == self.pause_at:
            with open(self.marker, "w") as f:
                f.write("paused")
            time.sleep(3600)


def fit_child(device, small: bool, ckdir: str, out: str,
              pause_at=None) -> dict:
    """One ``Model.fit`` run (a child of the fit-resume drill): resumes
    from ``ckdir`` when it holds a committed step; writes its result to
    ``out``."""
    from .. import metric, nn
    from ..faults import TrainSentinel
    from ..hapi import Model
    from ..ops import embedding_grad as eg
    from ..ops import flash_attention as fa

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, B, S = _bert_shapes(small)
    net, opt = build_classifier(cfg, device)
    model = Model(net)
    acc = metric.Accuracy()
    model.prepare(opt, nn.CrossEntropyLoss(), acc, amp_configs="O2")
    loader = DataLoader(fit_data(cfg, B, S), batch_size=B, shuffle=True)
    rec = _Record(pause_at, os.path.join(ckdir, "PAUSED"))
    fa.reset_counters()
    eg.reset_counters()
    t0 = time.perf_counter()
    model.fit(loader, epochs=2, checkpoint_dir=ckdir,
              sentinel=TrainSentinel(), verbose=0, callbacks=[rec])
    _sync(device)
    result = {"digest": digest_of(net, opt), "accuracy": acc.accumulate(),
              "losses": rec.losses, "seconds": time.perf_counter() - t0,
              "flash": {k: fa.kernel_launches[k] + fa.replayed_launches[k]
                        for k in fa.kernel_launches},
              "plain": dict(fa.plain_calls),
              "embedding_grad": eg.launches(),
              "embedding_grad_plain": eg.plain_calls}
    with open(out, "w") as f:
        json.dump(result, f)
    return result


# a child that takes SIGTERM starts with it blocked, before torch makes
# any thread: every thread inherits the mask, so the signal reaches the
# process only where its main thread unblocks it, between two steps
_BOOT = ("import runpy, signal, sys; "
         "signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM}); "
         "sys.argv = ['train_chaos'] + sys.argv[1:]; "
         "runpy.run_module('paddle_tpu_torch.tools.train_chaos', "
         "run_name='__main__', alter_sys=True)")


def _spawn(args: List[str]) -> subprocess.Popen:
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", _BOOT] + args, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _safe_point() -> None:
    """A Python call: the interpreter runs a pending signal handler at
    its entry."""


def _finish(proc: subprocess.Popen, what: str, timeout_s: float = 900.0,
            expect_rc: int = 0) -> str:
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    text = out.decode(errors="replace")
    _check(proc.returncode == expect_rc,
           f"{what} exited {proc.returncode}, not {expect_rc}:\n"
           f"{text[-3000:]}")
    return text


def _wait_for(path: str, proc: subprocess.Popen, what: str,
              timeout_s: float = 900.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if proc.poll() is not None:
            tail = proc.stdout.read().decode(errors="replace")[-3000:]
            raise DrillFailed(f"{what}: child exited {proc.returncode} "
                              f"first:\n{tail}")
        _check(time.monotonic() < deadline, f"{what}: timed out")
        time.sleep(0.05)


def _child_args(kind, device, small, ckdir, out, extra=()):
    args = ["--child", kind, "--device", str(device), "--dir", ckdir,
            "--out", out] + list(extra)
    return args + (["--small"] if small else [])


def drill_fit_resume(device, small: bool, root: str, log) -> dict:
    cfg, B, S = _bert_shapes(small)
    ref_dir, run_dir = os.path.join(root, "ref"), os.path.join(root, "run")
    ref_out, run_out = ref_dir + ".json", run_dir + ".json"
    # two epoch steps, three sentinel marks and a scratch copy, each run
    per_state = _fit_state_bytes(cfg)
    need_disk(root, 2 * 6 * per_state, "fit-resume")
    t0 = time.perf_counter()
    ref = _spawn(_child_args("fit", device, small, ref_dir, ref_out))
    victim = _spawn(_child_args("fit", device, small, run_dir, run_out,
                                ["--pause-at", "1:2"]))
    _wait_for(os.path.join(run_dir, "PAUSED"), victim, "fit victim")
    _check(os.path.isfile(os.path.join(run_dir, "step_00000000", "COMMIT")),
           "fit victim paused before epoch 0 was committed")
    victim.send_signal(signal.SIGKILL)
    victim.communicate()
    _check(victim.returncode == -signal.SIGKILL, "victim not SIGKILLed")
    os.unlink(os.path.join(run_dir, "PAUSED"))
    _check(not os.path.exists(run_out), "killed child wrote a result")
    resumed = _spawn(_child_args("fit", device, small, run_dir, run_out))
    _finish(resumed, "fit resume")
    _finish(ref, "fit reference")
    with open(ref_out) as f:
        want = json.load(f)
    with open(run_out) as f:
        got = json.load(f)
    bad = [k for k, v in want["digest"].items() if got["digest"].get(k) != v]
    _check(not bad, f"resumed fit diverged from the uninterrupted one: "
           f"{len(bad)} tensors, first {bad[:3]}")
    _check(got["accuracy"] == want["accuracy"],
           f"accuracy {got['accuracy']} != {want['accuracy']}")
    tail = [x for x in want["losses"] if x[0] == 1]
    _check(got["losses"] == tail,
           f"epoch 1 losses differ: {got['losses']} vs {tail}")
    _check(all(e == 1 for e, _s, _l in got["losses"]),
           "the resumed fit ran epoch 0 again")
    n_moments = sum(1 for k in want["digest"] if k.startswith("opt.")
                    and ("moment" in k))
    rec = {"seconds": time.perf_counter() - t0, "state_bytes": per_state,
           "accuracy": want["accuracy"], "epoch1_losses": len(tail),
           "tensors_compared": len(want["digest"]),
           "moments_compared": n_moments,
           "flash_reference": want["flash"], "flash_resumed": got["flash"],
           "plain_reference": want["plain"], "plain_resumed": got["plain"],
           "embedding_grad": [want["embedding_grad"], got["embedding_grad"]],
           "embedding_grad_plain": want["embedding_grad_plain"]
           + got["embedding_grad_plain"],
           "fit_seconds_reference": want["seconds"]}
    shutil.rmtree(ref_dir, ignore_errors=True)
    shutil.rmtree(run_dir, ignore_errors=True)
    log(f"[train_chaos] fit-resume: SIGKILLed mid-epoch 1, resumed from "
        f"epoch 0's step; {len(want['digest'])} tensors, accuracy "
        f"{want['accuracy']} and {len(tail)} losses equal bit for bit")
    return rec


def _fit_state_bytes(cfg) -> int:
    """An upper bound on a classifier's checkpoint bytes at O2 with
    master weights, from the config: 16 bytes a parameter (the parameter
    itself at most f32, its f32 master and two f32 moments)."""
    H, L, V, I = (cfg.hidden_size, cfg.num_layers, cfg.vocab_size,
                  cfg.intermediate_size)
    P = (V + cfg.max_position_embeddings + cfg.type_vocab_size) * H \
        + L * (4 * H * H + 2 * H * I + 9 * H + I) + 2 * H + H * H + H \
        + 2 * H + 2
    return int(P * 16)


def pretrain_data(cfg, B: int, S: int, batches: int):
    """``bench_bert``'s kind of batch, ``batches`` of them, seeded."""
    rng = np.random.default_rng(4321)
    n = B * batches
    ids = rng.integers(0, cfg.vocab_size, (n, S)).astype(np.int64)
    mlm = ids.copy()
    mlm[rng.random((n, S)) > 0.15] = -100
    nsp = rng.integers(0, 2, (n,)).astype(np.int64)
    return _Rows([ids, mlm, nsp])


def build_pretrainer(cfg, device, seed: int = 5):
    import paddle_tpu_torch as paddle
    from .. import amp
    from ..models import BertForPretraining

    paddle.seed(seed)
    with using_device(device):
        net = BertForPretraining(cfg)
    opt = paddle.optimizer.AdamW(learning_rate=PRETRAIN_LR,
                                 parameters=net.parameters())
    return amp.decorate(net, opt, level="O2", dtype="bfloat16")


def pretrain_step_fn(net, device) -> Callable:
    """The bench's train step without backward and update: forward and
    loss under O2, as ``TrainSentinel.guard`` wants it."""
    from .. import amp

    def step_fn(ids, mlm, nsp):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            _, loss = net(_on(ids, device), masked_lm_labels=_on(mlm, device),
                          next_sentence_labels=_on(nsp, device))
        return loss
    return step_fn


def guarded_loop(sentinel, net, opt, loader, steps: int, device,
                 start: int = 0, between: Optional[Callable] = None):
    """``steps`` guarded calls over ``loader`` (epochs wrap); a rollback
    rebuilds the iterator. ``between(i)`` runs after call ``i`` finished.
    Returns each call's report."""
    guarded = sentinel.guard(pretrain_step_fn(net, device), optimizer=opt)
    it, reports, i = iter(loader), [], start
    while i < steps:
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            continue
        rep = guarded(*batch)
        reports.append(rep)
        if rep.rolled_back:
            it = iter(loader)
        if between is not None:
            between(i)
        i += 1
    return reports


def _clean_pretrain(cfg, device, loader, excluded, consumed, final):
    """The clean run: the same stream to the same position, updating on
    every batch outside ``excluded``; the batches in ``consumed`` run
    their forward under ``no_grad`` and update nothing."""
    from ..autograd import no_grad

    net, opt = build_pretrainer(cfg, device)
    step_fn = pretrain_step_fn(net, device)
    it, ep, b = iter(loader), 0, 0
    while (ep, b) != (final["epoch"], final["batch"]):
        try:
            batch = next(it)
        except StopIteration:
            it, ep, b = iter(loader), ep + 1, 0
            continue
        cur, b = (ep, b), b + 1
        if cur in consumed:
            with no_grad():
                step_fn(*batch)
            continue
        if cur in excluded:
            continue
        step_fn(*batch).backward()
        opt.step()
        opt.clear_grad()
    return net, opt


def _first_grad_param(net):
    for p in net.parameters():
        return p


def measure_checkpoint(cfg, device, net, opt, loader, root, log) -> dict:
    """The checkpoint's costs at this width, on this device (module
    docstring)."""
    from ..faults import TrainSentinel

    mgr = ck.CheckpointManager(os.path.join(root, "timed"), max_to_keep=2,
                               device=device)
    step_fn = pretrain_step_fn(net, device)
    batches = [b for _, b in zip(range(4), iter(loader))]

    def eager_steps():
        _sync(device)
        t = time.perf_counter()
        for b in batches:
            step_fn(*b).backward()
            opt.step()
            opt.clear_grad()
        _sync(device)
        return (time.perf_counter() - t) / len(batches) * 1e3

    eager_steps()  # warm, and the optimizer's state exists from here on
    state = ck.capture_train_state(model=net, optimizer=opt,
                                   dataloader=loader, step=0)
    nbytes = _state_bytes(state)
    need_disk(root, 3 * nbytes, "checkpoint timing")
    _sync(device)
    t0 = time.perf_counter()
    mgr.save(0, state)
    sync_s = time.perf_counter() - t0
    _check(mgr.verify(0)[0], "timed sync save does not verify")
    t0 = time.perf_counter()
    ok, why = mgr.verify(0)
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, _ = mgr.restore(0)
    _sync(device)
    restore_s = time.perf_counter() - t0
    del restored
    # steps with and without a save draining on the writer thread
    plain_ms = eager_steps()
    t0 = time.perf_counter()
    handle = mgr.save(1, ck.capture_train_state(
        model=net, optimizer=opt, dataloader=loader, step=1),
        async_save=True)
    snapshot_s = time.perf_counter() - t0
    draining_ms = eager_steps()
    drained_during = not handle._thread.is_alive()
    handle.wait()
    async_s = time.perf_counter() - t0
    sent = TrainSentinel()
    sent.bind(model=net, optimizer=opt)
    guarded = sent.guard(step_fn, optimizer=opt)

    def guarded_steps():
        _sync(device)
        t = time.perf_counter()
        for b in batches:
            guarded(*b)
        _sync(device)
        return (time.perf_counter() - t) / len(batches) * 1e3

    # the sentinel's cost: unguarded and guarded steps in turns
    turns = [(eager_steps(), guarded_steps()) for _ in range(3)]
    rec = {"state_bytes": nbytes, "sync_save_s": sync_s,
           "sync_save_gb_s": nbytes / sync_s / 1e9,
           "async_snapshot_s": snapshot_s, "async_save_s": async_s,
           "async_save_gb_s": nbytes / async_s / 1e9,
           "verify_s": verify_s, "verify_ok": ok, "restore_s": restore_s,
           "restore_gb_s": nbytes / restore_s / 1e9,
           "eager_step_ms": plain_ms, "eager_step_ms_async_draining":
               draining_ms, "save_outlasted_the_steps": not drained_during,
           "eager_step_ms_turns": [e for e, _ in turns],
           "guarded_step_ms_turns": [g for _, g in turns],
           "guarded_step_ms": min(g for _, g in turns),
           "unguarded_step_ms": min(e for e, _ in turns)}
    shutil.rmtree(mgr.directory, ignore_errors=True)
    log("[train_chaos] checkpoint costs: " + json.dumps(rec))
    return rec


def drill_guard_skip_rollback(device, small: bool, root: str, log) -> dict:
    from ..faults import Action, TrainSentinel
    from ..ops import embedding_grad as eg
    from ..ops import flash_attention as fa

    cfg, B, S = _bert_shapes(small)
    batches = 24
    net, opt = build_pretrainer(cfg, device)
    loader = DataLoader(pretrain_data(cfg, B, S, batches), batch_size=B)
    costs = measure_checkpoint(cfg, device, net, opt, loader, root, log)
    net, opt = build_pretrainer(cfg, device)
    loader = DataLoader(pretrain_data(cfg, B, S, batches), batch_size=B)
    mgr = ck.CheckpointManager(os.path.join(root, "marks"), max_to_keep=2,
                               device=device)
    need_disk(root, 3 * costs["state_bytes"], "guard-skip-rollback")
    sent = TrainSentinel(skip_limit=1, healthy_window=2, mark_every=4,
                         min_history=4)
    sent.bind(model=net, optimizer=opt, dataloader=loader, manager=mgr)
    sent.note_epoch(0)
    victim = _first_grad_param(net)
    compiles0 = _counter("paddle_tpu_jit_compiles_total")
    fa.reset_counters()
    eg.reset_counters()
    t0 = time.perf_counter()
    with faults.inject("train.grads", call=_nan_grads(victim), seed=SEED,
                       after=2, times=1) as one, \
            faults.inject("train.grads", call=_nan_grads(victim), seed=SEED,
                          after=9, times=3) as region:
        reports = guarded_loop(sent, net, opt, loader, 16, device)
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = {k: fa.kernel_launches[k] + fa.replayed_launches[k]
                for k in fa.kernel_launches}
    plain = dict(fa.plain_calls)
    emb = {"embedding_grad": [eg.launches()],
           "embedding_grad_plain": eg.plain_calls}
    actions = [r.action for r in reports]
    _check(one.fired == 1 and region.fired == 3,
           f"faults fired {one.fired}/{region.fired}, wanted 1/3")
    _check(actions[2] == Action.SKIP,
           f"the single NaN step's verdict was {actions[2]}, not skip")
    _check(actions.count(Action.ROLLBACK) == 1 and sent.rollbacks == 1,
           f"wanted exactly one rollback: {actions}")
    _check(_counter("paddle_tpu_jit_compiles_total") == compiles0,
           "guarding cost a step-program capture")
    excluded, consumed = excluded_from_journal(sent.journal())
    clean_loader = DataLoader(pretrain_data(cfg, B, S, batches),
                              batch_size=B)
    n2, o2 = _clean_pretrain(cfg, device, clean_loader, excluded, consumed,
                             loader.state_dict())
    got, want = digest_of(net, opt), digest_of(n2, o2)
    bad = [k for k, v in want.items() if got.get(k) != v]
    _check(not bad, f"guarded run diverged from the clean run: {len(bad)} "
           f"tensors, first {bad[:3]}")
    rec = {"seconds": seconds, "actions": actions,
           "excluded": sorted(excluded), "forward_only": sorted(consumed),
           "marks_committed": mgr.all_steps(), "tensors_compared": len(want),
           "flash": launches, "plain": plain, **emb, **costs}
    shutil.rmtree(mgr.directory, ignore_errors=True)
    log(f"[train_chaos] guard-skip-rollback: {actions.count('skip')} skips, "
        f"1 rollback, excluded {sorted(excluded)}; {len(want)} tensors "
        f"bit-identical to the clean run; no capture")
    return rec


def preempt_child(device, small: bool, ckdir: str, out: str,
                  steps: int = 10, progress: Optional[str] = None) -> dict:
    """The guarded pretraining loop under ``save_on_signal`` (a child of
    the preemption drill): resumes from ``ckdir`` when it holds a
    committed step; runs until ``steps`` calls in all; SIGTERM makes it
    commit its position and exit 0. Writes each call's loss to
    ``progress`` and its result to ``out``."""
    from ..faults import TrainSentinel
    from ..ops import embedding_grad as eg
    from ..ops import flash_attention as fa

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, B, S = _bert_shapes(small)
    net, opt = build_pretrainer(cfg, device)
    loader = DataLoader(pretrain_data(cfg, B, S, 24), batch_size=B)
    sent = TrainSentinel()
    sent.bind(model=net, optimizer=opt, dataloader=loader)
    mgr = ck.CheckpointManager(ckdir, max_to_keep=2, device=device)
    res = mgr.restore_or_init()
    start = 0
    if res.restored:
        start = ck.restore_train_state(res.state, model=net, optimizer=opt,
                                       dataloader=loader, sentinel=sent) + 1
    else:
        sent.note_epoch(0)
    done = {"step": start - 1}
    losses: List[float] = []
    blocked = {signal.SIGTERM}

    def between(i, loss):
        done["step"] = i
        losses.append(loss)
        if progress is not None:
            with open(progress, "a") as f:
                f.write(json.dumps({"step": i}) + "\n")
        # the handler may run only here, between two steps (every thread
        # of a child started by _spawn has SIGTERM blocked)
        signal.pthread_sigmask(signal.SIG_UNBLOCK, blocked)
        _safe_point()
        signal.pthread_sigmask(signal.SIG_BLOCK, blocked)

    fa.reset_counters()
    eg.reset_counters()
    signal.pthread_sigmask(signal.SIG_BLOCK, blocked)
    scope = mgr.save_on_signal(lambda: (done["step"], ck.capture_train_state(
        model=net, optimizer=opt, dataloader=loader, step=done["step"],
        sentinel=sent)))
    guarded = sent.guard(pretrain_step_fn(net, device), optimizer=opt)
    it, i = iter(loader), start
    t0 = time.perf_counter()
    while i < steps:
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            continue
        rep = guarded(*batch)
        if rep.rolled_back:
            it = iter(loader)
        between(i, rep.loss)
        i += 1
    scope.uninstall()
    signal.pthread_sigmask(signal.SIG_UNBLOCK, blocked)
    _sync(device)
    result = {"start": start, "losses": losses,
              "digest": digest_of(net, opt),
              "seconds": time.perf_counter() - t0,
              "flash": {k: fa.kernel_launches[k] + fa.replayed_launches[k]
                        for k in fa.kernel_launches},
              "plain": dict(fa.plain_calls),
              "embedding_grad": eg.launches(),
              "embedding_grad_plain": eg.plain_calls}
    with open(out, "w") as f:
        json.dump(result, f)
    return result


def drill_preemption(device, small: bool, root: str, log) -> dict:
    ref_dir, run_dir = os.path.join(root, "pref"), os.path.join(root, "prun")
    ref_out, run_out = ref_dir + ".json", run_dir + ".json"
    progress = run_dir + ".progress"
    os.makedirs(run_dir, exist_ok=True)
    t0 = time.perf_counter()
    ref = _spawn(_child_args("preempt", device, small, ref_dir, ref_out))
    victim = _spawn(_child_args("preempt", device, small, run_dir, run_out,
                                ["--progress", progress]))
    deadline = time.monotonic() + 900
    while True:
        lines = open(progress).read().splitlines() if os.path.exists(
            progress) else []
        if len(lines) >= 4:
            break
        if victim.poll() is not None:
            raise DrillFailed("preemption victim exited before step 4:\n"
                              + victim.stdout.read().decode(
                                  errors="replace")[-3000:])
        _check(time.monotonic() < deadline, "preemption victim timed out")
        time.sleep(0.02)
    victim.send_signal(signal.SIGTERM)
    _finish(victim, "preempted child")
    _check(not os.path.exists(run_out), "the preempted child ran to its end")
    mgr = ck.CheckpointManager(run_dir, device="cpu")
    at = mgr.latest_step()
    _check(at is not None and 3 <= at < 9,
           f"SIGTERM committed step {at}, not one mid-run")
    resumed = _spawn(_child_args("preempt", device, small, run_dir, run_out))
    _finish(resumed, "resumed child")
    _finish(ref, "uninterrupted child")
    with open(ref_out) as f:
        want = json.load(f)
    with open(run_out) as f:
        got = json.load(f)
    _check(got["start"] == at + 1, f"resumed at {got['start']}, not {at + 1}")
    _check(got["losses"] == want["losses"][at + 1:],
           f"losses after the resume differ: {got['losses']} vs "
           f"{want['losses'][at + 1:]}")
    bad = [k for k, v in want["digest"].items() if got["digest"].get(k) != v]
    _check(not bad, f"resumed run diverged: {len(bad)} tensors, first "
           f"{bad[:3]}")
    rec = {"seconds": time.perf_counter() - t0, "sigterm_step": at,
           "losses_compared": len(got["losses"]),
           "tensors_compared": len(want["digest"]),
           "flash_reference": want["flash"], "flash_resumed": got["flash"],
           "plain_reference": want["plain"], "plain_resumed": got["plain"],
           "embedding_grad": [want["embedding_grad"], got["embedding_grad"]],
           "embedding_grad_plain": want["embedding_grad_plain"]
           + got["embedding_grad_plain"]}
    shutil.rmtree(ref_dir, ignore_errors=True)
    shutil.rmtree(run_dir, ignore_errors=True)
    log(f"[train_chaos] preemption: SIGTERM committed step {at}; the "
        f"resumed child's {len(got['losses'])} losses and "
        f"{len(want['digest'])} tensors equal the uninterrupted child's")
    return rec


BERT_DRILLS: Dict[str, Callable] = {
    "fit-resume": drill_fit_resume,
    "guard-skip-rollback": drill_guard_skip_rollback,
    "preemption": drill_preemption,
}


def run_bert_drills(device="cuda", small: bool = False, names=None,
                    log=print, root: Optional[str] = None) -> dict:
    """Run the BERT drills (all by default); returns their records.
    A failed check raises :class:`DrillFailed`."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    own = root is None
    root = tempfile.mkdtemp(prefix="train_chaos_") if own else root
    out = {}
    try:
        for name, fn in BERT_DRILLS.items():
            if names is None or name in names:
                faults.reset()
                try:
                    out[name] = fn(device, small, os.path.join(root, name),
                                   log)
                finally:
                    faults.reset()
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("regression", "bert_base"),
                    default="regression")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="bert_tiny at B 4 (a rehearsal of the BERT drills)")
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated regression scenario names")
    ap.add_argument("--drills", default=None,
                    help="comma-separated BERT drill names")
    ap.add_argument("--child", choices=("fit", "preempt"), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--pause-at", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--progress", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child == "fit":
        pause = None if args.pause_at is None else tuple(
            int(x) for x in args.pause_at.split(":"))
        fit_child(args.device, args.small, args.dir, args.out, pause)
        return 0
    if args.child == "preempt":
        preempt_child(args.device, args.small, args.dir, args.out,
                      progress=args.progress)
        return 0
    if args.model == "regression":
        names = args.scenarios.split(",") if args.scenarios else None
        failures = run_scenarios(args.device, names)
        total = len(names or SCENARIOS)
        print(f"[train_chaos] {total - failures}/{total} scenarios passed")
        return 1 if failures else 0
    from ..bench import card_label

    recs = run_bert_drills(args.device, args.small,
                           args.drills.split(",") if args.drills else None)
    print(json.dumps({"device": card_label(resolve_device(args.device)),
                      "drills": recs}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
