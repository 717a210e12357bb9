"""``paddle_tpu_torch.checkpoint`` against ``paddle_tpu.checkpoint``.

The cases of ``tests/test_checkpoint_manager.py`` run once per package
(the ``side`` fixture), on the CPU, each held to the same outcome: the
commit layout and its CRC32s, steps visible only once committed, a fault
at every commit phase (sync and async) never costing the previous step,
corruption quarantined with fallback, truncation caught by size,
retention GC, ``restore_or_init``, overlapping async saves,
``save_on_signal`` (exit and no-exit), ``scalars.json``'s exact types and
the six ``paddle_tpu_ckpt_*`` metrics, each read from its package's own
registry as deltas. Values compare exactly.

Then what only the port has to show:

- an async save followed at once by an optimizer step (the port writes
  its cells in place) restores the pre-step values;
- ``save_on_signal`` in a child process, SIGTERM from outside;
- both directions across packages: a step the JAX ``CheckpointManager``
  commits from ``bert_tiny`` + AdamW at O2 (bf16 parameters, f32 master
  weights and moments) restores into the port's ``bert_tiny`` + AdamW
  bit for bit, and the reverse; the ``rng`` entry does not cross (a
  threefry key against a ``torch.Generator`` state): the port raises
  ``ValueError`` for the JAX one, the JAX package a ``KeyError`` for the
  port's (ROADMAP Queue 3).
"""
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import models as jmodels
from paddle_tpu_torch import amp, models
from torch_facade_common import on_cpu  # noqa: F401 (autouse)
from torch_nn_common import fresh_uids

REPO = Path(__file__).resolve().parents[1]


class Side:
    """One package's checkpoint stack."""

    def __init__(self, name):
        self.name = name
        self.ck = importlib.import_module(f"{name}.checkpoint")
        self.faults = importlib.import_module(f"{name}.faults")
        self.metrics = importlib.import_module(f"{name}.metrics")
        self.Tensor = importlib.import_module(f"{name}.tensor").Tensor
        self.port = name == "paddle_tpu_torch"

    def mgr(self, path, **kw):
        if self.port:
            kw["device"] = "cpu"
        return self.ck.CheckpointManager(str(path), **kw)

    def counter(self, name, **labels):
        fam = self.metrics.get_registry().get(name)
        if fam is None:
            return 0.0
        return (fam.labels(**labels) if labels else fam).value

    def state(self, seed=0):
        rng = np.random.default_rng(seed)
        return {"model": {
            "w": self.Tensor(rng.standard_normal((4, 3)).astype("float32")),
            "b": self.Tensor(rng.standard_normal((3,)).astype("float32"))},
            "epoch": int(seed), "lr": 0.125, "note": "run", "flag": True}


@pytest.fixture(params=["paddle_tpu", "paddle_tpu_torch"])
def side(request):
    s = Side(request.param)
    s.faults.reset()
    yield s
    s.faults.reset()


def _same_state(got, want):
    for k in ("w", "b"):
        np.testing.assert_array_equal(np.asarray(got["model"][k].numpy()),
                                      np.asarray(want["model"][k].numpy()))
    assert got["epoch"] == want["epoch"] and isinstance(got["epoch"], int)
    assert got["lr"] == want["lr"] and isinstance(got["lr"], float)
    assert got["note"] == want["note"] and got["flag"] is True


def _flip_byte(path):
    data = bytearray(path.read_bytes())
    data[-1] ^= 0xFF
    path.write_bytes(bytes(data))


# ──────────────────────────────── protocol ────────────────────────────────


def test_commit_layout_and_checksums(side, tmp_path):
    side.mgr(tmp_path).save(0, side.state())
    step_dir = tmp_path / "step_00000000"
    commit = json.loads((step_dir / "COMMIT").read_text())
    assert commit["step"] == 0 and commit["format"] == 1
    assert sorted(commit["files"]) == [
        "checkpoint.metadata.json", "model__b.p0.s0.npy",
        "model__w.p0.s0.npy", "scalars.json"]
    for name, rec in commit["files"].items():
        data = (step_dir / name).read_bytes()
        assert len(data) == rec["size"] and zlib.crc32(data) == rec["crc32"]
    assert json.loads((step_dir / "scalars.json").read_text()) == {
        "epoch": 0, "lr": 0.125, "note": "run", "flag": True}
    assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]


def test_latest_step_sees_only_committed(side, tmp_path):
    mgr = side.mgr(tmp_path)
    assert mgr.latest_step() is None
    (tmp_path / "step_00000007.tmp-dead").mkdir()
    (tmp_path / "corrupt-step_00000003-beef").mkdir()
    (tmp_path / "step_00000005").mkdir()
    assert mgr.latest_step() is None
    mgr.save(1, side.state())
    assert mgr.latest_step() == 1 and mgr.all_steps() == [1]


def test_duplicate_step_rejected(side, tmp_path):
    mgr = side.mgr(tmp_path)
    mgr.save(3, side.state())
    with pytest.raises(ValueError, match="already committed"):
        mgr.save(3, side.state(1))
    assert mgr.save_if_absent(3, side.state(1)) is None


_PHASES = [
    ("ckpt.write", {"times": 1}),
    ("ckpt.fsync", {"times": 1}),
    ("ckpt.write", {"times": 1, "after": 2}),
    ("ckpt.manifest", {"times": 1}),
    ("ckpt.commit", {"times": 1}),
    ("ckpt.commit", {"times": 1, "after": 1}),
]


@pytest.mark.parametrize("point,sched", _PHASES, ids=[
    f"{p}-{'+'.join(f'{k}{v}' for k, v in kw.items())}"
    for p, kw in _PHASES])
@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_crash_mid_save_never_loses_previous_step(side, tmp_path, point,
                                                  sched, async_save):
    mgr = side.mgr(tmp_path)
    good = side.state(0)
    mgr.save(0, good)
    failed0 = side.counter("paddle_tpu_ckpt_saves_total", result="failed")
    with side.faults.inject(point, raise_=side.faults.FaultInjected,
                            **sched) as spec:
        if async_save:
            handle = mgr.save(1, side.state(1), async_save=True)
            with pytest.raises(side.faults.FaultInjected):
                handle.wait()
            assert handle.failed() and not handle.done()
        else:
            with pytest.raises(side.faults.FaultInjected):
                mgr.save(1, side.state(1))
        assert spec.fired == 1
    assert side.counter("paddle_tpu_ckpt_saves_total",
                        result="failed") == failed0 + 1
    assert mgr.latest_step() == 0
    state, step = mgr.restore()
    assert step == 0
    _same_state(state, good)
    mgr.save(1, side.state(1))
    assert mgr.latest_step() == 1
    assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]


def test_corrupt_newest_quarantined_falls_back(side, tmp_path):
    mgr = side.mgr(tmp_path)
    s0 = side.state(0)
    mgr.save(0, s0)
    mgr.save(1, side.state(1))
    _flip_byte(tmp_path / "step_00000001" / "model__w.p0.s0.npy")
    c0 = side.counter("paddle_tpu_ckpt_corrupt_total")
    f0 = side.counter("paddle_tpu_ckpt_restore_fallback_total")
    ok, reason = mgr.verify(1)
    assert not ok and "crc32 mismatch" in reason
    state, step = mgr.restore()
    assert step == 0
    _same_state(state, s0)
    assert mgr.latest_step() == 0
    assert [d for d in os.listdir(tmp_path) if d.startswith("corrupt-")]
    assert side.counter("paddle_tpu_ckpt_corrupt_total") == c0 + 1
    assert side.counter("paddle_tpu_ckpt_restore_fallback_total") == f0 + 1


def test_truncated_file_detected_by_size(side, tmp_path):
    mgr = side.mgr(tmp_path)
    mgr.save(0, side.state(0))
    mgr.save(1, side.state(1))
    victim = tmp_path / "step_00000001" / "model__b.p0.s0.npy"
    victim.write_bytes(victim.read_bytes()[:-8])
    assert "size mismatch" in mgr.verify(1)[1]
    assert mgr.restore()[1] == 0


def test_all_steps_corrupt_raises(side, tmp_path):
    mgr = side.mgr(tmp_path)
    mgr.save(0, side.state())
    _flip_byte(tmp_path / "step_00000000" / "model__w.p0.s0.npy")
    with pytest.raises(side.ck.CheckpointNotFoundError):
        mgr.restore()
    assert mgr.restore_or_init(default={"fresh": 1}).state == {"fresh": 1}


def test_retention_gc_keeps_last_k(side, tmp_path):
    before = side.counter("paddle_tpu_ckpt_gc_deleted_total")
    mgr = side.mgr(tmp_path, max_to_keep=2)
    for s in range(5):
        mgr.save(s, side.state(s))
    assert mgr.all_steps() == [3, 4]
    assert side.counter("paddle_tpu_ckpt_gc_deleted_total") == before + 3
    assert mgr.delete_step(3) and mgr.all_steps() == [4]
    assert not mgr.delete_step(3)


def test_restore_or_init(side, tmp_path):
    mgr = side.mgr(tmp_path)
    assert tuple(mgr.restore_or_init(default="fresh")) == ("fresh", None,
                                                           False)
    mgr.save(9, side.state(9))
    res = mgr.restore_or_init()
    assert res.restored and res.step == 9
    _same_state(res.state, side.state(9))


def test_overlapping_async_saves_both_commit(side, tmp_path):
    mgr = side.mgr(tmp_path)
    with side.faults.inject("ckpt.write", delay_s=0.02):
        h1 = mgr.save(0, side.state(0), async_save=True)
        h2 = side.mgr(tmp_path).save(1, side.state(1), async_save=True)
        h1.wait()
        h2.wait()
    assert mgr.all_steps() == [0, 1]
    state, step = mgr.restore()
    assert step == 1
    _same_state(state, side.state(1))


def test_async_save_success_and_metrics(side, tmp_path):
    mgr = side.mgr(tmp_path)
    h = mgr.save(2, side.state(2), async_save=True)
    side.ck.wait()
    h.wait()
    assert h.done() and not h.failed() and h.error is None
    assert mgr.latest_step() == 2 and mgr.verify(2) == (True, "")
    reg = side.metrics.get_registry()
    assert reg.get("paddle_tpu_ckpt_last_committed_step").value == 2
    assert reg.get("paddle_tpu_ckpt_save_seconds").labels(
        mode="async").count >= 1
    assert side.counter("paddle_tpu_ckpt_saves_total",
                        result="committed") >= 1


def test_save_on_signal_checkpoints_and_exits(side, tmp_path):
    mgr = side.mgr(tmp_path)
    good = side.state(5)
    scope = mgr.save_on_signal(lambda: (5, good))
    try:
        with pytest.raises(SystemExit) as exc_info:
            os.kill(os.getpid(), signal.SIGTERM)
        assert exc_info.value.code == 0
    finally:
        scope.uninstall()
    assert mgr.preempted and mgr.latest_step() == 5
    _same_state(mgr.restore()[0], good)


def test_save_on_signal_no_exit_mode(side, tmp_path):
    mgr = side.mgr(tmp_path)
    with mgr.save_on_signal(lambda: (1, side.state(1)), exit_on_save=False):
        os.kill(os.getpid(), signal.SIGINT)
    assert mgr.preempted and mgr.latest_step() == 1


# ───────────────────────────── the port alone ─────────────────────────────


def test_async_save_then_an_optimizer_step_keeps_the_pre_step_values(
        tmp_path):
    """The save copies every cell before it returns: the step right after
    it writes the same storage in place and must not reach the files."""
    from paddle_tpu_torch import checkpoint as ck

    paddle.seed(0)
    net = paddle.nn.Linear(64, 64)
    opt = paddle.optimizer.AdamW(learning_rate=0.1,
                                 parameters=net.parameters())
    x = paddle.to_tensor(np.ones((8, 64), np.float32))
    net(x).sum().backward()
    opt.step()
    opt.clear_grad()
    before = {k: v.numpy() for k, v in net.state_dict().items()}
    moments = {k: v.clone() for k, v in opt.state_dict().items()
               if hasattr(v, "shape")}
    mgr = ck.CheckpointManager(str(tmp_path), device="cpu")
    paddle_faults = importlib.import_module("paddle_tpu_torch.faults")
    with paddle_faults.inject("ckpt.write", delay_s=0.05):
        h = mgr.save(0, ck.capture_train_state(model=net, optimizer=opt),
                     async_save=True)
        for _ in range(2):
            net(x).sum().backward()
            opt.step()
            opt.clear_grad()
        h.wait()
    assert not np.array_equal(net.weight.numpy(), before["weight"])
    state, _ = mgr.restore()
    for k, v in before.items():
        np.testing.assert_array_equal(state["model"][k].numpy(), v)
    for k, v in moments.items():
        assert torch.equal(state["optimizer"][k]._value, v), k


_CHILD = """
import os, sys, time
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch import checkpoint as ck
paddle.set_device("cpu")
mgr = ck.CheckpointManager(sys.argv[1])
w = paddle.Tensor(np.arange(6, dtype=np.float32), stop_gradient=True)
mgr.save_on_signal(lambda: (4, {"model": {"w": w}, "epoch": 4}))
open(sys.argv[2], "w").write("ready")
time.sleep(60)
sys.exit(3)
"""


def test_save_on_signal_in_a_child_process(tmp_path):
    ready = tmp_path / "ready"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _CHILD,
                             str(tmp_path / "ck"), str(ready)], env=env)
    try:
        for _ in range(600):
            if ready.exists() or proc.poll() is not None:
                break
            time.sleep(0.05)
        assert ready.exists()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    from paddle_tpu_torch import checkpoint as ck
    state, step = ck.CheckpointManager(str(tmp_path / "ck"),
                                       device="cpu").restore()
    assert step == 4 and state["epoch"] == 4
    np.testing.assert_array_equal(state["model"]["w"].numpy(),
                                  np.arange(6, dtype=np.float32))


def _bert_pair():
    """``bert_tiny`` pretraining at O2 with AdamW in both packages, the
    port carrying the JAX weights; one step each on the same batch."""
    pt.seed(0)
    jm = fresh_uids(jmodels.BertForPretraining(jmodels.bert_tiny()))
    jo = pt.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    tm = models.BertForPretraining(models.bert_tiny())
    models.load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    to = paddle.optimizer.AdamW(learning_rate=1e-3,
                                parameters=tm.parameters())
    jm, jo = jamp.decorate(jm, jo, level="O2", dtype="bfloat16")
    tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 16))
    nsp = np.array([0, 1])
    for P, A, m, o in ((pt, jamp, jm, jo), (paddle, amp, tm, to)):
        with A.auto_cast(level="O2", dtype="bfloat16"):
            _, loss = m(P.to_tensor(ids), masked_lm_labels=P.to_tensor(ids),
                        next_sentence_labels=P.to_tensor(nsp))
        loss.backward()
        o.step()
        o.clear_grad()
    return jm, jo, tm, to


def _values(model, opt):
    out = {}
    for k, v in model.state_dict().items():
        out[f"model.{k}"] = (str(v.dtype).replace("torch.", ""),
                             np.asarray(v.numpy(), np.float32))
    for k, v in opt.state_dict().items():
        if hasattr(v, "shape"):
            out[f"opt.{k}"] = (str(v.dtype).replace("torch.", ""),
                               np.asarray(v.numpy(), np.float32))
        else:
            out[f"opt.{k}"] = v
    return out


def _assert_values_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, tuple):
            assert got[k][0] == v[0], k
            np.testing.assert_array_equal(got[k][1], v[1], err_msg=k)
        else:
            assert got[k] == v, k


def test_a_jax_step_restores_into_the_port_bit_for_bit(tmp_path):
    from paddle_tpu import checkpoint as jck
    from paddle_tpu_torch import checkpoint as ck

    jm, jo, _tm, _to = _bert_pair()
    jck.CheckpointManager(str(tmp_path)).save(
        1, jck.capture_train_state(model=jm, optimizer=jo, step=1))
    state, step = ck.CheckpointManager(str(tmp_path), device="cpu").restore()
    assert step == 1 and state["step"] == 1
    with pytest.raises(ValueError, match="JAX package"):
        ck.set_rng_state_dict(state["rng"])
    del state["rng"]
    pt.seed(5)
    fresh = models.BertForPretraining(models.bert_tiny())
    fopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=fresh.parameters())
    fresh, fopt = amp.decorate(fresh, fopt, level="O2", dtype="bfloat16")
    assert ck.restore_train_state(state, model=fresh, optimizer=fopt) == 1
    _assert_values_equal(_values(fresh, fopt), _values(jm, jo))


def test_a_port_step_restores_into_jax_bit_for_bit(tmp_path):
    from paddle_tpu import checkpoint as jck
    from paddle_tpu_torch import checkpoint as ck

    _jm, _jo, tm, to = _bert_pair()
    ck.CheckpointManager(str(tmp_path), device="cpu").save(
        1, ck.capture_train_state(model=tm, optimizer=to, step=1))
    state, step = jck.CheckpointManager(str(tmp_path)).restore()
    with pytest.raises(KeyError):
        jck.set_rng_state_dict(state["rng"])
    del state["rng"]
    pt.seed(5)
    fresh = fresh_uids(jmodels.BertForPretraining(jmodels.bert_tiny()))
    fopt = pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=fresh.parameters())
    fresh, fopt = jamp.decorate(fresh, fopt, level="O2", dtype="bfloat16")
    assert jck.restore_train_state(state, model=fresh, optimizer=fopt) == 1
    _assert_values_equal(_values(fresh, fopt), _values(tm, to))


@pytest.mark.parametrize("arr", [
    np.float32(3.5).reshape(()), np.arange(12, dtype=np.int64).reshape(3, 4),
    np.array([True, False]), np.zeros((0, 3), np.float32),
    np.arange(6, dtype=np.int16).view(np.uint8),
    np.asfortranarray(np.arange(6.).reshape(2, 3)),
    np.arange(35, dtype=np.float64).reshape(5, 7)[:, ::2],
    np.arange(35, dtype=np.float32).reshape(5, 7).T],
    ids=["0d", "int64", "bool", "empty", "bf16-bytes", "fortran",
         "strided", "transposed"])
def test_shard_files_hold_np_save_bytes(tmp_path, arr):
    """The port writes a shard's header and data itself (one write from
    the array's memory); the file must be ``np.save``'s byte for byte,
    so the JAX package reads it as its own."""
    import io

    from paddle_tpu_torch.distributed.checkpoint import _write_shard_file

    want = io.BytesIO()
    np.save(want, arr, allow_pickle=False)
    path = tmp_path / "x.npy"
    digest = _write_shard_file(str(path), arr)
    assert path.read_bytes() == want.getvalue()
    assert digest == {"size": len(want.getvalue()),
                      "crc32": zlib.crc32(want.getvalue())}
