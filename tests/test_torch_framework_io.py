"""``paddle_tpu_torch.save`` / ``load`` (``framework/io.py``) against the
JAX package's, on the CPU; values compare exactly.

- Round trips of nested state dicts: f32, bf16 bit for bit (its 16-bit
  patterns), ints, bools, ``stop_gradient`` kept, lists, tuples,
  ``OrderedDict`` and plain Python values.
- A ``.pdparams`` written by ``paddle_tpu.save`` (bf16 arrays as
  ``ml_dtypes.bfloat16``) loads in the port, in a fresh interpreter that
  never imports ``paddle_tpu``, ``jax`` or ``ml_dtypes``.
- A pickle naming any other class is refused.
- A save killed at ``ckpt.write``, ``ckpt.fsync`` or ``ckpt.commit``
  leaves the old file whole and no temporary file behind.
- The JAX package cannot read a port file as tensors (it pickles the
  port's payload class): a difference by design (ROADMAP Queue 3).
"""
import collections
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch import faults
from torch_facade_common import on_cpu  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _nested():
    rng = np.random.default_rng(0)
    w = paddle.Tensor(rng.standard_normal((3, 4)).astype("float32"),
                      stop_gradient=False)
    bf = paddle.Tensor(torch.from_numpy(
        rng.standard_normal((2, 5)).astype("float32")).to(torch.bfloat16))
    return collections.OrderedDict([
        ("w", w), ("bf", bf),
        ("ids", paddle.Tensor(np.arange(6, dtype=np.int64).reshape(2, 3))),
        ("mask", paddle.Tensor(np.array([True, False]))),
        ("sub", {"list": [paddle.Tensor(np.float32([1.5])), 3],
                 "tuple": (paddle.Tensor(np.int32([7])), "x")}),
        ("lr", 0.25), ("name", "layer"), ("none", None),
        ("arr", np.arange(4, dtype=np.float64))])


def _check_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _check_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _check_equal(a, b)
    elif isinstance(want, paddle.Tensor):
        assert got._value.dtype == want._value.dtype
        assert torch.equal(got._value, want._value.detach())
        assert got.stop_gradient == want.stop_gradient
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert got == want


def test_nested_round_trip_exact(tmp_path):
    obj = _nested()
    path = str(tmp_path / "sub" / "state.pdparams")
    paddle.save(obj, path)
    got = paddle.load(path)
    _check_equal(got, obj)
    assert got["w"].stop_gradient is False and got["bf"].stop_gradient
    assert got["w"].place == "cpu"
    assert os.listdir(tmp_path / "sub") == ["state.pdparams"]


def test_layer_state_dict_round_trip(tmp_path):
    paddle.seed(0)
    a = paddle.nn.Linear(4, 3)
    paddle.seed(1)
    b = paddle.nn.Linear(4, 3)
    paddle.save(a.state_dict(), str(tmp_path / "l.pdparams"))
    missing, unexpected = b.set_state_dict(
        paddle.load(str(tmp_path / "l.pdparams")))
    assert missing == [] and unexpected == []
    np.testing.assert_array_equal(b.weight.numpy(), a.weight.numpy())


def _jax_state(path):
    pt.seed(3)
    layer = pt.nn.Linear(4, 3)
    sd = dict(layer.state_dict())
    sd["bf"] = pt.to_tensor(np.linspace(-3, 3, 10, dtype=np.float32)
                            .reshape(2, 5)).astype("bfloat16")
    sd["meta"] = {"step": 7, "ids": pt.to_tensor(np.int32([1, 2]))}
    pt.save(sd, path)
    return sd


def test_a_jax_pdparams_loads_in_the_port(tmp_path):
    path = str(tmp_path / "jax.pdparams")
    sd = _jax_state(path)
    got = paddle.load(path)
    assert set(got) == set(sd)
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy())
        assert got[k].stop_gradient == sd[k].stop_gradient
    assert got["bf"]._value.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["bf"]._value.view(torch.int16).numpy().view(np.uint16),
        np.asarray(sd["bf"].numpy()).astype(np.float32).view(np.uint32)
        .__rshift__(16).astype(np.uint16))
    assert got["meta"]["step"] == 7
    assert got["meta"]["ids"]._value.dtype == torch.int32


_FRESH = """
import sys
import numpy as np
import paddle_tpu_torch as paddle
paddle.set_device("cpu")
got = paddle.load(sys.argv[1])
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")]
assert not bad, bad
print(float(got["bf"].numpy().sum()), got["bf"]._value.dtype)
"""


def test_a_jax_file_loads_without_jax_or_ml_dtypes(tmp_path):
    path = str(tmp_path / "jax.pdparams")
    sd = _jax_state(path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", _FRESH, path],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    total, dtype = r.stdout.split()
    assert float(total) == float(np.asarray(sd["bf"].numpy(),
                                            np.float32).sum())
    assert dtype == "torch.bfloat16"


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


@pytest.mark.parametrize("payload", [
    _Evil(), collections.Counter(a=1), torch.zeros(2)],
    ids=["reduce-to-os-system", "foreign-class", "torch-tensor-pickle"])
def test_a_foreign_class_is_refused(tmp_path, payload):
    path = tmp_path / "evil.pdparams"
    with open(path, "wb") as f:
        pickle.dump({"x": payload}, f, protocol=4)
    with pytest.raises(pickle.UnpicklingError, match="refuses"):
        paddle.load(str(path))


@pytest.mark.parametrize("point,sched", [
    ("ckpt.write", {"times": 1}), ("ckpt.fsync", {"times": 1}),
    ("ckpt.commit", {"times": 1})])
def test_a_killed_save_leaves_the_old_file_whole(tmp_path, point, sched):
    path = str(tmp_path / "m.pdparams")
    old = {"w": paddle.Tensor(np.ones((2, 2), np.float32))}
    paddle.save(old, path)
    before = Path(path).read_bytes()
    new = {"w": paddle.Tensor(np.zeros((2, 2), np.float32))}
    try:
        with faults.inject(point, raise_=faults.FaultInjected,
                           **sched) as spec:
            with pytest.raises(faults.FaultInjected):
                paddle.save(new, path)
            assert spec.fired == 1
    finally:
        faults.reset()
    assert Path(path).read_bytes() == before
    assert os.listdir(tmp_path) == ["m.pdparams"]
    np.testing.assert_array_equal(paddle.load(path)["w"].numpy(),
                                  np.ones((2, 2), np.float32))


def test_the_jax_package_cannot_read_a_port_file(tmp_path):
    """The file pickles the port's payload class: where the port is
    importable the JAX ``load`` hands that object back, not a Tensor
    (elsewhere it cannot unpickle it at all)."""
    path = str(tmp_path / "port.pdparams")
    paddle.save({"w": paddle.Tensor(np.ones(2, np.float32))}, path)
    got = pt.load(path)["w"]
    assert not isinstance(got, pt.Tensor)
    assert type(got).__module__ == "paddle_tpu_torch.framework.io"


def test_load_needs_a_card_unless_told(tmp_path, monkeypatch):
    path = str(tmp_path / "x.pdparams")
    paddle.save({"w": paddle.Tensor(np.ones(2, np.float32))}, path)
    paddle.set_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        paddle.load(path)
    assert paddle.load(path, device="cpu")["w"].place == "cpu"
