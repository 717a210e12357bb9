"""The sharded checkpoint across ranks
(``paddle_tpu_torch.distributed.checkpoint``, ``checkpoint.
CheckpointManager``) against the JAX package's
(``tests/test_checkpoint.py:51``, ``:145``, ``:212``;
``tests/test_checkpoint_manager.py:515``).

- The JAX package saves a state under dp2 x mp2 x pp2 (f32 leaves, a bf16
  one, a 0-d step); the port loads it whole here and under a two-rank
  ``shardings=`` in the ranks (a DTensor placement, a ZeRO block, a row
  block), bit for bit.
- The ranks save the port's blocks (DTensors, ZeRO blocks, a pipeline
  stage's rows, replicated leaves) into one directory, raw and through
  ``CheckpointManager`` (rank 0 commits after the other's manifest);
  the JAX package's ``load_state_dict`` reads it under placements of its
  own and its manager restores the committed step, bit for bit; the
  ranks restore it with ``target=``.
- A two-rank ZeRO ``os`` save has the shard ``index`` records of a JAX
  ``sharding`` 2 save of the same shapes.
- A leaf with holes is refused by both packages with the JAX message.
The ranks are spawned once for the file
(``torch_zero_ranks.sharded_checkpoint``).
"""
import json
import os
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.checkpoint import CheckpointManager as JaxManager
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.sharding import _shard_spec_for
from paddle_tpu.distributed.topology import create_mesh
from paddle_tpu.tensor import Tensor as JTensor

import torch_zero_ranks
from torch_suite import one_torch_thread  # noqa: F401

META = "checkpoint.metadata.json"


def _raw():
    rng = np.random.default_rng(0)
    return {"linear1//weight": rng.standard_normal((16, 32)).astype("f4"),
            "linear2//weight": rng.standard_normal((32, 8)).astype("f4"),
            "embedding.weight": rng.standard_normal((64, 16)).astype("f4"),
            "w_bf16": rng.standard_normal((8, 8)).astype("f4"),
            "opt//step": np.asarray(7, dtype="int64")}


def _jax_state(mesh, raw):
    put = lambda a, spec: JTensor(jax.device_put(  # noqa: E731
        a, NamedSharding(mesh, spec)))
    return {"linear1": {"weight": put(raw["linear1//weight"],
                                      P(None, "mp"))},
            "linear2": {"weight": put(raw["linear2//weight"],
                                      P("mp", None))},
            "embedding.weight": put(raw["embedding.weight"],
                                    P("dp", None)),
            "w_bf16": JTensor(jax.device_put(
                raw["w_bf16"], NamedSharding(mesh, P("dp", None)))
                .astype("bfloat16")),
            "opt": {"step": JTensor(raw["opt//step"])}}


def _arrays():
    rng = np.random.default_rng(1)
    bf = rng.standard_normal((6, 8)).astype("f4")
    return {"dt": rng.standard_normal((8, 5)).astype("f4"),
            "bf16_bits": bf.astype(ml_dtypes.bfloat16).view(np.int16),
            "zero": rng.standard_normal((3, 10)).astype("f4"),
            "rows": rng.standard_normal((4, 3, 2)).astype("f4"),
            "plain": rng.standard_normal((5,)).astype("f4")}


def _mlp_data():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((16, 8)).astype("float32"),
            rng.integers(0, 4, (16,)))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX dp2 x mp2 x pp2 save, then the ranks (which load it and
    save theirs)."""
    from paddle_tpu_torch.distributed import spawn

    root = tmp_path_factory.mktemp("sharded")
    jdist.set_mesh(None)
    mesh = create_mesh({"dp": 2, "mp": 2, "pp": 2})
    raw = _raw()
    jckpt.save_state_dict(_jax_state(mesh, raw), str(root / "jax_ck")).wait()
    pt.seed(7)
    import paddle_tpu.nn as jnn
    jm = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    weights = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    x, y = _mlp_data()
    arrays = _arrays()
    ctx = spawn(torch_zero_ranks.sharded_checkpoint,
                args=(str(root / "jax_ck"), arrays, str(root), weights, x, y),
                nprocs=2, join=False, backend="cpu")
    ctx.join()
    res = ctx.results()
    return [res[0], res[1]], raw, arrays, root


def test_port_loads_the_jax_save_whole(job):
    import torch

    from paddle_tpu_torch.distributed import checkpoint as ckpt

    _, raw, _, root = job
    got = ckpt.load_state_dict(str(root / "jax_ck"), device="cpu")
    for key in ("linear1//weight", "linear2//weight", "embedding.weight"):
        a, b = key.split("//") if "//" in key else (key, None)
        v = got[a][b] if b else got[a]
        np.testing.assert_array_equal(v.numpy(), raw[key])
    w = got["w_bf16"]._value
    assert w.dtype == torch.bfloat16
    want = np.asarray(jax.numpy.asarray(raw["w_bf16"]).astype("bfloat16")
                      ).view(np.int16)
    np.testing.assert_array_equal(w.view(torch.int16).numpy(), want)
    assert int(got["opt"]["step"].numpy()) == 7


def test_port_loads_the_jax_save_under_two_ranks(job):
    ranks, raw, _, _ = job
    bf = np.asarray(jax.numpy.asarray(raw["w_bf16"]).astype("bfloat16")
                    ).view(np.int16)
    for r in ranks:
        k, b = r["rank"], r["jax_blocks"]
        assert b["linear1_is_dtensor"]
        np.testing.assert_array_equal(
            b["linear1"], raw["linear1//weight"][:, 16 * k:16 * (k + 1)])
        # ZeRO's rule: [32, 8] on dim 0
        assert b["linear2_index"] == [[16 * k, 16 * (k + 1)], [0, 8]]
        np.testing.assert_array_equal(
            b["linear2"], raw["linear2//weight"][16 * k:16 * (k + 1)])
        np.testing.assert_array_equal(
            b["embedding"], raw["embedding.weight"][32 * k:32 * (k + 1)])
        np.testing.assert_array_equal(b["w_bf16"], bf[4 * k:4 * (k + 1)])
        assert b["step"] == 7


def test_jax_loads_the_port_save_under_its_own_placements(job):
    _, _, arrays, root = job
    mesh = create_mesh({"mp": 8})
    try:
        got = jckpt.load_state_dict(str(root / "port_ck"), shardings={
            "dt": {"weight": NamedSharding(mesh, P("mp", None))},
            "bf16": NamedSharding(mesh, P(None, "mp")),
            "zero": NamedSharding(mesh, P(None, None))})
    finally:
        jdist.set_mesh(None)
    np.testing.assert_array_equal(got["dt"]["weight"].numpy(), arrays["dt"])
    assert got["dt"]["weight"]._value.sharding.spec == P("mp", None)
    b = np.asarray(got["bf16"]._value)
    assert str(b.dtype) == "bfloat16"
    np.testing.assert_array_equal(b.view(np.int16), arrays["bf16_bits"])
    for key in ("zero", "rows", "plain"):
        np.testing.assert_array_equal(np.asarray(got[key].numpy()),
                                      arrays[key])
    assert int(got["step"].numpy()) == 7


def test_each_rank_writes_its_blocks(job):
    """Rank r's manifest lists its own blocks; a replicated leaf is rank
    0's alone; the files are ``<key>.p<rank>.s<i>.npy``."""
    _, _, _, root = job
    d = root / "port_ck"
    m0 = json.loads((d / META).read_text())["leaves"]
    m1 = json.loads((d / (META + ".p1")).read_text())["leaves"]
    assert [s["file"] for s in m0["rows"]["shards"]] == ["rows.p0.s0.npy"]
    assert [s["index"] for s in m1["rows"]["shards"]] == [
        [[2, 4], [0, 3], [0, 2]]]
    assert m0["plain"]["shards"] and not m1["plain"]["shards"]
    assert [s["index"] for s in m1["dt//weight"]
            ["shards"]] == [[[4, 8], [0, 5]]]
    assert m0["bf16"]["dtype"] == "bfloat16"


def test_manager_commits_one_shared_scratch(job):
    """Both ranks wrote ``step_<N>.tmp-shared``; rank 0 committed it
    after rank 1's manifest; the ranks restored it with ``target=``
    and the JAX manager restores it whole, bit for bit."""
    ranks, _, arrays, root = job
    mgr_dir = root / "mgr"
    assert sorted(os.listdir(mgr_dir)) == ["step_00000003"]
    step_dir = mgr_dir / "step_00000003"
    assert (step_dir / "COMMIT").is_file()
    assert (step_dir / (META + ".p1")).is_file()
    for r in ranks:
        assert r["mgr_steps"] == [3]
        got = r["mgr_restored"]
        assert got["step"] == 3 and got["epoch"] == 2
        for k, v in r["own"].items():
            np.testing.assert_array_equal(got[k], v)
        np.testing.assert_array_equal(got["plain"], arrays["plain"])
    state, step = JaxManager(str(mgr_dir)).restore()
    assert step == 3 and state["epoch"] == 2
    np.testing.assert_array_equal(state["dt"]["weight"].numpy(),
                                  arrays["dt"])
    np.testing.assert_array_equal(np.asarray(state["rows"].numpy()),
                                  arrays["rows"])


def test_zero_save_has_the_jax_index_records(job):
    """The ranks' ZeRO ``os`` state (Adam's moments of the Sequential)
    and a JAX save of arrays of those shapes placed by
    ``_shard_spec_for`` over a ``sharding`` 2 mesh list the same blocks."""
    _, _, _, root = job

    def records(d):
        out = {}
        for f in sorted(os.listdir(d)):
            if f.startswith(META) and not f.endswith(".tmp"):
                for k, e in json.loads((d / f).read_text())["leaves"].items():
                    out.setdefault(k, (e["shape"], []))[1].extend(
                        sorted(s["index"] for s in e["shards"]))
        return {k: (shape, sorted(idx)) for k, (shape, idx) in out.items()}

    port = records(root / "zero_ck")
    mesh = create_mesh({"sharding": 2}, devices=jax.devices()[:2])
    try:
        state = {}
        for k, (shape, _) in port.items():
            spec = _shard_spec_for(shape, "sharding", 2, len(shape))
            state[k] = JTensor(jax.device_put(
                np.zeros(shape, "f4"), NamedSharding(mesh, spec)))
        jckpt.save_state_dict(state, str(root / "jax_zero_ck")).wait()
    finally:
        jdist.set_mesh(None)
    jax_rec = records(root / "jax_zero_ck")
    assert any("moment1" in k for k in port)
    assert port == jax_rec


def test_holes_are_refused_by_both(job):
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    _, _, _, root = job
    holed = root / "holed"
    shutil.copytree(root / "port_ck", holed)
    os.remove(holed / (META + ".p1"))
    with pytest.raises(ValueError, match="missing shards"):
        ckpt.load_state_dict(str(holed), device="cpu")
    with pytest.raises(ValueError, match="missing shards"):
        jckpt.load_state_dict(str(holed))


def _port_state():
    import torch

    return {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": {"v": torch.ones(3, dtype=torch.bfloat16)}}


def test_shards_land_before_the_manifest(tmp_path):
    """The twin of ``test_checkpoint.py:145``: a fault at the manifest
    leaves shards and no manifest (a load refuses); one at the first
    shard write leaves no manifest either."""
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    with faults.inject("ckpt.manifest", raise_=faults.FaultInjected,
                       times=1):
        with pytest.raises(faults.FaultInjected):
            ckpt.save_state_dict(_port_state(), str(tmp_path / "ck"))
    assert os.listdir(tmp_path / "ck")
    assert not (tmp_path / "ck" / META).exists()
    with pytest.raises(FileNotFoundError):
        ckpt.load_state_dict(str(tmp_path / "ck"), device="cpu")
    with faults.inject("ckpt.write", raise_=faults.FaultInjected, times=1):
        with pytest.raises(faults.FaultInjected):
            ckpt.save_state_dict(_port_state(), str(tmp_path / "ck2"))
    assert not (tmp_path / "ck2" / META).exists()


def test_every_shard_write_passes_the_fsync_point(tmp_path):
    """The twin of ``test_checkpoint.py:212``."""
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    with faults.inject("ckpt.fsync", delay_s=0.0, call=lambda: None) as spec:
        ckpt.save_state_dict(_port_state(), str(tmp_path / "ck")).wait()
    assert spec.fired >= 3  # two shard files and the manifest


def test_manager_ignores_a_crashed_saves_manifest(job):
    """A crashed save of the same step left rank 1's manifest and shards
    (other values) in the shared scratch, and rank 1 came to the new
    save late: process 0 cleared the scratch and waited for rank 1, so
    the committed step holds rank 1's new blocks, bit for bit."""
    ranks, _, _, root = job
    assert all(r["stale_manifest_planted"] for r in ranks)
    r1 = ranks[1]
    for k, v in r1["own"].items():
        np.testing.assert_array_equal(r1["mgr_restored"][k], v)
    assert not (root / "mgr" / "step_00000003.tmp-shared").exists()


def test_stale_shared_scratch_reaped_only_after_commit(tmp_path):
    """The twin of ``test_checkpoint_manager.py:515``."""
    from paddle_tpu_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), device="cpu")
    (tmp_path / "step_00000001.tmp-shared").mkdir()
    (tmp_path / "step_00000009.tmp-shared").mkdir()
    mgr.save(2, _port_state())
    assert (tmp_path / "step_00000001.tmp-shared").exists()
    mgr.save(3, _port_state())
    assert not (tmp_path / "step_00000001.tmp-shared").exists()
    assert (tmp_path / "step_00000009.tmp-shared").exists()


def test_a_load_reads_only_the_files_its_block_overlaps(job):
    """Without rank 1's rows file a load of rank 0's rows still works (it
    never opens that file), while the whole leaf cannot be read."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.checkpoint import ShardedLeaf

    _, _, arrays, root = job
    part = root / "rows_part"
    shutil.copytree(root / "port_ck", part)
    os.remove(part / "rows.p1.s0.npy")
    rows = arrays["rows"]
    mine = ShardedLeaf(None, rows.shape, [[0, 2], [0, 3], [0, 2]])
    got = ckpt.load_state_dict(str(part), shardings={"rows": mine},
                               device="cpu")
    np.testing.assert_array_equal(got["rows"].local.numpy(), rows[:2])
    with pytest.raises(FileNotFoundError):
        ckpt.load_state_dict(str(part), device="cpu")
