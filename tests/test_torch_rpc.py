"""The port's ``distributed.rpc`` against the JAX package's
(``tests/test_rpc.py``): one worker calling itself in both packages, the
same calls and the same answers; then one two-process job of the port
(spawned once for the file, ``torch_ps_ranks.rpc_job``) whose workers
call each other, with a tensor on the wire and a remote error.
"""
import numpy as np
import pytest
import torch
from torch_suite import one_torch_thread  # noqa: F401

import paddle_tpu.distributed.rpc as jrpc
import paddle_tpu_torch.distributed.rpc as trpc
from paddle_tpu_torch.distributed._wire import free_port

import torch_ps_ranks


@pytest.fixture(autouse=True)
def on_cpu():
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    yield


def _square(x):
    return x * x


def _raise_value_error():
    raise ValueError("remote boom")


def _loopback(rpc):
    rpc.init_rpc("worker0", rank=0, world_size=1,
                 master_endpoint=f"127.0.0.1:{free_port()}")
    try:
        out = [rpc.rpc_sync("worker0", _square, args=(7,)),
               rpc.rpc_async("worker0", _square, args=(9,)).wait(),
               tuple(rpc.get_worker_info("worker0"))[:2],
               rpc.get_current_worker_info().name,
               [w.name for w in rpc.get_all_worker_infos()]]
        with pytest.raises(ValueError, match="remote boom"):
            rpc.rpc_sync("worker0", _raise_value_error)
        with pytest.raises(ValueError, match="unknown rpc worker"):
            rpc.rpc_sync("nobody", _square, args=(1,))
        with pytest.raises(RuntimeError, match="init_rpc called twice"):
            rpc.init_rpc("again", rank=0, world_size=1,
                         master_endpoint="127.0.0.1:1")
        return out
    finally:
        rpc.shutdown()


def test_single_worker_loopback_as_the_jax_one():
    got = _loopback(trpc)
    assert got == _loopback(jrpc)
    assert got == [49, 81, ("worker0", 0), "worker0", ["worker0"]]
    with pytest.raises(RuntimeError, match="not initialized"):
        trpc.rpc_sync("worker0", _square, args=(1,))


def test_tensors_travel_in_host_form():
    """A torch tensor and a facade Tensor come back as host values of
    their dtype."""
    import paddle_tpu_torch as paddle

    trpc.init_rpc("worker0", rank=0, world_size=1,
                  master_endpoint=f"127.0.0.1:{free_port()}")
    try:
        t = trpc.rpc_sync("worker0", _square,
                          args=(torch.arange(4, dtype=torch.bfloat16),))
        f = trpc.rpc_sync("worker0", _square, args=(
            paddle.to_tensor(np.arange(3, dtype="float32")),))
    finally:
        trpc.shutdown()
    assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
    assert torch.equal(t, torch.arange(4, dtype=torch.bfloat16) ** 2)
    np.testing.assert_array_equal(f.numpy(), [0.0, 1.0, 4.0])


def test_pickler_brings_device_tensors_to_the_host(monkeypatch):
    """What the wire does with a tensor on a device, shown with a CPU
    tensor posing as one (this host has no card)."""
    import pickle

    from paddle_tpu_torch.distributed.rpc import rpc as mod

    seen = []

    class Posing(torch.Tensor):
        @property
        def device(self):
            return torch.device("meta")

        def cpu(self):
            seen.append(1)
            return torch.Tensor(self.as_subclass(torch.Tensor))

    x = torch.arange(3.0).as_subclass(Posing)
    back = pickle.loads(mod._dumps({"x": x}))["x"]
    assert seen == [1] and type(back) is torch.Tensor
    assert torch.equal(back, torch.arange(3.0))


@pytest.fixture(scope="module")
def job():
    from paddle_tpu_torch.distributed import spawn

    ctx = spawn(torch_ps_ranks.rpc_job, args=(free_port(),), nprocs=2,
                backend="cpu")
    return ctx.results()


def test_two_process_job(job):
    for rank in (0, 1):
        r = job[rank]
        assert r["mul"] == (rank + 2) * 10
        assert r["who"] == 1 - rank
        np.testing.assert_array_equal(r["tensor"], [0.0, 2.0, 4.0])
        np.testing.assert_array_equal(r["facade"], [2.0, 2.0])
        assert [w[0] for w in r["infos"]] == ["worker0", "worker1"]
        assert [w[1] for w in r["infos"]] == [0, 1]
        assert r["current"] == f"worker{rank}"
        assert r["error"] == "remote boom"
