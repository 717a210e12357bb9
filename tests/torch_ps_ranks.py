"""Rank-side code of the twins of ``rpc``, fleet's utilities and the
auto-parallel ``Engine``: each function runs in every gloo rank of one
``paddle_tpu_torch.distributed.spawn`` job (one intra-op thread a rank)
and returns numpy. It imports ``paddle_tpu_torch``, torch and numpy
only; the test files hold the results against the JAX package.
"""
import numpy as np


def _np(t):
    v = getattr(t, "_value", t)
    return v.detach().float().numpy().copy()


def mul(a, b):
    return a * b


def twice(t):
    return t * 2


def boom():
    raise ValueError("remote boom")


def whoami():
    import os

    return int(os.environ["PADDLE_TRAINER_ID"])


def rpc_job(port):
    """Two rpc workers calling each other (``tests/test_rpc.py``'s
    two-process job), with tensors and a remote error."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import rpc

    torch.set_num_threads(1)
    import os

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    rpc.init_rpc(f"worker{rank}", rank=rank, world_size=2,
                 master_endpoint=f"127.0.0.1:{port}")
    other = f"worker{1 - rank}"
    out = {"rank": rank,
           "mul": rpc.rpc_sync(other, mul, args=(rank + 2, 10)),
           "who": rpc.rpc_async(other, whoami).wait(),
           "tensor": rpc.rpc_sync(other, twice,
                                  args=(torch.arange(3.0),)).numpy(),
           "facade": _np(rpc.rpc_sync(other, twice, args=(
               paddle.to_tensor(np.ones(2, "float32")),))),
           "infos": [tuple(w) for w in rpc.get_all_worker_infos()],
           "current": rpc.get_current_worker_info().name}
    try:
        rpc.rpc_sync(other, boom)
    except ValueError as e:
        out["error"] = str(e)
    rpc.shutdown()
    return out


# ------------------------------------------------------ fleet utilities
def _mlp(weights, noise=0.0):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    paddle.set_device("cpu")
    (d, h), c = weights["0.weight"].shape, weights["2.weight"].shape[1]
    m = nn.Sequential(nn.Linear(d, h), nn.ReLU(), nn.Linear(h, c))
    m.set_state_dict({k: (v + noise).astype("float32")
                      for k, v in weights.items()})
    return m


def _fleet(dp, mp):
    from paddle_tpu_torch.distributed import fleet, topology

    topology.set_mesh(None)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet


def _grads(m):
    return [_np(p._value.grad) for p in m.parameters()]


def fleet_utils_job(weights, x, y):
    """The broadcasts over ``dp`` and ``mp``, ``fused_allreduce_gradients``
    against ``DataParallel``'s reduction (each rank its half of the
    batch), and ``fleet.util``'s collectives."""
    import torch

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import utils
    from paddle_tpu_torch.nn import functional as F

    torch.set_num_threads(1)
    dist.init_parallel_env(mesh_axes={})
    rank = dist.get_rank()
    fleet = _fleet(2, 1)
    out = {"rank": rank}
    half = slice(rank * 8, (rank + 1) * 8)
    xs, ys = paddle.to_tensor(x[half]), paddle.to_tensor(y[half])

    def loss_of(m):
        return F.cross_entropy(m(xs), ys)

    # seeded apart: the dp broadcast makes rank 0's values everyone's;
    # the mp one does nothing with one rank on mp
    m = _mlp(weights, noise=0.1 * rank)
    utils.broadcast_mp_parameters(m)
    out["after_mp_noop"] = [_np(p) for p in m.parameters()]
    utils.broadcast_dp_parameters(m)
    out["after_dp"] = [_np(p) for p in m.parameters()]
    loss_of(m).backward()
    utils.fused_allreduce_gradients(list(m.parameters()))
    out["fused"] = _grads(m)
    # DataParallel's reduced gradients from the same weights and rows
    ref = _mlp(weights)
    dp = dist.DataParallel(ref)
    loss_of(dp).backward()
    out["dp"] = _grads(ref)
    out["util_sum"] = fleet.util.all_reduce(np.array([rank + 1.0]), "sum")
    out["util_max"] = fleet.util.all_reduce(np.array([rank + 1.0]), "max")
    out["util_gather"] = fleet.util.all_gather(rank * 10)
    fleet.util.barrier()
    out["file_shard"] = fleet.util.get_file_shard([f"f{i}" for i in
                                                   range(5)])
    # mp 2: the mp broadcast now makes rank 0's values everyone's
    _fleet(1, 2)
    m = _mlp(weights, noise=0.1 * rank)
    utils.broadcast_dp_parameters(m)
    out["after_dp_noop_mp2"] = [_np(p) for p in m.parameters()]
    utils.broadcast_mp_parameters(m)
    out["after_mp"] = [_np(p) for p in m.parameters()]
    dist.barrier()
    dist.destroy_process_group()
    return out


# ------------------------------------------------------------- Engine
class Toy:
    """``tests/test_auto_parallel.py``'s ToyDataset over given arrays."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def engine(weights, lr=1e-2):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet import auto
    from paddle_tpu_torch.metric import Accuracy

    paddle.seed(0)
    m = _mlp(weights)
    opt = paddle.optimizer.Adam(learning_rate=lr, parameters=m.parameters())
    return auto.Engine(m, nn.CrossEntropyLoss(), opt,
                       metrics=Accuracy()), m


def engine_job(weights, x, y):
    """``Engine`` at ``dp`` 2 (the default mesh over both ranks): each
    rank's rows, the history, evaluate and predict (gathered), the
    weights; then under an existing dp 1 x mp 2 mesh."""
    import torch

    import paddle_tpu_torch.distributed as dist

    torch.set_num_threads(1)
    eng, m = engine(weights)
    out = {"rank": dist.get_rank() if dist.is_initialized() else None}
    eng._ensure_mesh()
    out["rank"] = dist.get_rank()
    out["mesh_dp"] = dist.get_mesh().shape["dp"]
    out["rows_even"] = _np(eng._shard_batch(x[:16]))
    out["rows_odd"] = _np(eng._shard_batch(x[:15]))
    hist = eng.fit(Toy(x, y), batch_size=16, epochs=2, verbose=0)
    out["loss"] = hist["loss"]
    out["acc"] = hist["acc"]
    out["weights"] = [_np(p) for p in m.parameters()]
    out["eval"] = eng.evaluate(Toy(x, y), batch_size=16, verbose=0)
    out["predict"] = eng.predict(Toy(x[:32], y[:32]), batch_size=16,
                                 verbose=0)
    out["eager_reason"] = eng._steps["train"].eager_reason
    # an existing hybrid mesh is kept, and the model left unwrapped at
    # dp 1: every rank runs the whole batch
    _fleet(1, 2)
    eng2, _ = engine(weights)
    h2 = eng2.fit(Toy(x, y), batch_size=16, epochs=1, verbose=0)
    mesh = dist.get_mesh()
    out["hybrid"] = {"dp": mesh.shape["dp"], "mp": mesh.shape["mp"],
                     "loss": h2["loss"], "wrapped":
                         eng2._network() is not eng2._model}
    dist.barrier()
    dist.destroy_process_group()
    return out
