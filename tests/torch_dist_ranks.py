"""Rank-side code of the port's distributed twins: each function runs in
every gloo rank of one ``paddle_tpu_torch.distributed.spawn`` job (one
intra-op thread a rank) and returns its results as numpy. It imports
``paddle_tpu_torch``, torch and numpy only; the test files hold the
results against the JAX package in the pytest process.
"""
import numpy as np


def _init(mesh_axes=None):
    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env(mesh_axes=mesh_axes)
    return dist


def _np(t):
    v = getattr(t, "_value", t)
    return v.detach().float().numpy().copy()


def _fleet(dp=1, mp=1):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


# ------------------------------------------------------- collectives
def collectives(layers):
    """Every case of ``tools/dist_cases.py``, the JAX twins' shard_map
    cases, group ids, then the 2 x 2 mesh: topology, placements,
    reshard, and the four mp layers on its ``mp`` groups of 2
    (:func:`_mp_layers`)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import dist_cases

    dist = _init()
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "cases": dist_cases.run_cases("cpu")}
    P = dist.PartitionSpec
    g = dist.new_group(axis="dp")
    sm = {}
    f = dist.shard_map_fn(lambda x: dist.all_reduce(x, group=g),
                          in_specs=(P("dp"),), out_specs=P())
    sm["all_reduce"] = _np(f(paddle.to_tensor(np.arange(world, dtype="f4"))))
    x = np.arange(world * world * 4 * 4, dtype="f4").reshape(-1, 4)
    f = dist.shard_map_fn(lambda t: dist.alltoall(t, group=g),
                          in_specs=(P("dp"),), out_specs=P("dp"))
    sm["alltoall"] = _np(f(paddle.to_tensor(x)))
    xr = np.tile(np.arange(world, dtype="f4"), (world, 1)).reshape(-1)
    for op in ("sum", "avg"):
        f = dist.shard_map_fn(
            lambda t, op=op: dist.reduce_scatter(t, op=op, group=g),
            in_specs=(P("dp"),), out_specs=P("dp"))
        sm[f"reduce_scatter_{op}"] = _np(f(paddle.to_tensor(xr)))
    f = dist.shard_map_fn(lambda t: dist.gather(t, dst=0, group=g),
                          in_specs=(P("dp"),), out_specs=P())
    sm["gather"] = _np(f(paddle.to_tensor(np.arange(world, dtype="f4"))))

    def ring(t):
        ops = [dist.P2POp(dist.isend, t, 1, group=g),
               dist.P2POp(dist.irecv, t, -1, group=g)]
        return dist.batch_isend_irecv(ops)[0]

    f = dist.shard_map_fn(ring, in_specs=(P("dp"),), out_specs=P("dp"))
    sm["ring"] = _np(f(paddle.to_tensor(np.arange(world, dtype="f4"))))
    f = dist.shard_map_fn(
        lambda t: dist.communication.stream.all_reduce(
            t, group=g, use_calc_stream=True),
        in_specs=(P("dp"),), out_specs=P())
    sm["stream"] = _np(f(paddle.to_tensor(np.ones(world, "f4"))))
    out["shard_map"] = sm
    g1 = dist.new_group(list(range(world)))
    g2 = dist.new_group([0, 1])
    t = paddle.to_tensor(np.full(2, rank + 1.0, "f4"))
    if rank in g2.ranks:
        dist.all_reduce(t, group=g2)
    out["groups"] = {"ids": [g.id, g1.id, g2.id],
                     "get_group": dist.get_group(g2.id) is g2,
                     "g2_sum": _np(t), "g2_rank": g2.rank}

    # the 2 x 2 mesh
    hcg = _fleet(dp=2, mp=2)
    mesh = dist.get_mesh()
    out["topology"] = {
        "dp": hcg.get_data_parallel_world_size(),
        "mp": hcg.get_model_parallel_world_size(),
        "pp": hcg.get_pipe_parallel_world_size(),
        "mesh_mp": mesh.shape["mp"], "axes": list(mesh.axis_names),
        "dp_rank": hcg.get_data_parallel_rank(),
        "mp_rank": hcg.get_model_parallel_rank(),
        "dp_group": hcg.get_data_parallel_group().ranks,
        "mp_group": hcg.get_model_parallel_group().ranks,
        "created": dist.create_mesh({"dp": -1, "mp": 2}).shape["dp"]}
    xs = np.arange(64, dtype="f4").reshape(8, 8)
    a = dist.shard_tensor(paddle.to_tensor(xs),
                          placements=[dist.Shard(0), dist.Replicate()])
    b = dist.shard_tensor(paddle.to_tensor(xs),
                          placements=[dist.Shard(0), dist.Shard(1)])
    c = dist.reshard(b, placements=[dist.Replicate(), dist.Replicate()])
    pm = dist.ProcessMesh([[0, 1], [2, 3]], dim_names=["x", "y"])
    d = dist.shard_tensor(paddle.to_tensor(xs), mesh=pm,
                          placements=[dist.Shard(0), dist.Shard(1)])
    e = dist.reshard(d, mesh=pm, placements=[dist.Replicate(),
                                             dist.Replicate()])
    out["placements"] = {
        "a_local": list(a._value.to_local().shape),
        "a_full": _np(a._value.full_tensor()),
        "b_local": list(b._value.to_local().shape),
        "c_local": _np(c._value.to_local()),
        "d_local": _np(d._value.to_local()),
        "e_local": _np(e._value.to_local()),
        "dist_attr": repr(a.dist_attr)}
    out["mp_layers"] = _mp_layers(layers, hcg)
    dist.barrier()
    dist.destroy_process_group()
    return out


# ----------------------------------------------------- DataParallel
def _mlp(weights):
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn

    m = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    m.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    return m


def _train(model, opt, x, y, steps=3):
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F

    for _ in range(steps):
        loss = F.cross_entropy(model(paddle.to_tensor(x)),
                               paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()


def _params(model):
    return [_np(p) for p in model.parameters()]


def data_parallel(weights, x, y, models):
    """DataParallel on two ranks (each its half of the batch), over a
    one-rank group (against the plain step, bit for bit), ``no_sync`` and
    ``find_unused_parameters``; then ``models`` at ``mp`` 2
    (:func:`_tp_models`)."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.nn.functional as F

    dist = _init()
    rank, world = dist.get_rank(), dist.get_world_size()
    half = len(x) // world
    xs, ys = x[rank * half:(rank + 1) * half], y[rank * half:(rank + 1) * half]
    out = {"rank": rank}

    def momentum(m):
        return paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                         parameters=m.parameters())

    m = _mlp(weights)
    dp = paddle.DataParallel(m)
    _train(dp, momentum(m), xs, ys)
    out["dp"] = _params(m)
    out["comm"] = dp.comm_stats()

    # one-rank groups (every rank makes every group)
    mine = None
    for r in range(world):
        g = dist.new_group([r])
        if r == rank:
            mine = g
    a, b = _mlp(weights), _mlp(weights)
    dpa = paddle.DataParallel(a, group=mine)
    _train(dpa, momentum(a), xs, ys)
    _train(b, momentum(b), xs, ys)
    out["one_rank_equal"] = all(
        np.array_equal(p, q) for p, q in zip(_params(a), _params(b)))
    out["one_rank_all_reduces"] = dpa.comm_stats()["all_reduces"]

    # no_sync: the first backward stays local, the second reduces both
    m = _mlp(weights)
    dp = paddle.DataParallel(m)
    with dp.no_sync():
        F.cross_entropy(dp(paddle.to_tensor(xs)),
                        paddle.to_tensor(ys)).backward()
    out["no_sync_grads"] = [_np(p.grad) for p in m.parameters()]
    out["no_sync_all_reduces"] = dp.comm_stats()["all_reduces"]
    F.cross_entropy(dp(paddle.to_tensor(xs[::-1].copy())),
                    paddle.to_tensor(ys[::-1].copy())).backward()
    out["synced_grads"] = [_np(p.grad) for p in m.parameters()]

    # find_unused_parameters: a branch no forward reaches
    class Two(nn.Layer):
        def __init__(self):
            super().__init__()
            self.used = nn.Linear(8, 4)
            self.unused = nn.Linear(8, 4)

        def forward(self, t):
            return self.used(t)

    paddle.seed(3)
    two = Two()
    dpu = paddle.DataParallel(two, find_unused_parameters=True)
    for _ in range(2):
        dpu(paddle.to_tensor(xs)).sum().backward()
    out["unused_grad"] = _np(two.unused.weight.grad)
    out["used_grad_finite"] = bool(np.isfinite(_np(two.used.weight.grad))
                                   .all())
    strict = paddle.DataParallel(Two())
    strict(paddle.to_tensor(xs)).sum().backward()
    try:
        strict(paddle.to_tensor(xs))
        out["strict_error"] = None
    except RuntimeError as e:
        out["strict_error"] = str(e)
    out["tp"] = _tp_models(models, _fleet(mp=2))
    dist.barrier()
    dist.destroy_process_group()
    return out


# ------------------------------------------------ tensor parallelism
def _shard(full, dim, rank, n=2, pieces=1):
    parts = np.split(full, pieces, axis=dim)
    return np.concatenate([np.split(p, n, axis=dim)[rank] for p in parts],
                          axis=dim)


def _gather(local, dim, group, pieces=1):
    import torch

    from paddle_tpu_torch.models.convert import gather_shard

    return gather_shard(torch.as_tensor(local), dim, pieces, group).numpy()


def _mp_layers(layers, hcg):
    """The four mp layers on this rank's ``mp`` group, forward and
    backward, over this rank's shards of ``layers``' whole weights (the
    gradients gathered whole)."""
    import torch

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.distributed import fleet

    rank = hcg.get_model_parallel_rank()
    group = hcg.get_model_parallel_group()
    out = {}

    def param(v, trainable=True):
        return paddle.Parameter(torch.as_tensor(v), trainable=trainable)

    # column -> relu -> row (the Megatron MLP)
    L = layers["mlp"]
    col = fleet.ColumnParallelLinear(16, 32, gather_output=False)
    row = fleet.RowParallelLinear(32, 8, input_is_parallel=True)
    col.weight = param(_shard(L["w1"], 1, rank))
    col.bias = param(_shard(L["b1"], 0, rank))
    row.weight = param(_shard(L["w2"], 0, rank))
    row.bias = param(L["b2"])
    x = paddle.to_tensor(L["x"], stop_gradient=False)
    y = row(F.relu(col(x)))
    y.sum().backward()
    out["mlp"] = {"out": _np(y), "x_grad": _np(x.grad),
                  "w1_grad": _gather(_np(col.weight.grad), 1, group),
                  "b1_grad": _gather(_np(col.bias.grad), 0, group),
                  "w2_grad": _gather(_np(row.weight.grad), 0, group),
                  "b2_grad": _np(row.bias.grad)}
    # gather_output / split input
    colg = fleet.ColumnParallelLinear(16, 32, gather_output=True)
    rows = fleet.RowParallelLinear(32, 8, input_is_parallel=False)
    colg.weight = param(_shard(L["w1"], 1, rank))
    colg.bias = param(_shard(L["b1"], 0, rank))
    rows.weight = param(_shard(L["w2"], 0, rank))
    rows.bias = param(L["b2"])
    out["mlp_gathered"] = _np(rows(F.relu(colg(paddle.to_tensor(L["x"])))))
    out["split_shape"] = list(dist.split(paddle.to_tensor(L["x"]), (16, 32),
                                         "linear", axis=1).shape)
    # vocab-parallel embedding
    E = layers["embedding"]
    vpe = fleet.VocabParallelEmbedding(32, 16)
    vpe.weight = param(_shard(E["w"], 0, rank))
    e = vpe(paddle.to_tensor(E["ids"]))
    (e * e).sum().backward()
    out["embedding"] = {"out": _np(e),
                        "w_grad": _gather(_np(vpe.weight.grad), 0, group)}
    # parallel cross entropy over class-sharded logits
    C = layers["ce"]
    logits = paddle.to_tensor(_shard(C["logits"], 1, rank),
                              stop_gradient=False)
    loss = fleet.ParallelCrossEntropy()(logits, paddle.to_tensor(C["labels"]))
    loss.sum().backward()
    out["ce"] = {"loss": _np(loss),
                 "grad": _gather(_np(logits.grad), 1, group)}

    return out


def tensor_parallel(models):
    """:func:`_tp_models` on a job of its own."""
    dist = _init(mesh_axes={})
    out = _tp_models(models, _fleet(mp=2))
    dist.barrier()
    dist.destroy_process_group()
    return out


def _tp_models(models, hcg):
    """Each tiny model of ``models`` at ``mp`` 2 with its JAX weights
    split in: the loss, the logits and the gradients gathered whole."""
    import torch

    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny,
                                         load_reference_state_dict)
    from paddle_tpu_torch.models.convert import _shards, gather_shard

    group = hcg.get_model_parallel_group()
    out = {"rank": hcg.get_model_parallel_rank()}

    builders = {"gpt": (GPTForCausalLM, gpt_tiny),
                "llama": (LlamaForCausalLM, llama_tiny)}
    for name, spec in models.items():
        cls, tiny = builders[name]
        model = cls(tiny(**spec["config"]), device="cpu", seed=1)
        load_reference_state_dict(model, spec["weights"])
        ids, labels = spec["ids"], spec["labels"]
        logits, loss = model(torch.from_numpy(ids),
                             labels=torch.from_numpy(labels))
        loss.backward()
        shards = _shards(model)
        linear = {f"{n}.weight" for n, m in model.named_modules()
                  if isinstance(m, torch.nn.Linear)}
        grads = {}
        for n, p in model.named_parameters():
            g = p.grad.detach()
            m = shards.get(n)
            if m is not None:
                g = gather_shard(g, m.shard_dim if g.dim() > 1 else 0,
                                 m.shard_pieces, m.group)
            g = g.numpy()
            grads[n] = g.T if n in linear else g
        out[name] = {"loss": float(loss.detach()),
                     "logits": gather_shard(logits.detach(), -1, 1,
                                            group).numpy()
                     if logits.shape[-1] != spec["vocab"] else
                     logits.detach().numpy(),
                     "grads": grads,
                     "heads": model.config.num_heads // 2}
    return out
