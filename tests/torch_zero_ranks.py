"""Rank-side code of the ZeRO, sharded-checkpoint and pipeline twins:
each function runs in every gloo rank of one
``paddle_tpu_torch.distributed.spawn`` job (one intra-op thread a rank)
and returns numpy. It imports ``paddle_tpu_torch``, torch and numpy
only; the test files hold the results against the JAX package in the
pytest process.
"""
import os
import time

import numpy as np

LEVELS = ("os", "os_g", "p_g_os")


def _init(mesh_axes=None):
    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env(mesh_axes=mesh_axes)
    return dist


def _np(t):
    v = getattr(t, "_value", t)
    return v.detach().float().numpy().copy()


# ------------------------------------------------------------- ZeRO
def _mlp(weights):
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn

    m = nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 4))
    m.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    return m


def _adam(m, clip=None):
    import paddle_tpu_torch as paddle

    return paddle.optimizer.Adam(learning_rate=1e-2,
                                 parameters=m.parameters(), grad_clip=clip)


def _train(model, opt, x, y, steps=3):
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F

    for _ in range(steps):
        loss = F.cross_entropy(model(paddle.to_tensor(x)),
                               paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()


def _whole_params(model):
    """Every parameter whole (a ``p_g_os`` model's blocks gathered)."""
    from paddle_tpu_torch.distributed.sharding import _whole

    group = getattr(model, "_group", None)
    sd = model.state_dict()
    return [_np(_whole(v, group)) for v in sd.values()]


def _state(opt):
    """``{key: (index, local shape, global shape, nbytes)}`` of an
    optimizer's state dict, and its total bytes on this rank."""
    from paddle_tpu_torch.distributed.checkpoint import ShardedLeaf

    out, total = {}, 0
    for k, v in opt.state_dict().items():
        if not k.startswith("pos:"):
            continue
        if isinstance(v, ShardedLeaf):
            n = v.local.numel() * v.local.element_size()
            out[k] = (v.index, list(v.local.shape), list(v.shape), n)
        else:
            n = v.numel() * v.element_size()
            out[k] = (None, list(v.shape), list(v.shape), n)
        total += n
    return out, total


def group_sharded(weights, x, y, outdir):
    """``DataParallel`` and each ZeRO level from the same weights, each
    rank its half of the batch, Adam 1e-2 and 3 steps; a clipped pair;
    ``fleet.distributed_optimizer`` with ``strategy.sharding``;
    ``save_group_sharded_model``."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet, sharding
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    dist = _init()
    rank = dist.get_rank()
    xs, ys = x[rank * 8:(rank + 1) * 8], y[rank * 8:(rank + 1) * 8]
    out = {"rank": rank}
    m = _mlp(weights)
    dp, o = dist.DataParallel(m), _adam(m)
    _train(dp, o, xs, ys)
    out["dp"] = [_np(p) for p in m.parameters()]
    out["dp_state"] = _state(o)
    for level in LEVELS:
        m = _mlp(weights)
        w, o = dist.group_sharded_parallel(m, _adam(m), level=level)
        _train(w, o, xs, ys)
        out[level] = _whole_params(w)
        out[level + "_state"] = _state(o)
        out[level + "_resident"] = w.resident_parameter_bytes()
    out["full_param_bytes"] = sum(p._value.numel() * p._value.element_size()
                                  for p in m.parameters())
    # global-norm clipping: os against DP's clipped step bit for bit, os_g
    # (squares summed over the blocks) within a tolerance
    for level in ("dp", "os", "os_g"):
        m = _mlp(weights)
        o = _adam(m, ClipGradByGlobalNorm(0.05))
        w = dist.DataParallel(m) if level == "dp" else \
            dist.group_sharded_parallel(m, o, level=level)[0]
        _train(w, o, xs, ys)
        out["clip_" + level] = [_np(p) for p in m.parameters()]
    # fleet: strategy.sharding shards the state of a DataParallel model
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2}
    strategy.sharding = True
    fleet.init(is_collective=True, strategy=strategy)
    m = _mlp(weights)
    w = fleet.distributed_model(m)
    o = fleet.distributed_optimizer(_adam(m))
    _train(w, o, xs, ys)
    out["fleet"] = [_np(p) for p in m.parameters()]
    out["fleet_sharded"] = o._zero is not None
    # fleet at sharding_degree 2 (dp 1): the gradients averaged over the
    # sharding axis, the state sharded over it
    out["fleet_sharding2"] = _fleet_sharded(weights, xs, ys, {
        "sharding_degree": 2})
    out["freed"] = _freed_after_use(weights, xs, ys)
    # save_group_sharded_model: the blocks gathered, rank 0 writes
    m = _mlp(weights)
    w, o = dist.group_sharded_parallel(m, _adam(m), level="p_g_os")
    _train(w, o, xs, ys)
    sharding.save_group_sharded_model(w, os.path.join(outdir, "saved"), o)
    dist.barrier()
    out["saved_files"] = sorted(os.listdir(os.path.join(outdir, "saved")))
    out["saved_whole"] = _whole_params(w)
    path = os.path.join(outdir, "a_file")
    if rank == 0:
        open(path, "w").close()
    dist.barrier()
    try:
        sharding.save_group_sharded_model(w, path, o)
        out["file_refused"] = ""
    except AssertionError as e:
        out["file_refused"] = str(e)
    dist.barrier()
    dist.destroy_process_group()
    return out


def _fleet_sharded(weights, xs, ys, hybrid):
    """``fleet`` with ``strategy.sharding`` on the mesh ``hybrid``: the
    wrapper's type, the state's ZeRO group size and the parameters after
    3 steps."""
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(hybrid)
    strategy.sharding = True
    fleet.init(is_collective=True, strategy=strategy)
    m = _mlp(weights)
    w = fleet.distributed_model(m)
    o = fleet.distributed_optimizer(_adam(m))
    _train(w, o, xs, ys)
    return {"wrapper": type(w).__name__, "zero_ranks": o._zero.n,
            "params": [_np(p) for p in m.parameters()]}


def _freed_after_use(weights, xs, ys):
    """Whether a model's parameters are freed once it, its wrapper and
    its optimizer are dropped after a step, for ``DataParallel`` and each
    ZeRO level (the wrappers' gradient hooks hold them weakly)."""
    import gc
    import weakref

    import paddle_tpu_torch.distributed as dist

    out = {}
    for level in ("dp",) + LEVELS:
        m = _mlp(weights)
        o = _adam(m)
        w = dist.DataParallel(m) if level == "dp" else \
            dist.group_sharded_parallel(m, o, level=level)[0]
        _train(w, o, xs, ys, steps=1)
        refs = [weakref.ref(p._value) for p in m.parameters()]
        del m, o, w
        gc.collect()
        out[level] = sum(r() is not None for r in refs)
    return out


def group_sharded_hybrid(weights, x, y):
    """Four ranks on a ``dp`` 2 x ``sharding`` 2 mesh, each its quarter
    of the batch: ``group_sharded_parallel`` at each level and ``fleet``
    with ``strategy.sharding``; ``DataParallel`` over all four."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import topology

    dist = _init(mesh_axes={"dp": 2, "sharding": 2})
    coord = topology.get_mesh().coordinate()
    q = coord["dp"] * 2 + coord["sharding"]
    xs, ys = x[q * 4:(q + 1) * 4], y[q * 4:(q + 1) * 4]
    out = {"rank": dist.get_rank(), "coord": coord}
    for level in LEVELS:
        m = _mlp(weights)
        w, o = dist.group_sharded_parallel(m, _adam(m), level=level)
        _train(w, o, xs, ys)
        out[level] = _whole_params(w)
        out[level + "_zero_ranks"] = o._zero.n
    m = _mlp(weights)
    dp, o = dist.DataParallel(m, group=topology.world_group()), _adam(m)
    _train(dp, o, xs, ys)
    out["dp"] = [_np(p) for p in m.parameters()]
    out["fleet"] = _fleet_sharded(weights, xs, ys, {"dp_degree": 2,
                                                    "sharding_degree": 2})
    dist.barrier()
    dist.destroy_process_group()
    return out


def rendezvous_job():
    """One all-reduce over the job; the rendezvous port it used."""
    import torch

    dist = _init(mesh_axes={})
    t = torch.ones(1)
    dist.all_reduce(t)
    out = (float(t), int(os.environ["MASTER_PORT"]),
           os.environ.get("PADDLE_MASTER_HOSTED"))
    dist.destroy_process_group()
    return out


# ------------------------------------------------- sharded checkpoint
def _bits(t):
    """A tensor's values as numpy, a bf16 one by its 16-bit patterns."""
    import torch

    v = getattr(t, "_value", t)
    if hasattr(v, "to_local"):
        v = v.to_local()
    v = v.detach()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy().copy()
    return v.numpy().copy()


def port_state(arrays, rank):
    """The state the ranks save: a DTensor sharded on dim 0 and a bf16
    one on dim 1 over a one-dim ProcessMesh, ZeRO blocks of ``zero``, a
    pipeline stage's rows of ``rows`` and two replicated leaves."""
    import torch

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import ShardedLeaf
    from paddle_tpu_torch.distributed.sharding import zero_placement

    pm = dist.ProcessMesh([0, 1], dim_names=["x"])
    z = zero_placement(arrays["zero"].shape)
    rows = arrays["rows"]
    n = rows.shape[0] // 2
    bf = torch.from_numpy(arrays["bf16_bits"]).view(torch.bfloat16)
    return {
        "dt": {"weight": dist.shard_tensor(
            paddle.to_tensor(arrays["dt"]), mesh=pm,
            placements=[dist.Shard(0)])},
        "bf16": dist.shard_tensor(paddle.to_tensor(bf), mesh=pm,
                                  placements=[dist.Shard(1)]),
        "zero": ShardedLeaf(torch.from_numpy(arrays["zero"])[
            tuple(slice(a, b) for a, b in z.index)].clone(),
            arrays["zero"].shape, z.index),
        "rows": ShardedLeaf(torch.from_numpy(rows[rank * n:(rank + 1) * n]),
                            rows.shape, [[rank * n, (rank + 1) * n]]
                            + [[0, d] for d in rows.shape[1:]]),
        "plain": torch.from_numpy(arrays["plain"]),
        "step": torch.tensor(7),
    }


def sharded_checkpoint(jax_dir, arrays, outdir, weights, x, y):
    """Load the JAX package's dp2 x mp2 x pp2 save under this job's
    placements; save :func:`port_state` from both ranks (raw and through
    ``CheckpointManager``); save a ZeRO ``os`` optimizer's state."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.checkpoint import ShardedLeaf
    from paddle_tpu_torch.distributed.sharding import zero_placement

    dist = _init()
    rank = dist.get_rank()
    out = {"rank": rank}
    pm = dist.ProcessMesh([0, 1], dim_names=["x"])
    shardings = {
        "linear1": {"weight": (pm, [dist.Shard(1)])},
        "linear2": {"weight": zero_placement((32, 8))},
        "embedding.weight": ShardedLeaf(None, (64, 16),
                                        [[rank * 32, (rank + 1) * 32],
                                         [0, 16]]),
        "w_bf16": (pm, [dist.Shard(0)]),
    }
    got = ckpt.load_state_dict(jax_dir, shardings=shardings, device="cpu")
    out["jax_blocks"] = {
        "linear1": _bits(got["linear1"]["weight"]),
        "linear1_is_dtensor": hasattr(got["linear1"]["weight"]._value,
                                      "to_local"),
        "linear2": _bits(got["linear2"]["weight"].local),
        "linear2_index": got["linear2"]["weight"].index,
        "embedding": _bits(got["embedding.weight"].local),
        "w_bf16": _bits(got["w_bf16"]),
        "step": int(got["opt"]["step"].numpy())}
    state = port_state(arrays, rank)
    ckpt.save_state_dict(state, os.path.join(outdir, "port_ck")).wait()
    # a crashed save of step 3 left its shared scratch: rank 1's shards
    # of other values and its manifest; rank 1 then comes late to the
    # save, so a commit on the stale manifest would publish them
    stale = port_state({k: v + 1 for k, v in arrays.items()}, rank)
    if rank == 1:
        ckpt.save_state_dict(stale, os.path.join(
            outdir, "mgr", "step_00000003.tmp-shared")).wait()
    dist.barrier()
    out["stale_manifest_planted"] = os.path.isfile(os.path.join(
        outdir, "mgr", "step_00000003.tmp-shared",
        "checkpoint.metadata.json.p1"))
    if rank == 1:
        time.sleep(1.0)
    mgr = CheckpointManager(os.path.join(outdir, "mgr"), device="cpu")
    mgr.save(3, dict(state, epoch=2))
    dist.barrier()
    out["mgr_steps"] = mgr.all_steps()
    back, step = mgr.restore(target=state)
    out["mgr_restored"] = {
        "step": step, "epoch": back["epoch"],
        "dt": _bits(back["dt"]["weight"]), "bf16": _bits(back["bf16"]),
        "zero": _bits(back["zero"].local), "rows": _bits(back["rows"].local),
        "plain": _bits(back["plain"])}
    out["own"] = {"dt": _bits(state["dt"]["weight"]),
                  "bf16": _bits(state["bf16"]),
                  "zero": _bits(state["zero"].local),
                  "rows": _bits(state["rows"].local)}
    # a ZeRO os optimizer's state, saved by both ranks
    m = _mlp(weights)
    w, o = dist.group_sharded_parallel(m, _adam(m), level="os")
    _train(w, o, x[rank * 8:(rank + 1) * 8], y[rank * 8:(rank + 1) * 8], 1)
    sd = {k: v for k, v in o.state_dict().items() if k.startswith("pos:")}
    ckpt.save_state_dict(sd, os.path.join(outdir, "zero_ck")).wait()
    dist.barrier()
    dist.destroy_process_group()
    return out


# ------------------------------------------------------------ pipelines
def _block_cls():
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.nn.functional as F

    class Block(nn.Layer):
        def __init__(self, h=16):
            super().__init__()
            self.lin = nn.Linear(h, h)
            self.ln = nn.LayerNorm(h)

        def forward(self, x):
            return x + F.gelu(self.lin(self.ln(x)))

    return Block


def _pp(pp, acc=1, schedule=None):
    from paddle_tpu_torch.distributed import fleet, topology

    topology.set_mesh(None)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": pp, "accumulate_steps": acc}
    if schedule:
        strategy.pipeline_configs = {"schedule_mode": schedule}
    fleet.init(is_collective=True, strategy=strategy)
    return strategy


def _stack(stacked, L, vpp=1):
    """A port stack of ``L`` blocks holding this stage's rows of the JAX
    stack's ``stacked`` arrays."""
    from paddle_tpu_torch.distributed.fleet import StackedPipelineBlocks

    Block = _block_cls()
    st = StackedPipelineBlocks(lambda: Block(16), L, remat=False, vpp=vpp)
    missing, _ = st.set_state_dict(stacked)
    assert not missing, missing
    return st


def _rows(st):
    return {"rows": list(st.rows), "stage": st._stage,
            "grads": [_np(p.grad) for p in st.stacked]}


def _linear(w):
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn

    lin = nn.Linear(*w["weight"].shape)
    lin.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
    return lin


def pipelines(w, x16, y16, outdir):
    """Every pipeline case on four ranks (``pp`` 4, or 2 with ``dp`` 2):
    ``w`` holds the JAX stacks' and layers' weights; the stages' rows
    are saved under ``outdir``."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import (LayerDesc,
                                                    PipelineLayer,
                                                    pipeline_1f1b_train)
    from paddle_tpu_torch.distributed.fleet.pipeline_schedule import \
        StackedPipelineBlocks

    dist = _init(mesh_axes={})
    out = {"rank": dist.get_rank()}
    T = paddle.to_tensor
    x8 = x16[:8]
    _pp(2)  # dp 2 x pp 2: the stage and its neighbours
    hcg = fleet.get_hybrid_communicate_group()
    out["hcg"] = (hcg.get_stage_id(), hcg.is_first_stage(),
                  hcg.is_last_stage(), hcg._get_p2p_next_rank(),
                  hcg._get_p2p_prev_rank(), hcg.get_pipe_parallel_group().ranks)
    # the pipelined forward at pp 4 (8 layers, 4 microbatches)
    _pp(4)
    st = _stack(w["fwd_stack"], 8)
    out["fwd"] = _np(st(T(x8), num_microbatches=4))
    # the stages' rows as blocks of the [L, ...] leaves: saved by the four
    # ranks, loaded back into zeroed rows through target=
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    path = os.path.join(outdir, "stack_ck")
    ckpt.save_state_dict(st.state_dict(), path).wait()
    dist.barrier()
    kept = [_np(p) for p in st.stacked]
    for p in st.stacked:
        p._value.data.zero_()
    back = ckpt.load_state_dict(path, target=st.state_dict(), device="cpu")
    st.set_state_dict(back)
    out["stack_reload_equal"] = all(
        np.array_equal(_np(p), k) for p, k in zip(st.stacked, kept))
    # gradients through the pipeline at pp 2 (2 microbatches)
    _pp(2)
    st = _stack(w["grad_stack"], 4)
    o = st(T(x8), num_microbatches=2)
    (o * o).mean().backward()
    out["grad"] = _rows(st)
    # 1F1B: pp 4 with M 4, pp 2 with M 8
    for name, pp, L, M, x, y in (("1f1b_pp4", 4, 8, 4, x8, y16[:8]),
                                 ("1f1b_pp2", 2, 4, 8, x16, y16)):
        _pp(pp)
        ws = w[name]
        st = _stack(ws["stack"], L)
        prefix, head = _linear(ws["prefix"]), _linear(ws["head"])
        loss = pipeline_1f1b_train(
            st, T(x), T(y), lambda out_, lab: F.cross_entropy(head(out_), lab),
            num_microbatches=M, prefix=prefix)
        out[name] = dict(_rows(st), loss=float(loss.numpy()),
                         in_flight=st._in_flight_max,
                         prefix=[_np(p.grad) for p in prefix.parameters()],
                         head=[_np(p.grad) for p in head.parameters()])
    # train_batch through the strategy: pp 4, accumulate 4, 1F1B and
    # F-then-B, Adam, 6 steps
    for schedule in ("1F1B", "F-then-B"):
        strategy = _pp(4, acc=4, schedule=schedule)
        ws = w["train_batch"]
        st = _stack(ws["stack"], 4)
        head = _linear(ws["head"])
        model = PipelineLayer(layers=[st, head],
                              loss_fn=lambda o_, lab: F.cross_entropy(o_, lab))
        wrapped = fleet.distributed_model(model)
        opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                    parameters=model.parameters())
        out["train_batch_" + schedule] = [
            float(wrapped.train_batch((T(x8), T(y16[:8])), opt).numpy())
            for _ in range(6)]
        out["wrapped_" + schedule] = (type(wrapped).__name__,
                                      wrapped._schedule_mode)
    # the grad scaler (pp 2, accumulate 2, 1F1B, SGD 0.1): a scaled run
    # against an unscaled one from the same weights
    from paddle_tpu_torch import amp

    runs = []
    for scaled in (True, False):
        strategy = _pp(2, acc=2, schedule="1F1B")
        ws = w["scaler"]
        st = _stack(ws["stack"], 2)
        head = _linear(ws["head"])
        model = PipelineLayer(
            layers=[st],
            loss_fn=lambda o_, lab, h=head: F.cross_entropy(h(o_), lab))
        wrapped = fleet.PipelineParallel(model, strategy=strategy)
        params = model.parameters() + head.parameters()
        opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=params)
        scaler = amp.GradScaler(init_loss_scaling=1024.0) if scaled else None
        loss = float(wrapped.train_batch((T(x16[:4]), T(y16[:4])), opt,
                                         scaler=scaler).numpy())
        runs.append((loss, [_np(p) for p in params],
                     model.stage_layers(0) == model.stage_layers(1)))
    out["scaler"] = runs
    # VPP 2 at pp 2: the forward and the gradients (8 layers, M 4)
    _pp(2)
    st = _stack(w["vpp_stack"], 8, vpp=2)
    o = st(T(x8), num_microbatches=4)
    out["vpp_fwd"] = _np(o)
    out["vpp_order"] = list(st.layer_order)
    (o * o).mean().backward()
    out["vpp_grad"] = _rows(st)
    # the two raises
    _pp(4)
    Block = _block_cls()
    st = StackedPipelineBlocks(lambda: Block(16), 8, vpp=2)
    try:
        st(T(np.zeros((4, 16), "f4")), num_microbatches=2)
        out["raise_microbatches"] = ""
    except ValueError as e:
        out["raise_microbatches"] = str(e)
    _pp(2)
    try:
        StackedPipelineBlocks(lambda: Block(16), 6, vpp=4)
        out["raise_divisible"] = ""
    except ValueError as e:
        out["raise_divisible"] = str(e)
    # a segmented PipelineLayer (each stage builds its own layers): its
    # pipelined forward
    descs = [LayerDesc(Block, 16) for _ in range(4)]
    model = PipelineLayer(layers=descs, num_stages=2,
                          loss_fn=lambda o_, lab: (o_ * o_).mean())
    out["segmented_built"] = sum(f is not None for f in model.run_funcs)
    sd = {f"{i}.{k}": T(v) for i, blk in enumerate(w["segmented"])
          for k, v in blk.items() if model.run_funcs[i] is not None}
    model.set_state_dict(sd)
    out["segmented_fwd"] = _np(model(T(x8)))
    # a shared layer at both ends (tied), each stage building its half:
    # one SGD step through train_batch, both schedules
    for schedule in ("F-then-B", "1F1B"):
        strategy = _pp(2, acc=2, schedule=schedule)
        model = PipelineLayer(layers=_shared_descs(), num_stages=2,
                              loss_fn=lambda o_, lab: (o_ * o_).mean())
        own = model.state_dict()
        model.set_state_dict({k: T(v) for k, v in w["shared"].items()
                              if k in own})
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=model.parameters())
        loss = fleet.PipelineParallel(model, strategy=strategy).train_batch(
            (T(x8), T(y16[:8])), opt)
        out["shared_" + schedule] = (float(loss.numpy()), {
            k: _np(v) for k, v in model.state_dict().items()})
    dist.barrier()
    dist.destroy_process_group()
    return out


def _shared_descs():
    """A tied Linear at both ends of two blocks."""
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.distributed.fleet import LayerDesc, SharedLayerDesc

    Block = _block_cls()
    return [SharedLayerDesc("tied", nn.Linear, None, "weight", 16, 16),
            LayerDesc(Block, 16), LayerDesc(Block, 16),
            SharedLayerDesc("tied", nn.Linear, None, "weight", 16, 16)]


def pipeline_gpt(weights, ids):
    """The tiny GPT at ``pp`` 2, the JAX pp 2 GPT's stacked weights
    carried in: its loss, and every gradient (the stages' rows gathered
    whole, in the JAX layout)."""
    import torch

    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.models.convert import (gather_shard,
                                                 load_reference_state_dict,
                                                 reference_state_dict)

    _init(mesh_axes={})
    _pp(2)
    cfg = gpt_tiny(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4)
    m = GPTForCausalLM(cfg, device="cpu", seed=0)
    load_reference_state_dict(m, weights)
    back = reference_state_dict(m)
    stack = m.gpt.layers
    logits, loss = m(torch.from_numpy(ids),
                     labels=torch.from_numpy(np.roll(ids, -1, 1)))
    loss.backward()
    grads = {}
    for n, p in m.named_parameters():
        g = p.grad.detach()
        if n.startswith("gpt.layers.s_"):
            g = gather_shard(g, 0, 1, stack._group)
            if g.dim() == 3 and "ln" not in n:
                g = g.transpose(-1, -2)
        grads[n] = g.numpy().copy()
    return {"loss": float(loss.detach()), "logits": _np(logits),
            "grads": grads, "rows": list(stack.rows),
            "back": {k: v.numpy().copy() for k, v in back.items()}}
