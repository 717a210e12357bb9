"""Two ranks on one card: GPT-355M under ZeRO at each level, its sharded
checkpoint, and GPT-355M pipelined over the two.

    python -m paddle_tpu_torch.tools.zero_pp_drills            # on the card
    python -m paddle_tpu_torch.tools.zero_pp_drills --small --device cpu

Two processes (``distributed.spawn``) share the card over ``gloo``
(NCCL refuses two ranks on one device). The model and its training are
``tools/dist_drills.py``'s: GPT-355M (vocab 50304, hidden 1024, 16
heads, 1024 positions, dropout 0; its first ``DRILL_LAYERS`` of 24
layers), O2 bf16 with master
weights, AdamW (lr 1e-4), a global batch of 8 rows at S 1024 from seed 7.

(b) ZeRO. ``DataParallel`` runs 3 steps (each rank its 4 rows), then
    ``group_sharded_parallel`` at ``os``, ``os_g`` and ``p_g_os`` 2 steps
    each from the same weights. After 2 steps every rank's master-weight
    blocks and parameters (its blocks at ``p_g_os``) must equal
    ``DataParallel``'s bit for bit: at a world size of 2 the reduction is
    one sum of two floats, and the update is elementwise
    (``distributed/sharding.py``). A rank's optimizer state (every
    accumulator, ``@master`` included) must be at most ``STATE_RATIO``
    of ``DataParallel``'s, and at ``p_g_os`` the parameter bytes it holds
    between steps too. The control: ``os`` with the all-gather after the
    sharded update left out must differ from ``DataParallel``.
(c) The sharded checkpoint. The ``os_g`` ranks save their model and
    optimizer state through ``CheckpointManager`` into one shared scratch
    directory (rank 0 commits); rank 0 restores it whole, the two ranks
    restore it into a fresh ``p_g_os`` model and optimizer (another
    layout: its parameters are sharded too) through ``target=``; every
    leaf must equal ``DataParallel``'s (its blocks) bit for bit, and one
    more step from the restored state must equal ``DataParallel``'s third
    step bit for bit. A copy with one of rank 1's shard files removed
    must be refused.
(d) Pipelines at ``pp`` 2, half the layers a stage, 4 microbatches of 2 rows
    (the strategy's ``accumulate_steps``, which ``fleet.distributed_model``
    passes to the config), the whole batch on both stages. The model's
    own path: ``GPTForCausalLM`` built under the ``pp`` mesh, wrapped by
    ``fleet.distributed_model``, called with labels and its loss's
    backward run, which goes through ``pipeline_apply``'s backward
    (GPipe: every forward, then every backward). And ``1F1B`` through
    ``pipeline_1f1b_train``. The mean loss and every leaf's gradient (the
    stages' rows gathered whole) are held by relative norm against one
    model's full-batch gradients, before any optimizer step, within
    ``PP_GRAD_TOL``. Each has a control that must exceed it: on the
    model's path the first activation gradient a stage receives in the
    backward replaced by zeros (one backward send lost), on 1F1B the
    last stage's loss not divided by the microbatch count. VPP 2 (the
    trunk's rows in the JAX package's device-major order): the logits
    against the one model's, within ``PP_LOGITS_TOL``.

On the card each ZeRO level also records the bytes allocated after its
last backward (before the optimizer step) and the peak over its steps,
each above the bytes allocated before its model was built, beside
``DataParallel``'s; ``os_g`` must hold at least ``GRAD_SAVING``
of the parameter bytes fewer than ``os`` after the backward (its whole
gradients are dropped bucket by bucket during the backward).

K1-K3's and the embedding backward's launches are counted in each rank
on every path. ``--small`` is a 2-layer model at hidden 64 and S 32 (4
layers for the pipelines) for a run on the CPU.

Tolerances (bf16 O2), set from the card's readings (NVIDIA H100 80GB
HBM3, 700 W, torch 2.11): each pipelined leaf within ``PP_GRAD_TOL``
(3e-2) of the one model's gradient by norm (read: 1.34% at most, on the
position embedding, median 0.97%: the stages add each microbatch's bf16
gradient into the bf16 ones, where the one model forms it in one
product); the loss within ``LOSS_TOL`` (read equal); VPP's logits within
``PP_LOGITS_TOL`` (5e-3; read equal bit for bit: a row's products do
not depend on its microbatch). The controls: the loss not divided by
the microbatch count (read 300% on every leaf), and VPP's trunk loaded
in layer order instead of the device-major order its schedule runs,
which applies the layers out of order. The model path's limit is
1F1B's.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict

import numpy as np

from . import dist_drills
from .dist_drills import (DrillFailed, _build, _decorate, _empty, _flash,
                          _grads, _masters, _rel, _step, _sync,
                          gpt355m_config)

__all__ = ["run", "rank_main", "check"]

LEVELS = ("os", "os_g", "p_g_os")
GLOBAL_BATCH = dist_drills.GLOBAL_BATCH
STEPS = 2              # each level's steps before the comparisons
STATE_RATIO = 0.55     # a ZeRO rank's state (and p_g_os params) over DP's
MICROBATCHES = 4
PP_GRAD_TOL = 3e-2     # each pipelined leaf's gradient, by norm
PP_LOGITS_TOL = 5e-3   # VPP's logits, by norm
LOSS_TOL = dist_drills.LOSS_TOL
GRAD_SAVING = 0.4      # os_g's gradient bytes saved, in parameter bytes
# the pipelined runs held against the one model, each control last
PP_PATHS = ("model", "model_control", "1F1B", "control")


def _tokens(cfg):
    rng = np.random.default_rng(7)
    return rng.integers(0, cfg.vocab_size,
                        (GLOBAL_BATCH * (STEPS + 1),
                         cfg.max_position_embeddings + 1))


def _batch(tokens, step, rank, world, device):
    import torch

    b = GLOBAL_BATCH // world
    rows = tokens[step * GLOBAL_BATCH + rank * b:
                  step * GLOBAL_BATCH + (rank + 1) * b]
    t = torch.from_numpy(rows).to(device)
    return t[:, :-1], t[:, 1:]


def _dp_mesh(world):
    from ..distributed import topology

    topology.set_mesh(None)
    topology.set_mesh(topology.create_mesh({"dp": world}))


def _model(cfg, device, level):
    """GPT-355M from seed 0, decorated, wrapped for ``level``."""
    from .. import distributed as dist
    from .. import generator

    generator.seed(0)
    model, opt = _decorate(*_build(cfg, device))
    if level == "dp":
        return model, dist.DataParallel(model), opt
    net, opt = dist.group_sharded_parallel(model, opt, level=level)
    return model, net, opt


def _acc_bytes(opt) -> int:
    return sum(v.numel() * v.element_size()
               for accs in opt._accumulators.values() for v in accs.values())


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _same_blocks(model, opt, dp_params, dp_masters) -> int:
    """How many parameters and master weights differ anywhere from
    ``DataParallel``'s (this rank's blocks under ZeRO)."""
    import torch

    zero, bad = opt._zero, 0
    names = [n for n, _ in model.named_parameters()]
    for idx, p in enumerate(model.parameters()):
        if zero.model._sharder is not None:
            mine = zero.local(idx)
        else:
            mine = p.detach()
        want = zero.blocks[idx].of(dp_params[idx]) \
            if mine.shape != dp_params[idx].shape else dp_params[idx]
        bad += int(not torch.equal(mine, want))
        m = opt._accumulators[idx].get("@master")
        if m is not None:
            dm = dp_masters[names[idx]]
            want = zero.blocks[idx].of(dm) if m.shape != dm.shape else dm
            bad += int(not torch.equal(m, want))
    return bad


def _mem_base(device) -> dict:
    """The bytes allocated before a level's model is built (on the card;
    else nothing, and no readings)."""
    import torch

    if not device.startswith("cuda"):
        return {}
    return {"base": torch.cuda.memory_allocated()}


def _train(net, opt, tokens, steps, rank, world, device, first=0,
           mem=None):
    """``steps`` steps; ``mem`` (from :func:`_mem_base`) takes the bytes
    allocated after the last backward, before its optimizer step, and
    the peak over the steps, each above its ``base``."""
    import torch

    losses = []
    card = bool(mem)
    if card:
        torch.cuda.reset_peak_memory_stats()
    for s in range(first, first + steps):
        ids, labels = _batch(tokens, s, rank, world, device)
        logits, loss = _step(net, opt, ids, labels, step=False)
        del logits
        if card:
            torch.cuda.synchronize()
            mem["after_backward"] = (torch.cuda.memory_allocated()
                                     - mem["base"])
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    if card:
        mem["peak"] = torch.cuda.max_memory_allocated() - mem["base"]
    return losses


def _zero(cfg, tokens, device, ckpt_dir) -> dict:
    """(b) and (c) on this rank (module docstring)."""
    import torch

    from .. import distributed as dist
    from ..checkpoint import CheckpointManager
    from ..distributed import checkpoint as ckpt
    from ..distributed import sharding

    rank, world = dist.get_rank(), dist.get_world_size()
    rec: dict = {}
    _dp_mesh(world)
    rec["dp_memory"] = _mem_base(device)
    model, net, opt = _model(cfg, device, "dp")
    f0 = _flash()
    t0 = time.perf_counter()
    rec["dp_losses"] = _train(net, opt, tokens, STEPS, rank, world, device,
                              mem=rec["dp_memory"])
    _sync(device)
    rec["dp_s"] = time.perf_counter() - t0
    f1 = _flash()
    rec["launches_dp"] = {k: f1[k] - f0[k] for k in f0}
    dp_names = [n for n, _ in model.named_parameters()]
    dp_params = [p.detach().clone() for p in model.parameters()]
    dp_masters = {k: v.clone() for k, v in _masters(model, opt).items()}
    dp_state = {k: v for k, v in opt.state_dict().items()
                if k.startswith("pos:")}
    dp_bytes = {"state": _acc_bytes(opt), "params": _param_bytes(model)}
    rec["dp_bytes"] = dp_bytes
    _train(net, opt, tokens, 1, rank, world, device, first=STEPS)
    dp3_params = [p.detach().clone() for p in model.parameters()]
    dp3_masters = {k: v.clone() for k, v in _masters(model, opt).items()}
    del model, net, opt
    _empty(device)

    for level in LEVELS + ("control",):
        _dp_mesh(world)
        mem = _mem_base(device)
        model, net, opt = _model(cfg, device,
                                 "os" if level == "control" else level)
        f0 = _flash()
        t0 = time.perf_counter()
        if level == "control":  # the all-gather after the update left out
            kept = sharding._all_gather_blocks
            sharding._all_gather_blocks = lambda pairs, group: None
            try:
                losses = _train(net, opt, tokens, STEPS, rank, world, device)
            finally:
                sharding._all_gather_blocks = kept
        else:
            losses = _train(net, opt, tokens, STEPS, rank, world, device,
                            mem=mem)
        _sync(device)
        f1 = _flash()
        r = {"losses": losses, "seconds": time.perf_counter() - t0,
             "launches": {k: f1[k] - f0[k] for k in f0},
             "differing": _same_blocks(model, opt, dp_params, dp_masters),
             "state_ratio": _acc_bytes(opt) / dp_bytes["state"],
             "param_ratio": net.resident_parameter_bytes()
             / dp_bytes["params"], "comm": net.comm_stats(),
             "memory": mem}
        rec[level] = r
        if level == "os_g":  # (c): save through the manager, rank 0 commits
            mgr = CheckpointManager(ckpt_dir, device=device)
            state = {"model": net.state_dict(), "opt": opt.state_dict()}
            _sync(device)
            t0 = time.perf_counter()
            mgr.save(STEPS, state)
            dist.barrier()
            rec["save_s"] = time.perf_counter() - t0
            rec["saved_steps"] = mgr.all_steps()
            del state
        del model, net, opt
        _empty(device)

    # (c) restores: rank 0 whole; both ranks into a fresh p_g_os layout
    mgr = CheckpointManager(ckpt_dir, device=device)
    if rank == 0:
        t0 = time.perf_counter()
        whole, step = mgr.restore()
        _sync(device)
        rec["restore_whole_s"] = time.perf_counter() - t0
        bad = sum(not torch.equal(whole["model"][n]._value, dp_params[i])
                  for i, n in enumerate(dp_names))
        bad += sum(not torch.equal(whole["opt"][k]._value, v)
                   for k, v in dp_state.items())
        rec["restore_whole"] = {"step": step, "differing": bad,
                                "leaves": len(dp_names) + len(dp_state)}
        del whole
    dist.barrier()
    _dp_mesh(world)
    model, net, opt = _model(cfg, device, "p_g_os")
    opt._materialize_accumulators()
    target = {"model": net.state_dict(), "opt": opt.state_dict()}
    t0 = time.perf_counter()
    back, step = mgr.restore(target=target)
    net.set_state_dict(back["model"])
    opt.set_state_dict(back["opt"])
    _sync(device)
    rec["restore_p_g_os_s"] = time.perf_counter() - t0
    rec["restore_p_g_os"] = {
        "step": step,
        "differing": _same_blocks(model, opt, dp_params, dp_masters)}
    rec["step3_losses"] = _train(net, opt, tokens, 1, rank, world, device,
                                 first=STEPS)
    rec["step3_differing"] = _same_blocks(model, opt, dp3_params,
                                          dp3_masters)
    del model, net, opt, back, target
    _empty(device)
    dist.barrier()
    # a copy with one of rank 1's shard files removed must be refused
    if rank == 0:
        src = mgr.step_path(STEPS)
        holed = tempfile.mkdtemp(dir=os.path.dirname(ckpt_dir))
        shutil.rmtree(holed)
        shutil.copytree(src, holed)
        gone = sorted(f for f in os.listdir(holed) if ".p1." in f)[0]
        os.remove(os.path.join(holed, gone))
        try:
            ckpt.load_state_dict(holed, device=device)
            rec["refused"] = None
        except (FileNotFoundError, ValueError) as e:
            rec["refused"] = f"{type(e).__name__}: {e}"[:200]
        rec["removed"] = gone
        shutil.rmtree(holed, ignore_errors=True)
    dist.barrier()
    return rec


def _drop_first_backward_send():
    """The control of the model's path: the first activation gradient a
    stage receives in ``_Pipe``'s backward replaced by zeros (one
    backward send lost). Returns the function that undoes it."""
    import torch

    from ..distributed.fleet import pipeline_schedule as ps

    kept, seen = ps._Link.swap, []

    def swap(link, t, k):
        got = kept(link, t, k)
        if k == -1 and not seen:
            seen.append(k)
            return torch.zeros_like(got)
        return got

    ps._Link.swap = swap
    return lambda: setattr(ps._Link, "swap", kept)


def _pp(cfg, tokens, device) -> dict:
    """(d) on this rank (module docstring)."""
    import torch

    from .. import amp
    from .. import distributed as dist
    from .. import generator
    from ..distributed import fleet, topology
    from ..distributed.fleet import pipeline_1f1b_train
    from ..models import GPTForCausalLM
    from ..models import gpt as gpt_mod
    from ..models.convert import (gather_shard, load_reference_state_dict,
                                  reference_state_dict, stack_reference)
    from ..nn import functional as F

    rank = dist.get_rank()
    rec: dict = {}
    topology.set_mesh(None)
    generator.seed(0)
    dense, _ = _build(cfg, device)
    ref = reference_state_dict(dense)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": dist.get_world_size(),
                               "accumulate_steps": MICROBATCHES}
    fleet.init(is_collective=True, strategy=strategy)
    L = cfg.num_layers
    pp = GPTForCausalLM(cfg, device=device, seed=0)
    load_reference_state_dict(pp, stack_reference(ref, L))
    amp.decorate(pp, level="O2", dtype="bfloat16")
    # fleet's wrapper (DataParallel over the one-rank dp group); the
    # strategy's accumulate_steps becomes the trunk's microbatches
    net = fleet.distributed_model(pp)
    rec["microbatches"] = pp.config.pp_num_microbatches
    stack = pp.gpt.layers
    rec["rows"] = list(stack.rows)
    batch = torch.from_numpy(tokens[:GLOBAL_BATCH]).to(device)
    ids, labels = batch[:, :-1], batch[:, 1:]
    dense_grads, dense_logits = None, None
    if rank == 0:
        dense = amp.decorate(dense, level="O2", dtype="bfloat16")
        logits, loss = _step(dense, None, ids, labels, step=False)
        rec["dense_loss"] = float(loss.detach())
        dense_logits = logits.detach()
        dense_grads = _stacked_grads(_grads(dense), L)
    del dense
    _empty(device)
    g = pp.gpt

    def prefix(i):
        B, S = i.shape
        pos = torch.arange(S, device=i.device).expand(B, S)
        return gpt_mod._add(g.embeddings(i), g.position_embeddings(pos))

    def loss_fn(h, lab):
        logits = pp.logits(g.ln_f(h))
        return F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               lab.reshape(-1))

    def gathered():
        out = {}
        for n, p in pp.named_parameters():
            gr = p.grad.detach()
            if n.startswith("gpt.layers.s_"):
                gr = gather_shard(gr, 0, 1, stack._group)
            out[n] = gr
        return out

    # the model's own path (GPipe: every forward, then every backward,
    # through _Pipe's backward) and 1F1B, each beside its control
    for name in ("model", "model_control", "1F1B", "control"):
        for p in pp.parameters():
            p.grad = None
        scale = MICROBATCHES if name == "control" else 1
        undo = _drop_first_backward_send() if name == "model_control" \
            else None
        f0 = _flash()
        _sync(device)
        t0 = time.perf_counter()
        try:
            if name.startswith("model"):
                _, loss = _step(net, None, ids, labels, step=False)
                loss = float(loss.detach())
            else:
                with amp.auto_cast(level="O2", dtype="bfloat16"):
                    loss = pipeline_1f1b_train(
                        stack, ids, labels,
                        lambda h, lab, s=scale: loss_fn(h, lab) * s,
                        MICROBATCHES, prefix=prefix,
                        prefix_params=[g.embeddings.weight,
                                       g.position_embeddings.weight],
                        loss_params=[g.ln_f.weight, g.ln_f.bias,
                                     g.embeddings.weight])
                loss = float(loss) / scale
        finally:
            if undo is not None:
                undo()
        _sync(device)
        r = {"seconds": time.perf_counter() - t0, "loss": loss}
        if not name.startswith("model"):
            r["in_flight"] = stack._in_flight_max
        f1 = _flash()
        r["launches"] = {k: f1[k] - f0[k] for k in f0}
        grads = gathered()
        if rank == 0:
            r["grads_rel"] = _rel(grads, dense_grads, PP_GRAD_TOL)
        rec[name] = r
        del grads
    # VPP 2: the trunk's rows in the device-major order, the logits
    vstack = gpt_mod.GPTStackedBlocks(cfg, vpp=2).to_empty(device=device)
    stacked = stack_reference(ref, L, layer_order=vstack.layer_order)
    load_reference_state_dict(vstack, {k[len("gpt.layers."):]: v
                                       for k, v in stacked.items()
                                       if k.startswith("gpt.layers.s_")})
    amp.decorate(vstack, level="O2", dtype="bfloat16")
    f0 = _flash()
    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        h = vstack(prefix(ids), num_microbatches=MICROBATCHES)
        logits = pp.logits(g.ln_f(h))
    f1 = _flash()
    rec["vpp"] = {"rows": list(vstack.rows),
                  "launches": {k: f1[k] - f0[k] for k in f0}}
    # the control: the rows in layer order, not the schedule's
    wrong = stack_reference(ref, L)
    lo = vstack._stage * vstack.local_layers
    with torch.no_grad():
        for n, p in vstack.named_parameters():
            src = wrong["gpt.layers." + n][lo:lo + vstack.local_layers]
            if p.dim() == 3 and "ln" not in n:
                src = src.transpose(-1, -2)
            p.copy_(src.to(p.device, p.dtype))
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            control = pp.logits(g.ln_f(vstack(prefix(ids),
                                              num_microbatches=MICROBATCHES)))
    if rank == 0:
        for key, got in (("logits_rel_norm", logits),
                         ("control_rel_norm", control)):
            err = got.float() - dense_logits.float()
            rec["vpp"][key] = float(err.norm() / dense_logits.float().norm())
        rec["vpp"]["logits_max_abs"] = float(
            (logits.float() - dense_logits.float()).abs().max())
    del vstack, pp, net, logits, control
    _empty(device)
    return rec


def _stacked_grads(grads: Dict, L: int) -> Dict:
    """A dense model's gradients with its blocks' stacked under the
    pipelined model's names (``[L, ...]``, torch layout)."""
    import torch

    out, names = {}, []
    for k in grads:
        if k.startswith("gpt.layers.0."):
            names.append(k[len("gpt.layers.0."):])
        elif not k.startswith("gpt.layers."):
            out[k] = grads[k]
    for n in names:
        out["gpt.layers.s_" + n.replace(".", "__")] = torch.stack(
            [grads[f"gpt.layers.{i}.{n}"] for i in range(L)])
    return out


def rank_main(device: str, small: bool, ckpt_dir: str) -> dict:
    """One rank's drills (module docstring): its record."""
    import torch

    from .. import distributed as dist

    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo", mesh_axes={})
    cfg = gpt355m_config(small)
    tokens = _tokens(cfg)
    rec = {"rank": dist.get_rank()}
    t0 = time.perf_counter()
    rec["zero"] = _zero(cfg, tokens, device, ckpt_dir)
    rec["zero_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcfg = gpt355m_config(small)
    if small:  # two blocks a stage, so VPP has two chunks a stage
        pcfg.num_layers = 4
    rec["pp"] = _pp(pcfg, _tokens(pcfg), device)
    rec["pp_s"] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    return rec



def check(recs: Dict[int, dict], device: str) -> dict:
    """Hold both ranks' records to the module docstring's limits; raises
    ``DrillFailed``. Returns the summary."""
    problems = []
    r0 = recs[0]
    for r in recs.values():
        z, rk = r["zero"], r["rank"]
        for level in LEVELS:
            x = z[level]
            if x["differing"]:
                problems.append(f"rank {rk} {level}: {x['differing']} "
                                "parameters or master blocks differ from "
                                "DataParallel's")
            if x["state_ratio"] > STATE_RATIO:
                problems.append(f"rank {rk} {level}: state "
                                f"{x['state_ratio']:.3f} of DataParallel's")
            if x["losses"] != z["dp_losses"]:
                problems.append(f"rank {rk} {level}: losses {x['losses']} "
                                f"against {z['dp_losses']}")
        if z["p_g_os"]["param_ratio"] > STATE_RATIO:
            problems.append(f"rank {rk} p_g_os: parameters "
                            f"{z['p_g_os']['param_ratio']:.3f} of DP's")
        mem = {lv: z[lv]["memory"] for lv in ("os", "os_g")}
        if all(mem.values()):  # read on the card
            saved = (mem["os"]["after_backward"]
                     - mem["os_g"]["after_backward"])
            if saved < GRAD_SAVING * z["dp_bytes"]["params"]:
                problems.append(
                    f"rank {rk} os_g: holds {saved} fewer bytes than os "
                    f"after the backward, under {GRAD_SAVING} of the "
                    f"{z['dp_bytes']['params']} parameter bytes")
        if not z["control"]["differing"]:
            problems.append(f"rank {rk}: the control (no all-gather after "
                            "the update) equals DataParallel")
        if z["restore_p_g_os"]["differing"] or z["step3_differing"]:
            problems.append(f"rank {rk}: the p_g_os restore differs "
                            f"({z['restore_p_g_os']['differing']} blocks, "
                            f"{z['step3_differing']} after the next step)")
    z0 = r0["zero"]
    if z0["restore_whole"]["differing"]:
        problems.append(f"the whole restore: {z0['restore_whole']} leaves "
                        "differ")
    if not z0.get("refused"):
        problems.append(f"a checkpoint without {z0.get('removed')} loaded")
    pp = r0["pp"]
    if pp["microbatches"] != MICROBATCHES:
        problems.append(f"pp: the model ran {pp['microbatches']} "
                        "microbatches, not the strategy's accumulate_steps")
    for name in PP_PATHS:
        r = pp[name]["grads_rel"]
        want_over = name.endswith("control")
        if bool(r["over"]) != want_over:
            problems.append(
                f"pp {name}: {r['over']} of {r['leaves']} leaves over "
                f"{PP_GRAD_TOL} by norm (largest {r['max']} at {r['leaf']})"
                + ("; a control must fail the check" if want_over else ""))
        if not want_over and abs(pp[name]["loss"] - pp["dense_loss"]) \
                > LOSS_TOL:
            problems.append(f"pp {name}: loss {pp[name]['loss']} against "
                            f"{pp['dense_loss']}")
    if pp["vpp"]["logits_rel_norm"] > PP_LOGITS_TOL:
        problems.append(f"pp vpp: logits {pp['vpp']['logits_rel_norm']} "
                        "off by norm")
    if pp["vpp"]["control_rel_norm"] <= PP_LOGITS_TOL:
        problems.append(f"pp vpp: the control (layers out of order) is "
                        f"only {pp['vpp']['control_rel_norm']} off")
    for r in recs.values():
        if r["pp"]["1F1B"]["in_flight"] > len(recs):
            problems.append(f"rank {r['rank']}: 1F1B held "
                            f"{r['pp']['1F1B']['in_flight']} microbatches")
    launches = _launches(recs)
    if device.startswith("cuda"):
        for path, n in launches.items():
            keys = ("flash_fwd",) if path == "vpp_forward_gpt355m" else (
                "flash_fwd", "flash_dq", "flash_dkv", "embedding_grad")
            if not all(n[k] > 0 for k in keys) or n["embedding_grad_plain"]:
                problems.append(f"{path}: a kernel never launched, or a "
                                f"plain version ran ({n})")
    if problems:
        raise DrillFailed("; ".join(problems))
    return {"zero": {k: z0[k] for k in z0 if k not in ("dp_bytes",)}
            | {"dp_bytes": z0["dp_bytes"],
               "rank1": {lv: recs[1]["zero"][lv]["differing"]
                         for lv in LEVELS}},
            "pp": {k: pp[k] for k in PP_PATHS + ("vpp", "dense_loss", "rows",
                                                 "microbatches")},
            "launches": launches,
            "seconds": {r["rank"]: (r["zero_s"], r["pp_s"])
                        for r in recs.values()}}


def _launches(recs) -> Dict[str, dict]:
    """Each path's kernel launches, summed over the ranks."""
    paths = {"train_zero_dp_gpt355m": lambda r: r["zero"]["launches_dp"]}
    for lv in LEVELS:
        paths[f"train_zero_{lv}_gpt355m"] = \
            lambda r, lv=lv: r["zero"][lv]["launches"]
    paths["train_pp_1f1b_gpt355m"] = lambda r: r["pp"]["1F1B"]["launches"]
    paths["train_pp_model_gpt355m"] = lambda r: r["pp"]["model"]["launches"]
    paths["vpp_forward_gpt355m"] = lambda r: r["pp"]["vpp"]["launches"]
    out = {}
    for path, get in paths.items():
        got = [get(r) for r in recs.values()]
        out[path] = {k: sum(g[k] for g in got) for k in got[0]}
    return out


def run(device: str = "cuda", small: bool = False, log=print) -> dict:
    """Both ranks (module docstring), joined, checked: the summary. The
    checkpoint goes under a scratch directory of ``TMPDIR``, removed
    after."""
    from .. import distributed as dist

    t0 = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="zero_pp_")
    try:
        ctx = dist.spawn(rank_main, args=(device, small,
                                          os.path.join(scratch, "ckpt")),
                         nprocs=2,
                         backend="cpu" if device == "cpu" else "gpu")
        recs = ctx.results()
        alive = [p.pid for p in ctx.processes if p.is_alive()]
        if alive:
            raise DrillFailed(f"ranks {alive} still running after the join")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    out = check(recs, device)
    out["seconds_total"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    if args.device != "cpu":
        from ..device import resolve_device

        resolve_device(args.device)
    try:
        out = run(args.device, args.small)
    except DrillFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
