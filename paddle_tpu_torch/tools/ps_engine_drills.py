"""The rest of ``distributed`` on one card: gpt13 through the auto-parallel
``Engine``, GPT-355M through ``Engine`` at ``dp`` 2 with fleet's utilities,
a Wide&Deep CTR trainer under the launcher's ``ps`` mode, and ``rpc``.

    python -m paddle_tpu_torch.tools.ps_engine_drills            # on the card
    python -m paddle_tpu_torch.tools.ps_engine_drills --small --device cpu

(a) gpt13 (``bench_gpt13``'s GPT-3 XL: vocab 50304, hidden 2048, 24
    layers, 16 heads, O2 bf16 without master weights, AdamW lr 1e-4) at B
    8, S 1024 through ``auto_parallel.Engine`` in this process, at world
    size 1 (``Engine`` runs ``fleet.init``: NCCL on the card). The model
    given to ``Engine`` is the GPT under ``amp.auto_cast`` O2
    (``O2Forward``) and its loss ``lm_loss``: the cross entropy over the
    logits, since ``Engine``'s step calls ``loss(model(inputs),
    labels)``. ``fit`` runs 4 steps (``epochs`` 4 of one batch from a
    fixed-order loader: each epoch's history entry is one step's loss;
    the first call runs eagerly, the second captures the CUDA graph, the
    others replay it), then ``evaluate``, ``predict``, ``save``/``load``
    of the model (``training=False``) and ``cost()``. Held bit for bit
    against the same step written by hand under ``jit.to_static`` from
    the same seed and batch: every loss and every parameter after the 4
    steps; ``evaluate``'s loss and ``predict``'s logits against the same
    forward by hand; the parameters after ``load`` against those saved.
    ``cost()["flops"]`` within ``COST_TOL`` of ``analytic_flops``: 6 x
    the parameters that enter a product x tokens, plus K1-K3's flops (18
    D a causal pair and head a layer). Step ms graphed (``Engine``'s
    step replayed) and eager (the hand step), and K1-K3's and the
    embedding kernel's launches in ``fit`` (``train_engine_gpt13``).
(b) Two gloo ranks of GPT-355M (``dist_drills.gpt355m_config``, O2 bf16
    with master weights) through ``Engine`` at ``dp`` 2 (the default
    all-``dp`` mesh): the global batch of 8 rows at S 1024, each rank its
    4, **SGD** at lr ``SGD_LR``, so each leaf's update is its gradient.
    Rank 0 holds every leaf's update (the master weights' change) against
    one model's full-batch step within ``DP_GRAD_TOL`` by norm, and the
    ranks' mean loss within ``LOSS_TOL``; the ranks must end equal bit
    for bit. Controls that must fail: the same ``Engine`` step with the
    reducer off (``no_sync``: each rank its half batch), and a hand DP
    step on ranks seeded apart without ``broadcast_dp_parameters`` (the
    ranks differ after it; with it, they do not).
    ``fused_allreduce_gradients`` over the hand DP step against
    ``DataParallel``'s reduced gradients from the same weights and rows
    (held bit for bit). ``predict`` gathers the global batch's logits
    (held against one model's by norm). On gloo the step runs eagerly:
    ``DataParallel.__jit_capture__`` tells ``StaticFunction`` so
    (``eager_reason`` is recorded). K1-K3 and the embedding kernel are
    counted on each rank (``train_engine_dp2_gpt355m``).
(d) ``rpc`` on the same two processes: worker 1 runs GPT-355M's forward
    (``rpc_forward``: f32, seeded weights) on its card; worker 0 calls it
    by ``rpc_sync`` and ``rpc_async``; both results must equal worker
    0's own call bit for bit.
(c) A Wide&Deep CTR trainer under ``python -m
    paddle_tpu_torch.distributed.launch --run_mode ps --server_num 2
    --trainer_num 1``: the two servers on the host, the trainer on the
    card. Shapes are Criteo's as PaddleRec's ``models/rank/wide_deep``
    config sets them (``CTR``: 26 sparse slots over 1,000,001 keys,
    ``sparse_feature_dim`` 9, 13 dense features, ``fc_sizes`` [512, 256,
    128, 32], batch 512); the wide part is a dim-1 ``SparseEmbedding``
    summed over the slots plus a linear over the dense features; ids are
    Zipf (s 1.1) over the key space, seeded. Tables and trunk take SGD at
    ``CTR_LR``. One sync step must equal one step of the same model with
    dense embeddings over the touched rows (``DenseRows``) within
    ``CTR_TOL`` (the rows' updates by norm; f32, the table applies a
    repeated id's gradients one after another); the control, the step
    with the push skipped, must fail. Then ``CTR_STEPS`` sync steps:
    steps/s, pull and push ms a step (the push's device-to-host copy
    included) and the rows the tables hold. Then two trainers with
    ``AsyncCommunicator``, ``CTR_STEPS / 5`` steps each: each one's loss
    (the mean of its first fifth of steps against its last) must fall
    and the communicator must have merged rows (rows handed to it minus
    rows it sent).

``--small`` runs (a) on ``bench``'s small gpt13, (b) and (d) on a 2-layer
GPT at hidden 64 and S 32, and (c) at batch 64 with ``fc_sizes`` [16, 8],
20 sync and 10 async steps, for a run on the CPU (the kernels' plain
versions).

Limits: ``DP_GRAD_TOL`` and ``LOSS_TOL`` are ``dist_drills``' (3e-2 by
norm a leaf, 5e-4 nats); ``COST_TOL`` 2e-2; ``CTR_TOL`` 5e-3 on the
rows' updates by norm, set from the card (NVIDIA H100 80GB HBM3, 700 W,
torch 2.11: read 3.2e-4 on the dim-9 table, 6.0e-6 on the dim-1 one):
the table applies a hot id's gradients one at a time, each rounded to
the f32 weight (about 0.05), which is large beside one lookup's share
of the update; the control reads 1.0 (no update at all).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

__all__ = ["run", "engine_gpt13", "rank_main", "ctr_role_main",
           "analytic_flops", "lm_loss", "O2Forward", "CTR"]

COST_TOL = 2e-2       # cost()["flops"] against analytic_flops
SGD_LR = 1.0          # (b): an update is the gradient, above f32 rounding
CTR_LR = 0.05         # (c): SGD on the tables and on the trunk
CTR_TOL = 5e-3        # (c): the rows' updates against the dense twin's
CTR_STEPS = 200
ENGINE_STEPS = 4
GLOBAL_BATCH = 8

# PaddleRec models/rank/wide_deep/config.yaml (Criteo): sparse_feature_
# number 1000001, sparse_feature_dim 9, dense_input_dim 13, slots 26,
# fc_sizes [512, 256, 128, 32], batch_size 512
CTR = {"keys": 1000001, "dim": 9, "dense": 13, "slots": 26,
       "fc_sizes": [512, 256, 128, 32], "batch": 512, "zipf_s": 1.1}
CTR_SMALL = dict(CTR, fc_sizes=[16, 8], batch=64)


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


class DrillFailed(RuntimeError):
    pass


# ---------------------------------------------------------- the model
class O2Forward(torch.nn.Module):
    """``model``'s forward under ``amp.auto_cast`` O2 bf16: what the
    bench's step runs, as a model ``Engine`` can call."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids):
        from .. import amp

        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return self.model(ids)


def lm_loss(logits, labels):
    """The mean cross entropy of ``logits`` ``[B, S, V]`` against
    ``labels`` ``[B, S]``, in f32 (a facade Tensor for facade inputs)."""
    import torch.nn.functional as tF

    from ..tensor import Tensor

    lg = getattr(logits, "_value", logits)
    lb = getattr(labels, "_value", labels)
    loss = tF.cross_entropy(lg.reshape(-1, lg.shape[-1]).float(),
                            lb.reshape(-1))
    return Tensor._wrap(loss) if isinstance(logits, Tensor) else loss


class _Rows:
    """Dataset of token rows: item i is ``(ids, labels)`` of row i."""

    def __init__(self, tokens: np.ndarray):
        self.tokens = tokens

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        return self.tokens[i, :-1], self.tokens[i, 1:]


def analytic_flops(model, cfg, B: int, S: int) -> int:
    """6 x (parameters that enter a product: all but the position table)
    x tokens, plus K1-K3's 18 D flops a causal pair and head a layer."""
    n = sum(p.numel() for name, p in model.named_parameters()
            if "position" not in name)
    D = cfg.hidden_size // cfg.num_heads
    pairs = B * S * (S + 1) // 2
    return 6 * n * B * S + 18 * D * cfg.num_heads * pairs * cfg.num_layers


def _launch_counts() -> Dict[str, int]:
    from ..ops import embedding_grad as eg
    from ..ops import flash_attention as fa
    from ..ops import fused_adamw as fw
    from ..ops import paged_attention as pa

    return {**{k: fa.kernel_launches[k] + fa.replayed_launches[k]
               for k in fa.KERNELS},
            "paged_attention": pa.kernel_launches + pa.replayed_launches,
            "fused_adamw": fw.kernel_launches,
            "embedding_grad": eg.launches(),
            "flash_plain": sum(fa.plain_calls.values()),
            "embedding_grad_plain": eg.plain_calls}


def _reset_counts() -> None:
    from ..ops import embedding_grad as eg
    from ..ops import flash_attention as fa
    from ..ops import fused_adamw as fw
    from ..ops import paged_attention as pa

    fa.reset_counters()
    eg.reset_counters()
    pa.reset_counters()
    fw.kernel_launches = 0


# ------------------------------------------------------------- (a)
def engine_gpt13(device: str, small: bool) -> dict:
    """(a): gpt13 through ``Engine`` against the hand step (module
    docstring); leaves no process group behind."""
    import gc

    from .. import bench, jit
    from .. import distributed as dist
    from ..distributed import fleet, topology
    from ..distributed.fleet import auto
    from ..io import DataLoader

    cfg, B, S, _ = bench.SETUPS["gpt13"](small)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1))
    loader = DataLoader(_Rows(tokens), batch_size=B, shuffle=False,
                        drop_last=True)
    ids = torch.from_numpy(tokens[:, :-1]).to(device)
    labels = torch.from_numpy(tokens[:, 1:]).to(device)

    # the hand step, under jit.to_static, from bench.build's state
    t_start = time.perf_counter()
    model, opt = bench.build(cfg, device, bench.MASTER_WEIGHT["gpt13"])
    net = O2Forward(model)

    def hand_step(x, y):
        loss = lm_loss(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = jit.to_static(hand_step)
    hand_losses = [float(step(ids, labels).detach().double())
                   for _ in range(ENGINE_STEPS)]
    hand_params = [p.detach().to("cpu", copy=True)
                   for p in model.parameters()]
    t_hand = time.perf_counter() - t_start
    eager_s = []
    for _ in range(2):  # the eager step's ms, after the comparison
        _sync(device)
        t0 = time.perf_counter()
        hand_step(ids, labels)
        _sync(device)
        eager_s.append(time.perf_counter() - t0)
    del step, hand_step, net, model, opt
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    model, opt = bench.build(cfg, device, bench.MASTER_WEIGHT["gpt13"])
    eng = auto.Engine(O2Forward(model), lm_loss, opt)
    _reset_counts()
    t0 = time.perf_counter()
    hist = eng.fit(loader, epochs=ENGINE_STEPS, steps_per_epoch=1,
                   verbose=0)
    _sync(device)
    fit_s = time.perf_counter() - t0
    launches = _launch_counts()
    sf = eng._steps["train"]
    rec = {"losses": hist["loss"], "hand_losses": hand_losses,
           "fit_s": fit_s, "launches": launches,
           "compile_counts": sf.compile_counts(),
           "backend": dist.get_backend(),
           "eager_step_ms": 1e3 * min(eager_s)}
    bad = sum(not torch.equal(p.detach().cpu(), h)
              for p, h in zip(model.parameters(), hand_params))
    rec["params_unequal"] = bad
    rec["params_compared"] = len(hand_params)
    del hand_params
    cost = eng.cost()
    want = analytic_flops(model, cfg, B, S)
    rec["cost"] = cost
    rec["analytic_flops"] = want
    rec["cost_rel"] = abs(cost["flops"] - want) / want
    graphed_s = []
    for _ in range(3):  # Engine's graphed step, replayed
        _sync(device)
        t0 = time.perf_counter()
        sf(*eng._place(tokens[:, :-1], tokens[:, 1:])[:2])
        _sync(device)
        graphed_s.append(time.perf_counter() - t0)
    rec["graphed_step_ms"] = 1e3 * min(graphed_s)
    rec["compile_counts_after"] = sf.compile_counts()
    # evaluate and predict against the same forward by hand, from the
    # state after the timed steps
    with torch.no_grad():
        eng._model.eval()
        ref_logits = eng._model(ids)
        ref_eval = float(lm_loss(ref_logits, labels).double())
        ref_logits = ref_logits.float().cpu()
    ev = eng.evaluate(loader, steps=1, verbose=0)
    pred = eng.predict(loader, steps=1, verbose=0)
    rec["eval_loss"], rec["ref_eval_loss"] = ev["loss"], ref_eval
    rec["predict_equal"] = bool(
        len(pred) == 1 and tuple(pred[0].shape) == tuple(ref_logits.shape)
        and np.array_equal(pred[0].astype(np.float32), ref_logits.numpy()))
    del ref_logits, pred
    # save / load of the model, timed, its parameters back bit for bit
    saved = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        eng.save(os.path.join(tmp, "ckpt"), training=False)
        rec["save_s"] = time.perf_counter() - t0
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        t0 = time.perf_counter()
        eng.load(os.path.join(tmp, "ckpt"))
        _sync(device)
        rec["load_s"] = time.perf_counter() - t0
    rec["load_unequal"] = sum(not torch.equal(p.detach().cpu(), s)
                              for p, s in zip(model.parameters(), saved))
    rec["seconds"] = {"hand": t_hand,
                      "total": time.perf_counter() - t_start}
    rec["state_bytes"] = sum(s.numel() * s.element_size() for s in saved)
    del saved, eng, sf, model, opt
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    topology.set_mesh(None)
    fleet.fleet._is_initialized = False
    return rec


def check_engine_gpt13(rec: dict, device: str) -> None:
    problems = []
    if rec["losses"] != rec["hand_losses"]:
        problems.append(f"Engine losses {rec['losses']} != the hand step's "
                        f"{rec['hand_losses']}")
    if rec["params_unequal"]:
        problems.append(f"{rec['params_unequal']} of "
                        f"{rec['params_compared']} parameters differ from "
                        "the hand step's")
    if rec["eval_loss"] != rec["ref_eval_loss"] or not rec["predict_equal"]:
        problems.append(f"evaluate {rec['eval_loss']} against "
                        f"{rec['ref_eval_loss']}, predict equal "
                        f"{rec['predict_equal']}")
    if rec["load_unequal"]:
        problems.append(f"{rec['load_unequal']} parameters differ after "
                        "load")
    # on the CPU the plain attention computes every (q, k) pair, which
    # the analytic count's causal half does not describe
    if device.startswith("cuda") and rec["cost_rel"] > COST_TOL:
        problems.append(f"cost() flops {rec['cost']['flops']} against "
                        f"{rec['analytic_flops']} ({rec['cost_rel']:.4f} "
                        f"off, tolerance {COST_TOL})")
    n = rec["launches"]
    if device.startswith("cuda"):
        if rec["backend"] != "NCCL":
            problems.append(f"Engine's process group on {rec['backend']}")
        if rec["compile_counts"] != {"signatures": 1, "captured": 1,
                                     "calls": ENGINE_STEPS}:
            problems.append(f"compile counts {rec['compile_counts']}")
        if not all(n[k] > 0 for k in ("flash_fwd", "flash_dq", "flash_dkv",
                                      "embedding_grad")) \
                or n["flash_plain"] or n["embedding_grad_plain"]:
            problems.append(f"a kernel never launched, or a plain version "
                            f"ran: {n}")
    if problems:
        raise DrillFailed("engine gpt13: " + "; ".join(problems))


# ------------------------------------------------------- (b) and (d)
_RPC_MODEL = {}


def rpc_forward(ids: np.ndarray, small: bool):
    """GPT-355M's logits for ``ids`` on this worker's device (f32, the
    weights from seed 0, the model built once a process)."""
    from ..models import GPTForCausalLM
    from .dist_drills import gpt355m_config

    key = small
    if key not in _RPC_MODEL:
        dev = "cuda" if torch.cuda.is_available() and not small else "cpu"
        _RPC_MODEL[key] = GPTForCausalLM(gpt355m_config(small), device=dev,
                                         seed=0)
    model = _RPC_MODEL[key]
    with torch.no_grad():
        return model(torch.from_numpy(ids).to(model.device))


def _masters(model, opt):
    """Every leaf's f32 value by name: its master weight under O2, else
    the parameter itself (the norms, kept f32)."""
    accs = opt._accumulators
    return {n: (accs[i]["@master"] if "@master" in accs.get(i, {})
                else p).detach().float().clone()
            for i, (n, p) in enumerate(model.named_parameters())}


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _o2_sgd(cfg, device, seed, before_decorate=None):
    """GPT-355M from ``seed``, ``before_decorate(model)`` applied to the
    f32 model, then O2 bf16 with master weights and SGD at ``SGD_LR``
    (its state made, so the masters exist before the step)."""
    from .. import amp
    from ..models import GPTForCausalLM
    from ..optimizer import SGD

    model = GPTForCausalLM(cfg, device=device, seed=seed)
    if before_decorate is not None:
        before_decorate(model)
    opt = SGD(learning_rate=SGD_LR, parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    opt._materialize_accumulators()
    return model, opt


def _updates(after, before):
    return {k: after[k] - before[k] for k in before}


def rank_main(device: str, small: bool, rpc_port: int) -> dict:
    """One rank of (b) and (d) (module docstring): its record."""
    from .. import distributed as dist
    from ..distributed import fleet, rpc
    from ..distributed.fleet import auto
    from ..distributed.fleet.utils import (broadcast_dp_parameters,
                                           fused_allreduce_gradients)
    from ..io import DataLoader
    from .dist_drills import _rel, _ranks_equal, gpt355m_config

    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo", mesh_axes={})
    rank = dist.get_rank()
    cfg = gpt355m_config(small)
    S = cfg.max_position_embeddings
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                               (GLOBAL_BATCH, S + 1))
    loader = DataLoader(_Rows(tokens), batch_size=GLOBAL_BATCH,
                        shuffle=False, drop_last=True)
    half = GLOBAL_BATCH // 2
    mine = torch.from_numpy(tokens[rank * half:(rank + 1) * half]).to(device)
    x, y = mine[:, :-1], mine[:, 1:]
    rec: dict = {"rank": rank}

    # DataParallel's reduced gradients from the initial weights, then
    # Engine's step from the same state
    t0 = time.perf_counter()
    model, opt = _o2_sgd(cfg, device, 0)
    eng = auto.Engine(O2Forward(model), lm_loss, opt)
    net = eng._network()
    lm_loss(net(x), y).backward()
    dp_grads = _grads(model)
    opt.clear_grad()
    pred = eng.predict(loader, steps=1, verbose=0)[0]
    rec["predict_shape"] = list(pred.shape)
    before = _masters(model, opt)
    _reset_counts()
    ts = time.perf_counter()
    hist = eng.fit(loader, epochs=1, steps_per_epoch=1, verbose=0)
    _sync(device)
    rec["step_s"] = time.perf_counter() - ts
    rec["launches"] = _launch_counts()
    sf = eng._steps["train"]
    rec["eager_reason"] = sf.eager_reason
    rec["compile_counts"] = sf.compile_counts()
    rec["loss"] = hist["loss"][0]
    upd = _updates(_masters(model, opt), before)
    rec["ranks_unequal"] = _ranks_equal(list(model.parameters()))
    del eng, net, sf, before
    # the control: the same Engine step with the reducer off
    cmodel, copt = _o2_sgd(cfg, device, 0)
    ceng = auto.Engine(O2Forward(cmodel), lm_loss, copt)
    cbefore = _masters(cmodel, copt)
    with ceng._network().no_sync():
        ceng.fit(loader, epochs=1, steps_per_epoch=1, verbose=0)
    cupd = _updates(_masters(cmodel, copt), cbefore)
    del ceng, cmodel, copt, cbefore
    rec["engine_s"] = time.perf_counter() - t0

    # fused_allreduce_gradients over a hand DP step on ranks seeded
    # apart, with broadcast_dp_parameters and (the control) without
    t0 = time.perf_counter()
    hmodel, hopt = _o2_sgd(cfg, device, rank, broadcast_dp_parameters)
    lm_loss(O2Forward(hmodel)(x), y).backward()
    fused_allreduce_gradients(list(hmodel.parameters()))
    h_grads = _grads(hmodel)
    hopt.step()
    hopt.clear_grad()
    rec["fused_unequal"] = sum(not torch.equal(h_grads[k], dp_grads[k])
                               for k in dp_grads)
    rec["fused_rel"] = _rel(h_grads, dp_grads, DP_GRAD_TOL)
    rec["fused_leaves"] = len(dp_grads)
    rec["broadcast_ranks_unequal"] = _ranks_equal(list(hmodel.parameters()))
    del hmodel, hopt, h_grads, dp_grads
    nmodel, nopt = _o2_sgd(cfg, device, rank)
    lm_loss(O2Forward(nmodel)(x), y).backward()
    fused_allreduce_gradients(list(nmodel.parameters()))
    nopt.step()
    nopt.clear_grad()
    rec["no_broadcast_ranks_unequal"] = _ranks_equal(
        list(nmodel.parameters()))
    del nmodel, nopt
    rec["utils_s"] = time.perf_counter() - t0

    if rank == 0:  # one model's full-batch step
        rmodel, ropt = _o2_sgd(cfg, device, 0)
        rnet = O2Forward(rmodel)
        rbefore = _masters(rmodel, ropt)
        full = torch.from_numpy(tokens).to(device)
        logits = rnet(full[:, :-1])
        loss = lm_loss(logits, full[:, 1:])
        loss.backward()
        ropt.step()
        ropt.clear_grad()
        rupd = _updates(_masters(rmodel, ropt), rbefore)
        err = torch.from_numpy(pred.astype(np.float32)).to(device) \
            - logits.detach().float()
        rec.update(
            dense_loss=float(loss.detach().double()),
            update_rel=_rel(upd, rupd, DP_GRAD_TOL),
            control_no_sync_rel=_rel(cupd, rupd, DP_GRAD_TOL),
            predict_rel_norm=float(err.norm()
                                   / logits.detach().float().norm()))
        del rmodel, ropt, rnet, rbefore, rupd, logits, err
    del upd, cupd, pred
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    # (d) rpc over the same two processes
    t0 = time.perf_counter()
    rpc.init_rpc(f"worker{rank}", rank=rank, world_size=2,
                 master_endpoint=f"127.0.0.1:{rpc_port}")
    if rank == 0:
        ids = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (1, min(S, 256)))
        got_sync = rpc.rpc_sync("worker1", rpc_forward, args=(ids, small))
        got_async = rpc.rpc_async("worker1", rpc_forward,
                                  args=(ids, small)).wait()
        own = rpc_forward(ids, small).cpu()
        rec["rpc"] = {
            "sync_equal": bool(torch.equal(got_sync, own)),
            "async_equal": bool(torch.equal(got_async, own)),
            "result_device": str(got_sync.device),
            "shape": list(own.shape),
            "workers": [w.name for w in rpc.get_all_worker_infos()]}
    rpc.shutdown()
    _RPC_MODEL.clear()
    rec["rpc_s"] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    return rec


DP_GRAD_TOL = 3e-2
LOSS_TOL = 5e-4


def check_ranks(recs: Dict[int, dict], device: str) -> dict:
    r0, r1 = recs[0], recs[1]
    problems = []
    if r0["update_rel"]["over"]:
        u = r0["update_rel"]
        problems.append(f"updates: {u['over']} of {u['leaves']} leaves over "
                        f"{DP_GRAD_TOL} (largest {u['max']} at {u['leaf']})")
    if not r0["control_no_sync_rel"]["over"]:
        problems.append("the control with the reducer off passed the "
                        "updates' check: the check cannot see a fault")
    mean = (r0["loss"] + r1["loss"]) / 2
    if abs(mean - r0["dense_loss"]) > LOSS_TOL:
        problems.append(f"mean loss {mean} against {r0['dense_loss']}")
    for r in (r0, r1):
        if r["ranks_unequal"] or r["broadcast_ranks_unequal"]:
            problems.append(f"rank {r['rank']}: ranks differ after the "
                            "Engine step or the broadcast hand step")
        if not r["no_broadcast_ranks_unequal"]:
            problems.append("the ranks seeded apart without "
                            "broadcast_dp_parameters ended equal")
        if r["fused_unequal"]:
            problems.append(f"rank {r['rank']}: fused_allreduce_gradients "
                            f"differs from DataParallel's on "
                            f"{r['fused_unequal']} leaves")
        if r["predict_shape"][0] != GLOBAL_BATCH:
            problems.append(f"predict gave {r['predict_shape']}")
        if device.startswith("cuda"):
            n = r["launches"]
            if r["eager_reason"] is None:
                problems.append("the gloo step was not run eagerly")
            if not all(n[k] > 0 for k in ("flash_fwd", "flash_dq",
                                          "flash_dkv", "embedding_grad")) \
                    or n["flash_plain"] or n["embedding_grad_plain"]:
                problems.append(f"rank {r['rank']}: a kernel never "
                                f"launched, or a plain version ran: {n}")
    if r0["predict_rel_norm"] > 2e-2:
        problems.append(f"predict's logits {r0['predict_rel_norm']} off by "
                        "norm")
    rp = r0["rpc"]
    if not (rp["sync_equal"] and rp["async_equal"]):
        problems.append(f"rpc results differ from the own call: {rp}")
    if problems:
        raise DrillFailed("engine dp 2 / rpc: " + "; ".join(problems))
    return {
        "losses": [r0["loss"], r1["loss"]], "dense_loss": r0["dense_loss"],
        "update_rel": r0["update_rel"],
        "control_no_sync_rel": r0["control_no_sync_rel"],
        "fused_bit_for_bit": True, "fused_leaves": r0["fused_leaves"],
        "fused_rel_max": r0["fused_rel"]["max"],
        "no_broadcast_ranks_unequal": r0["no_broadcast_ranks_unequal"],
        "predict_rel_norm": r0["predict_rel_norm"],
        "eager_reason": r0["eager_reason"],
        "compile_counts": r0["compile_counts"],
        "step_s": [r0["step_s"], r1["step_s"]],
        "engine_s": [r0["engine_s"], r1["engine_s"]],
        "utils_s": [r0["utils_s"], r1["utils_s"]],
        "rpc": dict(rp, seconds=[r0["rpc_s"], r1["rpc_s"]]),
        "launches": {k: r0["launches"][k] + r1["launches"][k]
                     for k in r0["launches"]}}


# ------------------------------------------------------------- (c)
def _zipf_cdf(n: int, s: float) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** -s
    c = np.cumsum(w)
    return c / c[-1]


class CtrData:
    """Criteo-shaped batches from ``seed``: sparse ids ``[B, slots]`` Zipf
    over the key space (slot ``j``'s ranks offset by ``j * 7919``), dense
    features uniform in [0, 1), labels Bernoulli(0.25)."""

    def __init__(self, cfg: dict, seed: int):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.cdf = _zipf_cdf(cfg["keys"], cfg["zipf_s"])

    def batch(self):
        c, rng = self.cfg, self.rng
        B, k = c["batch"], c["slots"]
        rank = np.searchsorted(self.cdf, rng.random((B, k)))
        ids = (rank + np.arange(k) * 7919) % c["keys"]
        dense = rng.random((B, c["dense"]), dtype=np.float32)
        labels = (rng.random((B, 1)) < 0.25).astype(np.float32)
        return ids.astype(np.int64), dense, labels


def _ctr_model(cfg: dict, deep, wide, device):
    """The Wide&Deep network over two embeddings ``deep`` (dim
    ``cfg["dim"]``) and ``wide`` (dim 1) of the slots' ids."""
    from .. import nn
    from ..device import using_device
    from ..nn import functional as F

    class WideDeep(nn.Layer):
        def __init__(self):
            super().__init__()
            self.deep_emb = deep
            self.wide_emb = wide
            with using_device(device):
                self.wide_dense = nn.Linear(cfg["dense"], 1)
                sizes = [cfg["slots"] * cfg["dim"] + cfg["dense"]] \
                    + list(cfg["fc_sizes"]) + [1]
                self.fcs = nn.LayerList([nn.Linear(a, b) for a, b in
                                         zip(sizes[:-1], sizes[1:])])

        def forward(self, ids, dense):
            from .. import concat

            B = dense.shape[0]
            x = concat([self.deep_emb(ids).reshape([B, -1]), dense],
                       axis=1)
            for i, fc in enumerate(self.fcs):
                x = fc(x)
                if i < len(self.fcs) - 1:
                    x = F.relu(x)
            wide = self.wide_emb(ids).reshape([B, -1]).sum(axis=1,
                                                          keepdim=True)
            return x + wide + self.wide_dense(dense)

        def trunk(self):
            return list(self.wide_dense.parameters()) \
                + list(self.fcs.parameters())

    return WideDeep()


def _dense_rows(rows: np.ndarray, uniq: np.ndarray, device):
    """A dense embedding over the touched rows ``uniq`` (sorted), its
    weight ``rows``: the twin of a ``SparseEmbedding``."""
    from .. import nn
    from ..device import using_device
    from ..nn import functional as F
    from ..tensor import Tensor

    class DenseRows(nn.Layer):
        def __init__(self):
            super().__init__()
            with using_device(device):
                self.weight = self.create_parameter(
                    list(rows.shape), dtype="float32")
            self.weight._value.data.copy_(torch.from_numpy(rows))

        def forward(self, ids):
            idx = np.searchsorted(uniq, np.asarray(ids))
            return F.embedding(Tensor._wrap(torch.from_numpy(idx).to(
                self.weight._value.device)), self.weight)

    return DenseRows()


def _ctr_step(model, opt, batch, device):
    import paddle_tpu_torch as paddle
    from ..nn import functional as F

    ids, dense, labels = batch
    logit = model(ids, paddle.to_tensor(dense, place=device))
    loss = F.binary_cross_entropy_with_logits(
        logit, paddle.to_tensor(labels, place=device))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.numpy())


def _connect(endpoints, timeout: float = 120.0):
    from ..distributed.ps import PSClient

    deadline = time.time() + timeout
    while True:
        try:
            return PSClient(endpoints)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)


def _ctr_trainer_sync(client, cfg, device, steps, idx) -> dict:
    """One sync trainer: the equality check with its control, then
    ``steps`` timed steps."""
    from .. import generator
    from ..distributed.ps import SparseEmbedding, TableConfig
    from ..optimizer import SGD

    generator.seed(0)
    tcfg = dict(optimizer="sgd", learning_rate=CTR_LR, init_range=0.05)
    deep = SparseEmbedding(client, 0, cfg["dim"], TableConfig(
        dim=cfg["dim"], seed=1, **tcfg), device=device)
    wide = SparseEmbedding(client, 1, 1, TableConfig(dim=1, seed=2, **tcfg),
                           device=device)
    model = _ctr_model(cfg, deep, wide, device)
    opt = SGD(learning_rate=CTR_LR, parameters=model.trunk())
    data = CtrData(cfg, seed=100 + idx)
    batch = data.batch()
    uniq = np.unique(batch[0]).astype(np.uint64)
    rows0 = [client.pull_sparse(t, uniq) for t in (0, 1)]
    trunk0 = [p._value.detach().clone() for p in model.trunk()]

    # the control: the same step with the push skipped
    deep.eval()
    wide.eval()
    _ctr_step(model, opt, batch, device)
    deep.train()
    wide.train()
    rows_c = [client.pull_sparse(t, uniq) for t in (0, 1)]
    with torch.no_grad():
        for p, v in zip(model.trunk(), trunk0):
            p._value.copy_(v)
    loss = _ctr_step(model, opt, batch, device)
    rows1 = [client.pull_sparse(t, uniq) for t in (0, 1)]
    trunk1 = [p._value.detach().clone() for p in model.trunk()]

    # the twin: dense embeddings over the touched rows, the same trunk
    twin = _ctr_model(cfg, _dense_rows(rows0[0], uniq, device),
                      _dense_rows(rows0[1], uniq, device), device)
    with torch.no_grad():
        for p, v in zip(twin.trunk(), trunk0):
            p._value.copy_(v)
    topt = SGD(learning_rate=CTR_LR, parameters=twin.parameters())
    twin_loss = _ctr_step(twin, topt, batch, device)
    tw = [twin.deep_emb.weight._value.detach().cpu().numpy(),
          twin.wide_emb.weight._value.detach().cpu().numpy()]

    def rel(got, want, base):
        du, dw = got - base, want - base
        return float(np.linalg.norm(du - dw) / max(np.linalg.norm(dw),
                                                   1e-30))

    rec = {"loss": loss, "twin_loss": twin_loss,
           "rows_rel": [rel(rows1[t], tw[t], rows0[t]) for t in (0, 1)],
           "control_rows_rel": [rel(rows_c[t], tw[t], rows0[t])
                                for t in (0, 1)],
           "trunk_max_abs": max(float((a - b._value.detach()).abs().max())
                                for a, b in zip(trunk1, twin.trunk())),
           "touched_rows": int(uniq.size)}
    del twin, topt

    # the timed run
    for layer in (deep, wide):
        for k in layer.stats:
            layer.stats[k] = 0
    batches = [data.batch() for _ in range(steps)]
    losses = []
    _sync(device)
    t0 = time.perf_counter()
    for b in batches:
        losses.append(_ctr_step(model, opt, b, device))
    _sync(device)
    wall = time.perf_counter() - t0
    pull_s = deep.stats["pull_s"] + wide.stats["pull_s"]
    push_s = deep.stats["push_s"] + wide.stats["push_s"]
    rec.update(steps=steps, seconds=wall, steps_per_s=steps / wall,
               pull_ms=1e3 * pull_s / steps, push_ms=1e3 * push_s / steps,
               pull_push_share=(pull_s + push_s) / wall,
               table_rows=[client.sparse_size(0), client.sparse_size(1)],
               losses_head=losses[:3], losses_tail=losses[-3:])
    return rec


def _ctr_trainer_async(client, cfg, device, steps, idx) -> dict:
    """One async trainer: its pushes through ``AsyncCommunicator``."""
    from .. import generator
    from ..distributed.ps import (AsyncCommunicator, SparseEmbedding,
                                  TableConfig)
    from ..optimizer import SGD

    sent = [0]
    push = client.push_sparse

    def counted(tid, keys, grads):
        sent[0] += int(np.asarray(keys).size)
        return push(tid, keys, grads)

    client.push_sparse = counted
    comm = AsyncCommunicator(client, send_steps=4, send_interval_s=0.2)
    generator.seed(0)
    tcfg = dict(optimizer="sgd", learning_rate=CTR_LR, init_range=0.05)
    deep = SparseEmbedding(client, 0, cfg["dim"], TableConfig(
        dim=cfg["dim"], seed=1, **tcfg), communicator=comm, device=device)
    wide = SparseEmbedding(client, 1, 1, TableConfig(dim=1, seed=2, **tcfg),
                           communicator=comm, device=device)
    model = _ctr_model(cfg, deep, wide, device)
    opt = SGD(learning_rate=CTR_LR, parameters=model.trunk())
    data = CtrData(cfg, seed=200 + idx)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(_ctr_step(model, opt, data.batch(), device))
    comm.stop()
    wall = time.perf_counter() - t0
    handed = deep.stats["rows_pushed"] + wide.stats["rows_pushed"]
    k = max(1, steps // 5)
    return {"steps": steps, "seconds": wall,
            "loss_first": float(np.mean(losses[:k])),
            "loss_last": float(np.mean(losses[-k:])),
            "rows_handed": handed, "rows_sent": sent[0],
            "merged": handed - sent[0]}


def ctr_role_main(argv=None) -> int:
    """A process of the ``ps`` job (c): a server or a trainer, by the
    launcher's environment (fleet's role maker)."""
    from ..distributed import fleet
    from ..distributed.ps import PSServer

    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--mode", choices=("sync", "async"), default="sync")
    p.add_argument("--steps", type=int, default=CTR_STEPS)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    fleet.init(is_collective=False)
    if fleet.is_server():
        host, port = fleet.server_endpoints()[fleet.server_index()] \
            .rsplit(":", 1)
        PSServer(host=host, port=int(port))
        while True:  # until the launcher stops the job
            time.sleep(1.0)
    idx = fleet.worker_index()
    cfg = CTR_SMALL if args.small else CTR
    client = _connect(fleet.server_endpoints())
    run = _ctr_trainer_sync if args.mode == "sync" else _ctr_trainer_async
    rec = run(client, cfg, args.device, args.steps, idx)
    rec.update(trainer=idx, trainers=fleet.worker_num(),
               servers=fleet.server_num())
    client.close()
    with open(os.path.join(args.out, f"trainer{idx}.json"), "w") as f:
        json.dump(rec, f)
    return 0


_ROLE_SCRIPT = """import sys
sys.path.insert(0, {root!r})
from paddle_tpu_torch.tools.ps_engine_drills import ctr_role_main
sys.exit(ctr_role_main(sys.argv[1:]))
"""


def _launch_ps(tmp: str, trainers: int, mode: str, device: str,
               small: bool, steps: int) -> Dict[int, dict]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    script = os.path.join(tmp, "ctr_role.py")
    with open(script, "w") as f:
        f.write(_ROLE_SCRIPT.format(root=root))
    out = os.path.join(tmp, f"out_{mode}")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [q for q in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if q]))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--run_mode", "ps", "--server_num", "2", "--trainer_num",
           str(trainers), "--log_dir", os.path.join(tmp, f"log_{mode}"),
           script, "--device", device, "--mode", mode, "--steps",
           str(steps), "--out", out] + (["--small"] if small else [])
    proc = subprocess.run(cmd, env=env, cwd=root, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        logs = ""
        logdir = os.path.join(tmp, f"log_{mode}")
        for name in sorted(os.listdir(logdir)):
            with open(os.path.join(logdir, name)) as f:
                logs += f"--- {name}\n{f.read()[-3000:]}\n"
        raise DrillFailed(f"ps launch ({mode}) exit {proc.returncode}:\n"
                          f"{proc.stderr[-2000:]}\n{logs}")
    recs = {}
    for i in range(trainers):
        with open(os.path.join(out, f"trainer{i}.json")) as f:
            recs[i] = json.load(f)
    return recs


def ctr(device: str, small: bool) -> dict:
    """(c): the sync job, then the async one (module docstring)."""
    steps = 20 if small else CTR_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sync = _launch_ps(tmp, 1, "sync", device, small, steps)[0]
        t1 = time.perf_counter()
        asyn = _launch_ps(tmp, 2, "async", device, small,
                          max(10, steps // 5))
        t2 = time.perf_counter()
    problems = []
    if max(sync["rows_rel"]) > CTR_TOL:
        problems.append(f"the sync step's rows {sync['rows_rel']} off the "
                        f"dense twin's (tolerance {CTR_TOL})")
    if min(sync["control_rows_rel"]) <= CTR_TOL:
        problems.append("the control without the push passed the rows' "
                        f"check ({sync['control_rows_rel']})")
    if sync["trunk_max_abs"] > 1e-5 or abs(sync["loss"]
                                           - sync["twin_loss"]) > 1e-5:
        problems.append(f"the trunk or the loss differ from the twin's: "
                        f"{sync['trunk_max_abs']}, {sync['loss']} against "
                        f"{sync['twin_loss']}")
    for i, r in asyn.items():
        if not r["loss_last"] < r["loss_first"]:
            problems.append(f"async trainer {i}: loss {r['loss_first']} -> "
                            f"{r['loss_last']} did not fall")
        if r["merged"] <= 0:
            problems.append(f"async trainer {i}: no rows merged ({r})")
    if problems:
        raise DrillFailed("ctr: " + "; ".join(problems))
    return {"sync": sync, "async": asyn, "sync_job_s": t1 - t0,
            "async_job_s": t2 - t1}


# -------------------------------------------------------- entry points
def run(device: str = "cuda", small: bool = False, log=print) -> dict:
    """(a) here, (b) and (d) on two ranks, (c) under the launcher: each
    checked (raises ``DrillFailed``); the summary."""
    from .. import distributed as dist
    from ..distributed._wire import free_port

    out = {}
    t0 = time.perf_counter()
    a = engine_gpt13(device, small)
    log("ps_engine (a) record: " + json.dumps(a, default=str))
    check_engine_gpt13(a, device)
    out["engine_gpt13"] = a
    t1 = time.perf_counter()
    ctx = dist.spawn(rank_main, args=(device, small, free_port()), nprocs=2,
                     backend="cpu" if device == "cpu" else "gpu")
    recs = ctx.results()
    alive = [p.pid for p in ctx.processes if p.is_alive()]
    if alive:
        raise DrillFailed(f"ranks {alive} still running after the join")
    log("ps_engine (b, d) records: " + json.dumps(recs, default=str))
    out["engine_dp2"] = check_ranks(recs, device)
    t2 = time.perf_counter()
    out["ctr"] = ctr(device, small)
    log("ps_engine (c) record: " + json.dumps(out["ctr"], default=str))
    t3 = time.perf_counter()
    out["seconds"] = {"engine_gpt13": t1 - t0, "engine_dp2_rpc": t2 - t1,
                      "ctr": t3 - t2, "total": t3 - t0}
    out["launches"] = {"train_engine_gpt13": a["launches"],
                       "train_engine_dp2_gpt355m":
                           out["engine_dp2"]["launches"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    if args.device != "cpu":
        from ..device import resolve_device

        resolve_device(args.device)
    else:
        from ..device import set_device

        set_device("cpu")
    try:
        out = run(args.device, args.small)
    except DrillFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
