"""Two ranks on one card: the collectives, GPT-355M data-parallel and
GPT-355M tensor-parallel.

    python -m paddle_tpu_torch.tools.dist_drills            # on the card
    python -m paddle_tpu_torch.tools.dist_drills --small --device cpu

Two processes (``distributed.spawn``) share the card over ``gloo`` (NCCL
refuses two ranks on one device); each rank runs:

(a) every collective of ``tools/dist_cases.py`` on this rank's tensors,
    each held against the value worked out from both ranks' inputs;
(b) GPT-355M (``tools/bench_generate.py``'s widths: vocab 50304, hidden
    1024, 16 heads; 1024 positions; its first ``DRILL_LAYERS`` of 24
    layers) under ``fleet.init`` with
    ``dp_degree`` 2 and ``fleet.distributed_model``, O2 bf16 with master
    weights and AdamW (lr 1e-4): a global batch of 8 rows at S 1024,
    each rank its 4 through ``DistributedBatchSampler`` and a
    ``DataLoader(worker_mode="process", num_workers=2)``, for 2 steps.
    The ranks' parameters and master weights must be equal bit for bit;
    rank 0 keeps each step's reduced gradients (before the optimizer),
    then runs the same 2 steps on the full batch in a single model (no
    process group on its path) and holds them against that model's;
(c) GPT-355M at ``mp_degree`` 2 (8 heads a rank), its weights carried
    from the dense model's by ``models/convert.py``: one forward and
    backward of the global batch, the logits gathered over the
    vocabulary and the gradients gathered whole, held on rank 0 against
    the dense model's; then one AdamW step.

The parent joins both ranks (no child holds the card after), checks the
records against the tolerances below and returns them; K1-K3's launches
and the embedding backward's are counted in each rank on (b) and (c).
``--small`` is a 2-layer model at hidden 64 and S 32 for a run on the
CPU.

The comparisons hold gradients first: Adam's first steps move every
weight by about lr whatever its gradient's size, so a distance of a few
lr between weights cannot tell a wrong gradient from a right one. The
weights are held by their mean distance in units of lr, which a flipped
sign moves and a scale does not. Tolerances
(bf16 O2: the ranks' and the single model's products and reductions are
ordered differently), set from the card's readings (NVIDIA H100 80GB
HBM3, 700 W, torch 2.11):

- every leaf's gradient within ``DP_GRAD_TOL`` (3e-2) of the full-batch
  model's by norm, ``|g - g_full| / |g_full|``, at both steps (read:
  0.34% at most at step 1, 1.24% at step 2, which starts from weights
  that an element's sign flip in step 1 moved 2 lr apart); the ranks'
  mean loss within ``LOSS_TOL`` (5e-4 nats; read 5e-7 and 7.2e-5, while
  one step moves it 1.35e-3);
- tensor-parallel: every gathered leaf within ``TP_GRAD_TOL`` (4e-2;
  read 1.89% at most, the row-parallel all-reduces summing bf16
  partials), the loss within ``LOSS_TOL`` (read 7.1e-5), the logits
  within ``LOGITS_TOL`` (2e-2) of their norm (read 1.53%);
- the master weights after the steps within ``WEIGHT_TOL`` (0.05 lr)
  of one model's on average over their elements (read 0.0032 lr for DP
  after 2 steps, 0.0103 lr for TP after 1: the elements whose tiny
  gradient's sign differed, moved 2 lr apart).

Each gradient check has a control that must fail it, or the check could
not see a fault: (b) rank 0's first gradient without the reduction
(``no_sync``, its half batch; read median 101%, every one of the 292
leaves over 5e-2), (c) the same backward with ``c_identity``'s
all-reduce left out (median 87%, every leaf over 5e-2). The weights'
control is the distance AdamW's first update from the control gradient
would put between the weights (``_first_step_gap``), which must exceed
``WEIGHT_TOL``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from typing import Dict

import numpy as np

__all__ = ["run", "rank_main", "gpt355m_config", "DRILL_LAYERS", "LR",
           "STEPS"]

LR = 1e-4
STEPS = 2
GLOBAL_BATCH = 8
DP_GRAD_TOL = 3e-2    # each leaf's reduced gradient, by norm (docstring)
TP_GRAD_TOL = 4e-2    # each leaf's gathered gradient, by norm
LOSS_TOL = 5e-4       # nats, the ranks' mean loss and the TP loss
LOGITS_TOL = 2e-2     # the gathered TP logits, by norm
WEIGHT_TOL = 5e-2     # mean |master - one model's master|, in units of lr
# AdamW's first update is lr * g / (|g| + EPS1) for the defaults _build
# takes (epsilon 1e-8 over sqrt(1 - beta2), beta2 0.999)
EPS1 = 1e-8 / math.sqrt(1 - 0.999)


# the depth of GPT-355M in the two-rank drills (here, ``zero_pp_drills``
# and ``ps_engine_drills``): widths and checks as at 24 layers, the depth
# cut so the smoke's run stays well inside its time limit
DRILL_LAYERS = 4


def gpt355m_config(small: bool):
    from ..models import GPTConfig

    return GPTConfig(vocab_size=256 if small else 50304,
                     hidden_size=64 if small else 1024,
                     num_layers=2 if small else DRILL_LAYERS,
                     num_heads=4 if small else 16,
                     max_position_embeddings=32 if small else 1024,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


class Sequences:
    """``GLOBAL_BATCH x STEPS`` token sequences from seed 7: item i is
    ``(ids, labels)`` of sequence i."""

    def __init__(self, vocab: int, seq: int):
        rng = np.random.default_rng(7)
        self.tokens = rng.integers(0, vocab, (GLOBAL_BATCH * STEPS, seq + 1))

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        return self.tokens[i, :-1], self.tokens[i, 1:]


def _flash() -> Dict[str, int]:
    """Launches so far of K1-K3, of K4 and K5 (none expected), and of the
    embedding backward (and its plain version's calls)."""
    from ..ops import embedding_grad as eg
    from ..ops import flash_attention as fa
    from ..ops import fused_adamw as fw
    from ..ops import paged_attention as pa

    return dict(fa.kernel_launches, paged_attention=pa.kernel_launches,
                fused_adamw=fw.kernel_launches,
                embedding_grad=eg.launches(),
                embedding_grad_plain=eg.plain_calls)


def _build(cfg, device):
    from ..models import GPTForCausalLM
    from ..optimizer import AdamW

    model = GPTForCausalLM(cfg, device=device, seed=0)
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
    return model, opt


def _decorate(model, opt):
    from .. import amp

    return amp.decorate(model, opt, level="O2", dtype="bfloat16")


def _step(model, opt, ids, labels, step=True):
    from .. import amp

    with amp.auto_cast(level="O2", dtype="bfloat16"):
        logits, loss = model(ids, labels=labels)
    loss.backward()
    if step:
        opt.step()
        opt.clear_grad()
    return logits, loss


def _masters(model, opt) -> Dict[str, "torch.Tensor"]:
    names = [n for n, _ in model.named_parameters()]
    return {names[i]: a["@master"] for i, a in opt._accumulators.items()
            if "@master" in a}


def _grads(model) -> Dict[str, "torch.Tensor"]:
    """Copies of the parameters' gradients, by name."""
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _gathered(tensors: Dict[str, "torch.Tensor"], model):
    """``tensors`` (by parameter name, a tensor-parallel ``model``'s) with
    each sharded one gathered whole over its group; every rank calls."""
    from ..models.convert import _shards, gather_shard

    shards = _shards(model)
    out = {}
    for k, v in tensors.items():
        m = shards.get(k)
        out[k] = v if m is None else gather_shard(
            v, m.shard_dim if v.dim() > 1 else 0, m.shard_pieces, m.group)
    return out


def _rel(a: Dict[str, "torch.Tensor"], b: Dict[str, "torch.Tensor"],
         tol: float) -> dict:
    """Leaf by leaf, ``|a - b| / |b|`` by norm in f32: the largest and
    its leaf, the median, the smallest, and how many leaves exceed
    ``tol``."""
    if a.keys() != b.keys():
        raise DrillFailed(f"gradients of other leaves: {sorted(a)[:3]} "
                          f"against {sorted(b)[:3]}")
    rel = {}
    for k in a:
        x, y = a[k].float(), b[k].float().to(a[k].device)
        rel[k] = float((x - y).norm() / y.norm().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    return {"max": rel[worst], "leaf": worst,
            "median": float(np.median(list(rel.values()))),
            "min": min(rel.values()),
            "over": sum(v > tol for v in rel.values()), "leaves": len(rel)}


def _first_step_gap(a: Dict[str, "torch.Tensor"],
                    b: Dict[str, "torch.Tensor"]) -> float:
    """The mean distance, in units of lr, between AdamW's first updates
    from gradients ``a`` and from ``b``: what the weights' check would
    read after one step from a gradient like ``a``."""
    tot, n = 0.0, 0
    for k in a:
        x, y = a[k].float(), b[k].float().to(a[k].device)
        tot += float((x / (x.abs() + EPS1) - y / (y.abs() + EPS1)).abs()
                     .sum())
        n += x.numel()
    return tot / max(n, 1)


def _ranks_equal(tensors) -> int:
    """How many of ``tensors`` differ anywhere from rank 0's."""
    import torch

    from .. import distributed as dist

    bad = 0
    for t in tensors:
        ref = t.detach().clone()
        dist.broadcast(ref, src=0)
        bad += int(not torch.equal(ref, t.detach()))
    n = torch.tensor([bad], dtype=torch.int64, device=tensors[0].device)
    dist.all_reduce(n)
    return int(n.item())


def _diff(a: Dict[str, "torch.Tensor"], b: Dict[str, "torch.Tensor"]):
    mx, tot, cnt = 0.0, 0.0, 0
    for k in a:
        d = (a[k].float() - b[k].float().to(a[k].device)).abs()
        mx = max(mx, float(d.max()))
        tot += float(d.sum())
        cnt += d.numel()
    return mx, tot / max(cnt, 1)


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


@contextlib.contextmanager
def _mp_grads_unreduced():
    """The tensor-parallel control's fault: ``c_identity``'s backward
    passes this rank's partial gradient on without its all-reduce."""
    from ..distributed.fleet import mp_layers

    kept = mp_layers._CIdentity.backward
    mp_layers._CIdentity.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        yield
    finally:
        mp_layers._CIdentity.backward = kept


def rank_main(device: str, small: bool) -> dict:
    """One rank's drills (module docstring): its record."""
    import torch

    from .. import distributed as dist
    from .. import generator
    from ..distributed import fleet, topology
    from ..io import DataLoader, DistributedBatchSampler
    from ..models.convert import (gather_shard, load_reference_state_dict,
                                  reference_state_dict)
    from . import dist_cases

    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo", mesh_axes={})
    rank, world = dist.get_rank(), dist.get_world_size()
    rec: dict = {"rank": rank}
    cfg = gpt355m_config(small)
    S = cfg.max_position_embeddings
    data = Sequences(cfg.vocab_size, S)

    # (a) the collectives, on this rank's tensors
    t0 = time.perf_counter()
    got = dist_cases.run_cases(device)
    failed = []
    for name in dist_cases.CASES:
        xs = [dist_cases.rank_input(name, r, world) for r in range(world)]
        if not dist_cases.held(name, got[name],
                               dist_cases.expected(name, xs, rank)):
            failed.append(name)
    rec["collectives"] = {"cases": len(dist_cases.CASES), "failed": failed,
                          "seconds": time.perf_counter() - t0}

    # (b) data-parallel over dp 2
    t0 = time.perf_counter()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    generator.seed(0)
    model, opt = _decorate(*_build(cfg, device))
    dp = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    sampler = DistributedBatchSampler(data, batch_size=GLOBAL_BATCH // world)
    loader = DataLoader(data, batch_sampler=sampler, num_workers=2,
                        worker_mode="process")
    unreduced = None
    if rank == 0:  # the control: this rank's first gradient, unreduced
        first = [data[i] for i in next(iter(sampler))]
        with dp.no_sync():
            _step(dp, opt, *(torch.from_numpy(np.stack(x)).to(device)
                             for x in zip(*first)), step=False)
        unreduced = _grads(model)
        opt.clear_grad()
    flash0 = _flash()
    losses, rows, step_s, grads = [], [], [], []
    for ids, labels in loader:
        _sync(device)
        ts = time.perf_counter()
        _, loss = _step(dp, opt, ids._value.to(device),
                        labels._value.to(device), step=False)
        if rank == 0:  # the reduced gradients, before the optimizer
            grads.append(_grads(model))
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        _sync(device)
        step_s.append(time.perf_counter() - ts)
        rows.append(ids._value[:, 0].tolist())
    flash1 = _flash()
    masters = _masters(model, opt)
    params = [p for p in model.parameters()]
    rec["dp"] = {
        "losses": losses, "first_tokens": rows,
        "flash_launches": {k: flash1[k] - flash0[k] for k in flash0},
        "ranks_unequal": _ranks_equal(params + list(masters.values())),
        "comm": dp.comm_stats(), "step_s": step_s,
        "loader_position": loader.state_dict()}
    if rank == 0:
        generator.seed(0)
        ref, ropt = _decorate(*_build(cfg, device))
        ref_losses, rel = [], []
        for s in range(STEPS):
            ids = torch.from_numpy(data.tokens[s * GLOBAL_BATCH:(s + 1)
                                               * GLOBAL_BATCH]).to(device)
            _, loss = _step(ref, ropt, ids[:, :-1], ids[:, 1:], step=False)
            full = _grads(ref)
            rel.append(_rel(grads[s], full, DP_GRAD_TOL))
            if s == 0:
                control = _rel(unreduced, full, DP_GRAD_TOL)
                control["first_step_gap_lr"] = _first_step_gap(unreduced,
                                                               full)
            del full
            ropt.step()
            ropt.clear_grad()
            ref_losses.append(float(loss.detach()))
        mx, mean = _diff(masters, _masters(ref, ropt))
        rec["dp"].update(dense_losses=ref_losses, grads_rel=rel,
                         control_unreduced_rel=control, master_max_abs=mx,
                         master_mean_abs=mean, master_mean_lr=mean / LR)
        del ref, ropt
    rec["dp"]["seconds"] = time.perf_counter() - t0
    del dp, model, opt, masters, params, grads, unreduced
    _empty(device)

    # (c) tensor-parallel over mp 2, weights carried from the dense model
    t0 = time.perf_counter()
    topology.set_mesh(None)
    dense, dopt = _build(cfg, device)  # f32, the same seed on both ranks
    whole = reference_state_dict(dense)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    tp, topt = _build(cfg, device)
    load_reference_state_dict(tp, whole)
    tp, topt = _decorate(tp, topt)
    if rank == 0:
        dense, dopt = _decorate(dense, dopt)
    else:
        del dense, dopt
    del whole
    batch = torch.from_numpy(data.tokens[:GLOBAL_BATCH]).to(device)
    ids, labels = batch[:, :-1], batch[:, 1:]
    with _mp_grads_unreduced():  # the control, from the same state
        _step(tp, topt, ids, labels, step=False)
    control = _gathered(_grads(tp), tp)
    topt.clear_grad()
    flash0 = _flash()
    logits, loss = _step(tp, topt, ids, labels, step=False)
    tp_grads = _gathered(_grads(tp), tp)
    topt.step()
    topt.clear_grad()
    flash1 = _flash()
    group = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    full = gather_shard(logits.detach(), -1, 1, group)
    del logits
    tp_masters = _gathered(_masters(tp, topt), tp)
    rec["tp"] = {"loss": float(loss.detach()),
                 "flash_launches": {k: flash1[k] - flash0[k]
                                    for k in flash0},
                 "heads_per_rank": tp.gpt.layers[0].attn.qkv_proj.weight
                 .shape[0] // 3 // (cfg.hidden_size // cfg.num_heads)}
    if rank == 0:
        dlogits, dloss = _step(dense, dopt, ids, labels, step=False)
        dense_grads = _grads(dense)
        rec["tp"].update(
            grads_rel=_rel(tp_grads, dense_grads, TP_GRAD_TOL),
            control_unreduced_rel=dict(
                _rel(control, dense_grads, TP_GRAD_TOL),
                first_step_gap_lr=_first_step_gap(control, dense_grads)))
        del dense_grads
        dopt.step()
        dopt.clear_grad()
        dlogits = dlogits.detach()
        err = (full.float() - dlogits.float())
        rec["tp"].update(
            dense_loss=float(dloss.detach()),
            logits_max_abs=float(err.abs().max()),
            logits_rel_norm=float(err.norm() / dlogits.float().norm()),
            logits_max=float(dlogits.float().abs().max()))
        del err, dlogits, full
        # the weights after one step, the TP ones gathered whole
        dm = _masters(dense, dopt)
        mx, mean = _diff(tp_masters, {k: dm[k] for k in tp_masters})
        rec["tp"].update(master_max_abs=mx, master_mean_abs=mean,
                         master_mean_lr=mean / LR,
                         tensors_compared=len(tp_grads))
    rec["tp"]["seconds"] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    return rec


def _empty(device):
    import gc

    import torch

    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


class DrillFailed(RuntimeError):
    pass


def check(recs: Dict[int, dict], device: str) -> dict:
    """Hold both ranks' records to the tolerances (module docstring);
    raises ``DrillFailed``. Returns the phase's summary."""
    r0, r1 = recs[0], recs[1]
    problems = []
    for r in (r0, r1):
        if r["collectives"]["failed"]:
            problems.append(f"rank {r['rank']}: collectives "
                            f"{r['collectives']['failed']} disagree")
    dp, tp = r0["dp"], r0["tp"]
    if dp["ranks_unequal"]:
        problems.append(f"dp: {dp['ranks_unequal']} tensors differ between "
                        "the ranks")
    for what, r, tol, want_over in (
            ("dp step 1 gradients", dp["grads_rel"][0], DP_GRAD_TOL, False),
            ("dp step 2 gradients", dp["grads_rel"][1], DP_GRAD_TOL, False),
            ("dp control (no reduction)", dp["control_unreduced_rel"],
             DP_GRAD_TOL, True),
            ("tp gradients", tp["grads_rel"], TP_GRAD_TOL, False),
            ("tp control (c_identity's backward unreduced)",
             tp["control_unreduced_rel"], TP_GRAD_TOL, True)):
        if bool(r["over"]) != want_over:
            problems.append(
                f"{what}: {r['over']} of {r['leaves']} leaves over {tol} "
                f"relative by norm (largest {r['max']} at {r['leaf']}); "
                + ("a control must fail the check" if want_over
                   else "tolerance exceeded"))
    for path, r in (("dp", dp), ("tp", tp)):
        gap = r["control_unreduced_rel"]["first_step_gap_lr"]
        if r["master_mean_lr"] > WEIGHT_TOL:
            problems.append(f"{path}: master weights {r['master_mean_lr']} "
                            f"lr apart on average from one model's "
                            f"(tolerance {WEIGHT_TOL} lr)")
        if gap <= WEIGHT_TOL:
            problems.append(f"{path}: the control's first step would move "
                            f"the weights {gap} lr apart on average: the "
                            "weights' check could not see it")
    mean_loss = [(a + b) / 2 for a, b in zip(dp["losses"],
                                              r1["dp"]["losses"])]
    for a, b in zip(mean_loss, dp["dense_losses"]):
        if abs(a - b) > LOSS_TOL:
            problems.append(f"dp: mean loss {a} against {b} (tolerance "
                            f"{LOSS_TOL} nats)")
    if abs(tp["loss"] - tp["dense_loss"]) > LOSS_TOL:
        problems.append(f"tp: loss {tp['loss']} against {tp['dense_loss']} "
                        f"(tolerance {LOSS_TOL} nats)")
    if tp["logits_rel_norm"] > LOGITS_TOL:
        problems.append(f"tp: logits off by {tp['logits_rel_norm']} of "
                        "their norm")
    if device.startswith("cuda"):
        for r in (r0, r1):
            for path in ("dp", "tp"):
                n = r[path]["flash_launches"]
                if not all(n[k] > 0 for k in ("flash_fwd", "flash_dq",
                                              "flash_dkv", "embedding_grad")) \
                        or n["embedding_grad_plain"]:
                    problems.append(f"rank {r['rank']} {path}: a kernel "
                                    f"never launched, or a plain version "
                                    f"ran ({n})")
    if problems:
        raise DrillFailed("; ".join(problems))
    return {
        "collectives_cases": r0["collectives"]["cases"],
        "collectives_s": [r["collectives"]["seconds"] for r in (r0, r1)],
        "dp": {k: dp[k] for k in ("losses", "dense_losses", "ranks_unequal",
                                  "grads_rel", "control_unreduced_rel",
                                  "master_max_abs", "master_mean_abs",
                                  "master_mean_lr", "comm", "step_s",
                                  "seconds",
                                  "loader_position")}
        | {"losses_rank1": r1["dp"]["losses"],
           "first_tokens": [dp["first_tokens"], r1["dp"]["first_tokens"]]},
        "tp": {k: tp[k] for k in ("loss", "dense_loss", "logits_max_abs",
                                  "logits_rel_norm", "logits_max",
                                  "grads_rel", "control_unreduced_rel",
                                  "master_max_abs", "master_mean_abs",
                                  "master_mean_lr", "tensors_compared",
                                  "heads_per_rank",
                                  "seconds")},
        "flash_launches": {
            "train_dp2_gpt355m": {k: r0["dp"]["flash_launches"][k]
                                  + r1["dp"]["flash_launches"][k]
                                  for k in r0["dp"]["flash_launches"]},
            "train_tp2_gpt355m": {k: r0["tp"]["flash_launches"][k]
                                  + r1["tp"]["flash_launches"][k]
                                  for k in r0["tp"]["flash_launches"]}},
    }


def run(device: str = "cuda", small: bool = False, log=print) -> dict:
    """Both ranks (module docstring), joined, checked: the summary."""
    from .. import distributed as dist

    t0 = time.perf_counter()
    ctx = dist.spawn(rank_main, args=(device, small), nprocs=2,
                     backend="cpu" if device == "cpu" else "gpu")
    recs = ctx.results()
    alive = [p.pid for p in ctx.processes if p.is_alive()]
    if alive:
        raise DrillFailed(f"ranks {alive} still running after the join")
    out = check(recs, device)
    out["seconds"] = time.perf_counter() - t0
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
