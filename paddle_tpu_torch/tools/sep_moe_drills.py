"""Sequence and expert parallelism on one card: ring attention's block
loop, two ranks of Llama-0.76B at ``sep`` 2, and two ranks of the MoE
layer at GPT-355M's width.

    python -m paddle_tpu_torch.tools.sep_moe_drills            # on the card
    python -m paddle_tpu_torch.tools.sep_moe_drills --small --device cpu

(a) The ring's block loop (``distributed/ring_attention.py``) in this
    process at Llama-0.76B's attention shape (B 1, S 8192, 16 heads of
    128, bf16), causal and not, at P 4 with ``ListHop``: O, dQ, dK and dV
    against K1-K3 called once over the whole sequence and against their
    plain versions there (``ref_flash_*``: a ``[1, 16, 8192, 8192]`` f32
    score block), by relative norm within ``RING_TOL``. The control, the
    merge with its block weights ``e^(lse_i - m)`` replaced by 1, must
    exceed it. The ring's forward and backward (every rank's loop, one
    after another) are timed beside the one-call kernels.
(b) Two gloo ranks (NCCL refuses two ranks on one card) of Llama-0.76B,
    ``bench --model llama``'s configuration (hidden 2048, 16 heads,
    intermediate 5632, vocab 32000, full recompute, fused CE, O2 bf16;
    its first ``SEP_LAYERS`` of 12 layers) at B 1, S 8192, so each rank
    holds 4096 positions: through ``fleet.init(sep_degree=2)`` and
    ``fleet.distributed_model`` the loss and every leaf's gradient (summed over ``sep`` by the reducer) against
    one model's full-sequence loss and gradients on the card with the same
    weights, by relative norm within ``SEP_GRAD_TOL``, before any
    optimizer step. Controls that must exceed it: each rank attending its
    own block alone (no block from the other rank), and RoPE at the
    chunk's local positions. Each rank's K1-K3 launches are counted (rank
    0 runs its diagonal block, rank 1 the past block and its diagonal: 3
    K1 a layer over both, twice under the full recompute, 6 a layer in
    all; 3 a layer each of K2 and K3), with the step's seconds and the bytes each rank
    sent around the ring (staged through the host on gloo).
(c) Two gloo ranks of ``MoELayer`` at GPT-355M's width (d_model 1024,
    d_hidden 4096, 8 gelu ``ExpertLayer``s, 4 a rank, f32), B 8 x S 1024
    tokens, each rank its 4 rows, expert-parallel over the ``dp`` group,
    wrapped in ``DataParallel``: naive top-2 (eval) and gshard top-2 in
    training with ``random_routing=False`` at capacity rate 0.2 (with
    top-2 over distinct experts an expert receives at most ``T`` entries,
    so the JAX default 1.2 drops nothing; 0.2 drops tokens). Output,
    loss (with gshard's aux loss) and the gradients of the gate and of
    every expert against the local path of one process on the card (the
    same weights, every token), within ``MOE_TOL`` by relative norm; and
    ``ClipGradForMOEByGlobalNorm``'s factor against the local clip's.
    Controls that must exceed it: the expert gradients without the
    ``1 / ep`` correction, and gshard's capacity counted per rank
    instead of over the global arrival order. A forward and backward at
    ``ep`` 2 is timed beside the local path.

``--small`` runs (a) at S 256 and 4 heads of 64, (b) on ``llama_tiny``
at S 128 and (c) at d_model 64, d_hidden 128 and 2 x 32 tokens, for a
run on the CPU (the kernels' plain versions).

Limits, set from the card's readings (NVIDIA H100 80GB HBM3, 700 W,
torch 2.11): ``RING_TOL`` 1e-2 (read 0.39% at most against the one-call
kernels and the plain versions; one call against the plain versions
0.19%: bf16 rounding; the control 18.9% causal, 36.4% full);
``SEP_GRAD_TOL`` 4e-2 (read 2.37% at most, median 1.74%: each rank's
bf16 share rounded, then summed in bf16; the controls 59% and 100% at
their largest, every leaf over); ``LOSS_TOL`` 5e-3 nats (read 2.6e-4);
``MOE_TOL`` 1e-5 (read 1.06e-6: f32, the experts' products batched
against one Linear each; the controls 100% and 82%).
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import sys
import time
from typing import Dict

import numpy as np

from .dist_drills import DrillFailed, _empty, _flash, _rel

__all__ = ["run", "rank_main", "check", "ring_check", "block_loop"]

RING_TOL = 1e-2       # the block loop against the one-call kernels, by norm
SEP_GRAD_TOL = 4e-2   # each leaf's gradient at sep 2, by norm
LOSS_TOL = 5e-3       # nats, the sep loss against one model's
MOE_TOL = 1e-5        # the MoE output, loss and gradients (f32), by norm
GSHARD_CAP = (0.2, 0.4)
P = 4                 # the ring of (a)
# the depth of (b)'s Llama-0.76B: widths and checks as at 12 layers, the
# depth cut so the smoke's run stays well inside its time limit
SEP_LAYERS = 2


def _ra():
    # the module (distributed exports its function under the same name)
    return importlib.import_module(
        "paddle_tpu_torch.distributed.ring_attention")


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _timed(fn, device, reps=3):
    """Median seconds of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _rel1(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


# --------------------------------------------------------------- (a)
def block_loop(q, k, v, do, causal: bool, world: int = P):
    """Every rank of a ring of ``world`` run in turn through ``ListHop``
    (one process): ``(O, dQ, dK, dV)`` over the whole sequence."""
    import torch

    ra = _ra()
    C = q.shape[1] // world
    ch = lambda t: [t[:, i * C:(i + 1) * C].contiguous()
                    for i in range(world)]
    qs, ks, vs, dos = ch(q), ch(k), ch(v), ch(do)
    scale = 1.0 / math.sqrt(q.shape[-1])
    fwd = [ra.ring_block_forward(qs[r], ra.ListHop(ks, vs, r), r, world,
                                 causal, scale) for r in range(world)]
    dks = [torch.zeros(t.shape, device=t.device) for t in ks]
    dvs = [torch.zeros(t.shape, device=t.device) for t in vs]
    dqs = [ra.ring_block_backward(qs[r], dos[r], fwd[r][0], fwd[r][1],
                                  ra.ListHop(ks, vs, r, dks, dvs), r, world,
                                  causal, scale) for r in range(world)]
    return (torch.cat([o for o, _ in fwd], 1), torch.cat(dqs, 1),
            torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype))


def _unweighted_merge(acc, m, l, o, lse):
    """The control's merge: every block weighted 1 (module docstring)."""
    import torch

    ra = _ra()
    if acc is None:
        return o.float(), lse, torch.ones_like(lse)
    m_new = torch.maximum(m, lse)
    alpha = torch.exp(m - m_new)
    return (acc * ra._rows(alpha) + o.float(), m_new,
            l * alpha + torch.ones_like(lse))


@contextlib.contextmanager
def _patched(module, name, value):
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, kept)


def ring_check(device: str, small: bool) -> dict:
    """(a) of the module docstring: its record."""
    import torch

    from ..ops import flash_attention as fa

    B, S, H, D = (1, 256, 4, 64) if small else (1, 8192, 16, 128)
    gen = torch.Generator(device=device).manual_seed(5)
    # q with std 3, scores of std ~3 (sharper than iid unit inputs give):
    # the blocks' LSEs differ, so the control's unweighted merge shows
    q, k, v, do = ((torch.randn(B, S, H, D, generator=gen, device=device)
                    * (3.0 if i == 0 else 1.0)).to(torch.bfloat16)
                   for i in range(4))
    scale = 1.0 / math.sqrt(D)
    out = {"shape": [B, S, H, D], "world": P}
    for causal in (True, False):
        fa.reset_counters()
        got = block_loop(q, k, v, do, causal)
        launches = {n: fa.kernel_launches[n] + fa.plain_calls[n]
                    for n in fa.KERNELS}
        o, lse = fa.flash_fwd(q, k, v, causal=causal)
        one = (o,) + fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
        ro, rl = fa.ref_flash_fwd(q, k, v, causal, scale)
        delta = fa.flash_delta(ro, do)
        plain = (ro, fa.ref_flash_dq(q, k, v, do, rl, delta, causal, scale),
                 *fa.ref_flash_dkv(q, k, v, do, rl, delta, causal, scale))
        del rl, delta
        names = ("o", "dq", "dk", "dv")
        rec = {"launches": launches,
               "rel_one_call": dict(zip(names, map(_rel1, got, one))),
               "rel_plain": dict(zip(names, map(_rel1, got, plain))),
               "one_call_rel_plain": dict(zip(names, map(_rel1, one,
                                                         plain)))}
        del plain
        _empty(device)
        with _patched(_ra(), "_merge", _unweighted_merge):
            rec["control_rel_one_call"] = _rel1(
                block_loop(q, k, v, do, causal)[0], one[0])
        ra = _ra()
        C = S // P
        ch = lambda t: [t[:, i * C:(i + 1) * C].contiguous()
                        for i in range(P)]
        qs, ks, vs, dos = ch(q), ch(k), ch(v), ch(do)
        fwd = [ra.ring_block_forward(qs[r], ra.ListHop(ks, vs, r), r, P,
                                     causal, scale) for r in range(P)]

        def ring_fwd():
            for r in range(P):
                ra.ring_block_forward(qs[r], ra.ListHop(ks, vs, r), r, P,
                                      causal, scale)

        dks = [torch.zeros(t.shape, device=t.device) for t in ks]
        dvs = [torch.zeros(t.shape, device=t.device) for t in vs]

        def ring_bwd():
            for r in range(P):
                ra.ring_block_backward(qs[r], dos[r], fwd[r][0], fwd[r][1],
                                       ra.ListHop(ks, vs, r, dks, dvs), r,
                                       P, causal, scale)

        rec["ring_fwd_s"] = _timed(ring_fwd, device)
        rec["ring_bwd_s"] = _timed(ring_bwd, device)
        rec["one_call_fwd_s"] = _timed(
            lambda: fa.flash_fwd(q, k, v, causal=causal), device)
        rec["one_call_bwd_s"] = _timed(
            lambda: fa.flash_bwd(q, k, v, o, lse, do, causal=causal), device)
        out["causal" if causal else "full"] = rec
        del fwd, dks, dvs, one, got
        _empty(device)
    return out


# --------------------------------------------------------------- (b)
def _llama_config(small: bool):
    from ..models import LlamaConfig, llama_tiny

    if small:
        return llama_tiny(recompute=True, fused_loss=True,
                          sequence_parallel=True), 128
    S = 8192
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       num_layers=SEP_LAYERS,
                       num_heads=16, num_key_value_heads=16,
                       max_position_embeddings=S, recompute=True,
                       fused_loss=True, sequence_parallel=True), S


def _llama_step(net, ids, labels):
    from .. import amp

    with amp.auto_cast(level="O2", dtype="bfloat16"):
        _, loss = net(ids, labels=labels)
    loss.backward()
    return float(loss.detach())


def _grads_and_clear(model):
    out = {}
    for n, p in model.named_parameters():
        out[n] = p.grad.detach().float().clone()
        p.grad = None
    return out


def _local_rope():
    """The control's RoPE: the chunk's local positions."""
    from ..models import llama as llama_mod

    kept = llama_mod._rope_rows
    return _patched(llama_mod, "_rope_rows",
                    lambda pos, dim, theta: kept(pos - pos[0], dim, theta))


def _sep_llama(device: str, small: bool) -> dict:
    """(b) of the module docstring, on this rank: its record (the
    comparisons on rank 0, which holds one model's gradients)."""
    import torch

    from .. import amp
    from .. import distributed as dist
    from ..distributed import fleet, topology
    from ..models import LlamaForCausalLM
    from ..ops import flash_attention as fa

    ra = _ra()
    rank = dist.get_rank()
    cfg, S = _llama_config(small)
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    amp.decorate(model, level="O2", dtype="bfloat16")
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, S + 1))
    t = torch.from_numpy(tok).to(device)
    ids, labels = t[:, :-1], t[:, 1:]
    rec = {"rank": rank}
    dense = None
    topology.set_mesh(None)
    if rank == 0:  # one model over the whole sequence
        rec["dense_loss"] = _llama_step(model, ids, labels)
        dense = _grads_and_clear(model)
    dist.barrier()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sep_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    net = fleet.distributed_model(model)
    only_own = _patched(ra, "_skipped", lambda causal, src, r: src != r)
    for name, fault in (("sep", contextlib.nullcontext()),
                        ("control_no_hop", only_own),
                        ("control_local_rope", _local_rope())):
        fa.reset_counters()
        before = _flash()
        ra.hop_bytes[0] = 0
        _sync(device)
        t0 = time.perf_counter()
        with fault:
            loss = _llama_step(net, ids, labels)
        _sync(device)
        run = {"seconds": time.perf_counter() - t0, "loss": loss,
               "launches": {k: v - before[k] for k, v in _flash().items()},
               "plain_calls": dict(fa.plain_calls),
               "hop_bytes": ra.hop_bytes[0]}
        grads = _grads_and_clear(model)
        if dense is not None:
            run["grads_rel"] = _rel(grads, dense, SEP_GRAD_TOL)
        del grads
        rec[name] = run
    topology.set_mesh(None)
    del net, model, dense
    _empty(device)
    return rec


# --------------------------------------------------------------- (c)
def _moe_sizes(small: bool):
    return (64, 128, 8, 2, 32) if small else (1024, 4096, 8, 8, 1024)


def _bank(small: bool, gate_kind: str):
    """The 8 experts and the gate, from seed 0 (every rank and the local
    path build the same)."""
    from .. import generator
    from ..incubate.distributed.models.moe import (ExpertLayer, GShardGate,
                                                   NaiveGate)

    d, h, E, _, _ = _moe_sizes(small)
    generator.seed(0)
    experts = [ExpertLayer(d, h) for _ in range(E)]
    gate = (NaiveGate(d, E, 1, topk=2) if gate_kind == "naive"
            else GShardGate(d, E, 1, capacity=GSHARD_CAP,
                            random_routing=False))
    return experts, gate


def _moe_run(net, moe, x, training):
    from .. import Tensor

    moe.train() if training else moe.eval()
    out = net(Tensor._wrap(x))
    loss = out.pow(2).mean()
    if moe.gate.has_loss:
        loss = loss + 0.01 * moe.gate.get_loss()
    loss.backward()
    grads = {}
    for n, p in moe.named_parameters():
        grads[n] = p.grad._value.detach().clone()
        p.clear_gradient()
    return out._value.detach(), loss._value.detach(), grads


def _ep_moe(device: str, small: bool) -> dict:
    """(c) of the module docstring, on this rank: its record. Both ranks
    run the local path on every token too, each comparing its share."""
    import torch

    from .. import distributed as dist
    from ..distributed import fleet, topology
    from ..incubate.distributed.models.moe import (ClipGradForMOEByGlobalNorm,
                                                   MoELayer)
    from ..incubate.distributed.models.moe import moe_layer, utils

    d, _, E, B, S = _moe_sizes(small)
    rank = dist.get_rank()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, d)).astype("float32")).to(device)
    half = B // 2
    mine = x[rank * half:(rank + 1) * half]
    topology.set_mesh(None)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    group = fleet.get_hybrid_communicate_group().get_data_parallel_group()
    rec = {"rank": rank}
    for kind, training in (("naive", False), ("gshard", True)):
        experts, gate = _bank(small, kind)
        local = MoELayer(d, experts, gate=gate)
        ref = _moe_run(local, local, x, training)
        local_s = _timed(lambda: _moe_run(local, local, x, training), device)
        experts, gate = _bank(small, kind)
        moe = MoELayer(d, experts, gate=gate, moe_group=group)
        net = dist.DataParallel(moe, group=group)
        mine_ref = ref[0][rank * half:(rank + 1) * half]
        runs = {}
        for name, fault in (
                ("ep", contextlib.nullcontext()),
                ("control_no_ep_scale",
                 _patched(moe_layer._GradScale, "apply",
                          staticmethod(lambda t, f: t))),
                ("control_capacity_per_rank",
                 _patched(utils, "_lower_ranks",
                          lambda counts, group: torch.zeros_like(counts)))):
            if name == "control_capacity_per_rank" and kind != "gshard":
                continue
            with fault:
                out, loss, grads = _moe_run(net, moe, mine, training)
            mean_loss = loss.clone()
            dist.all_reduce(mean_loss, op="avg", group=group)
            runs[name] = {
                "out_rel": _rel1(out, mine_ref),
                "loss_rel": _rel1(mean_loss, ref[1]),
                "grads_rel": _rel(grads, {n: ref[2][n] for n in grads},
                                  MOE_TOL)}
            if name == "ep":
                params = list(moe.parameters())
                pg = [(p, _tensor(grads[n]))
                      for (n, _), p in zip(moe.named_parameters(), params)]
                clip = ClipGradForMOEByGlobalNorm(
                    1e-3, is_expert_param_func=lambda p: getattr(
                        p._value, "no_sync", False), moe_group=group)
                lpg = [(p, _tensor(ref[2][n]))
                       for n, p in local.named_parameters()]
                runs[name]["clip_factor"] = _clip_factor(clip, pg)
                runs[name]["local_clip_factor"] = _clip_factor(
                    ClipGradForMOEByGlobalNorm(1e-3), lpg)
                # the gate's assignments past the capacity (every rank
                # calls: the gate gathers the ranks' counts)
                _, idx = moe.gate(_tensor(mine.reshape(-1, d)))
                runs[name]["dropped"] = int((idx._value < 0).sum())
        runs["ep_s"] = _timed(lambda: _moe_run(net, moe, mine, training),
                              device)
        runs["local_s"] = local_s
        rec[kind] = runs
        del local, moe, net, ref
        _empty(device)
    topology.set_mesh(None)
    return rec


def _tensor(v):
    from .. import Tensor

    return Tensor._wrap(v)


def _clip_factor(clip, pg) -> float:
    """The factor ``clip`` scales by: at the largest gradient element."""
    clipped = clip(pg)
    g = pg[0][1]._value.reshape(-1)
    c = clipped[0][1]._value.reshape(-1)
    i = int(g.abs().argmax())
    return float(c[i] / g[i])


# ----------------------------------------------------------- the job
def rank_main(device: str, small: bool) -> dict:
    """One rank's drills (b) and (c): its record."""
    import torch

    from .. import distributed as dist
    from .. import set_device

    torch.set_num_threads(1)
    set_device(device)
    dist.init_parallel_env(backend="gloo", mesh_axes={})
    rec = {"rank": dist.get_rank()}
    t0 = time.perf_counter()
    rec["sep"] = _sep_llama(device, small)
    rec["sep_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["moe"] = _ep_moe(device, small)
    rec["moe_s"] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    return rec


def _want_launches(layers: int) -> Dict[int, dict]:
    """K1-K3 launches of (b) on each rank (module docstring)."""
    return {r: {"flash_fwd": 2 * (r + 1) * layers,
                "flash_dq": (r + 1) * layers,
                "flash_dkv": (r + 1) * layers} for r in (0, 1)}


def check(ring: dict, recs: Dict[int, dict], device: str,
          layers: int) -> dict:
    """Hold (a)-(c) to the module docstring's limits; raises
    ``DrillFailed``. Returns the summary."""
    problems = []
    for case in ("causal", "full"):
        r = ring[case]
        for what in ("rel_one_call", "rel_plain"):
            bad = {k: v for k, v in r[what].items() if v > RING_TOL}
            if bad:
                problems.append(f"ring {case} {what}: {bad} over {RING_TOL}")
        if r["control_rel_one_call"] <= RING_TOL:
            problems.append(f"ring {case}: the unweighted merge is only "
                            f"{r['control_rel_one_call']} off")
    s0 = recs[0]["sep"]
    for name in ("sep", "control_no_hop", "control_local_rope"):
        g = s0[name]["grads_rel"]
        want_over = name.startswith("control")
        if bool(g["over"]) != want_over:
            problems.append(
                f"sep {name}: {g['over']} of {g['leaves']} leaves over "
                f"{SEP_GRAD_TOL} by norm (largest {g['max']} at {g['leaf']})"
                + ("; a control must fail the check" if want_over else ""))
    for r in (0, 1):
        if abs(recs[r]["sep"]["sep"]["loss"] - s0["dense_loss"]) > LOSS_TOL:
            problems.append(f"sep rank {r}: loss {recs[r]['sep']['sep']['loss']}"
                            f" against {s0['dense_loss']}")
    if device.startswith("cuda"):
        want = _want_launches(layers)
        for r in (0, 1):
            run = recs[r]["sep"]["sep"]
            got = {k: run["launches"][k] for k in want[r]}
            if got != want[r] or any(run["plain_calls"].values()):
                problems.append(f"sep rank {r}: K1-K3 launches "
                                f"{run['launches']} (plain "
                                f"{run['plain_calls']}), want {want[r]}")
    for r in (0, 1):
        m = recs[r]["moe"]
        for kind in ("naive", "gshard"):
            for name, run in m[kind].items():
                if not isinstance(run, dict):
                    continue
                worst = max(run["out_rel"], run["loss_rel"],
                            run["grads_rel"]["max"])
                want_over = name.startswith("control")
                if (worst > MOE_TOL) != want_over:
                    problems.append(
                        f"moe rank {r} {kind} {name}: worst {worst} against "
                        f"{MOE_TOL}" + ("; a control must fail the check"
                                        if want_over else ""))
            ep = m[kind]["ep"]
            if abs(ep["clip_factor"] - ep["local_clip_factor"]) \
                    > 1e-4 * ep["local_clip_factor"]:
                problems.append(f"moe rank {r} {kind}: clip factor "
                                f"{ep['clip_factor']} against the local "
                                f"{ep['local_clip_factor']}")
    # the global arrival order: rank 0's tokens fill the capacity first
    if not sum(recs[r]["moe"]["gshard"]["ep"]["dropped"] for r in (0, 1)):
        problems.append("moe: gshard dropped no assignment")
    if problems:
        raise DrillFailed("; ".join(problems))
    sep = {name: {k: v for k, v in s0[name].items()}
           for name in ("sep", "control_no_hop", "control_local_rope")}
    return {"ring": ring, "sep": sep | {
                "dense_loss": s0["dense_loss"],
                "rank1": {k: recs[1]["sep"]["sep"][k]
                          for k in ("seconds", "loss", "launches",
                                    "hop_bytes")}},
            "moe": {r: recs[r]["moe"] for r in (0, 1)},
            "launches": {"train_sep2_llama076b": {
                k: recs[0]["sep"]["sep"]["launches"][k]
                + recs[1]["sep"]["sep"]["launches"][k]
                for k in recs[0]["sep"]["sep"]["launches"]}},
            "seconds": {r: (recs[r]["sep_s"], recs[r]["moe_s"])
                        for r in (0, 1)}}


def run(device: str = "cuda", small: bool = False, log=print) -> dict:
    """(a) here, then (b) and (c) on two ranks (module docstring), joined,
    checked: the summary."""
    from .. import distributed as dist

    t0 = time.perf_counter()
    ring = ring_check(device, small)
    t1 = time.perf_counter()
    ctx = dist.spawn(rank_main, args=(device, small), nprocs=2,
                     backend="cpu" if device == "cpu" else "gpu")
    recs = ctx.results()
    alive = [p.pid for p in ctx.processes if p.is_alive()]
    if alive:
        raise DrillFailed(f"ranks {alive} still running after the join")
    log("sep_moe records: " + json.dumps({"ring": ring, "ranks": recs},
                                         default=str))
    out = check(ring, recs, device, _llama_config(small)[0].num_layers)
    out["ring_s"] = t1 - t0
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
