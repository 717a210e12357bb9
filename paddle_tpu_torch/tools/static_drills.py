"""``static`` and dy2static on one card: GPT-355M trained through a static
Program, a ``to_static`` greedy decode whose tensor ``while`` is a WHILE
node, and a small control-flow matrix.

    python -m paddle_tpu_torch.tools.static_drills            # on cuda
    python -m paddle_tpu_torch.tools.static_drills --small --device cpu

Four parts, each checked (a failure raises ``DrillFailed``):

(a) Training through a static Program. GPT-355M as ``bench.py:271-283``
    configures it (vocab 50304, hidden 1024, 24 layers, 16 heads of 64,
    no dropout), f32, seeded weights. Built under ``program_guard``:
    ``static.data("ids"|"lab", [None, 1024], "int64")``, ``model(ids,
    labels=lab)`` and ``AdamW(1e-4).minimize(loss)`` (its parameters
    collected from the program). Run: four ``Executor.run`` steps at B 4,
    then two at B 2 (a second feed signature: its first call is eager,
    its second captured), on seeded ids. The same six steps run as the
    port's eager dygraph loop (``loss.backward()``, ``step()``,
    ``clear_grad()``) on a second model from the same seed: every loss
    and every parameter bit for bit, two captures, K1/K2/K3 24 launches
    each a step (eager launches plus replays), K4, K5 and the plain
    versions none.
(b) A ``to_static`` greedy decode (:func:`greedy_decode`: a full ``[B,
    L]`` token buffer, ``while cur < L and not paddle.all(done)``, each
    new token written with ``paddle.where(pos == cur, ...)``) over the
    same model in eval, B 4, L 256, a 32-token prompt, so K1 runs inside
    the WHILE body. One eager first call, then three calls on the one
    captured graph: four equal prompts with a stop token the model
    reaches early (found by a Python loop of ``STOP_SEARCH`` steps on a
    shorter buffer), random prompts that
    run to L, and a start at ``cur == L`` (zero trips). Tokens and the
    final ``cur`` of each equal the Python loop's on the card bit for
    bit; K1 is captured 24 times (once a layer of the body, whatever the
    trip count); the trips are read from the returned ``cur``.
(c) The control-flow matrix at a small width, inside ``to_static`` and
    inside an Executor program: ``cond`` (dy2static ``if``), ``case``,
    ``switch_case`` and ``while_loop``, each replayed with feeds that take
    every branch (a graph that baked one branch gives a wrong answer),
    against plain numpy; a ``cond`` nested in a WHILE body; the gradient
    through a captured ``cond`` equal to the eager one on both branches;
    a captured branch that reads a host value raises RuntimeError, and
    a later capture still works.
(d) The WHILE node itself: a body of one add, 1,000 trips from a graph
    replay, against :func:`ops.graph_cond.plain_while` (the host reads the
    predicate every trip): ms a trip of each.

``--small`` runs each part at a width the CPU takes (everything eager:
there is no capture there, and the launch checks need the card).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
TRAIN_B = (4, 4, 4, 4, 2, 2)
DECODE_B, DECODE_L, PROMPT = 4, 256, 32
STOP_SEARCH = 16
WHILE_TRIPS = 1000
# the last decode drill's cases and tokens (decode())
LAST_DECODE: dict = {}


class DrillFailed(RuntimeError):
    """A drill's check did not hold."""


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _config(small: bool):
    from ..models import GPTConfig

    if small:
        return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=4, max_position_embeddings=64,
                         hidden_dropout_prob=0.0,
                         attention_dropout_prob=0.0), 32
    return GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                     num_heads=16, max_position_embeddings=1024,
                     hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0), 1024


def _counts():
    from ..ops import embedding_grad as eg
    from ..ops import flash_attention as fa
    from ..ops import fused_adamw as fw
    from ..ops import graph_cond as gc
    from ..ops import paged_attention as pa

    out = {k: fa.kernel_launches[k] + fa.replayed_launches[k]
           for k in KERNELS}
    out.update(captured={k: fa.captured_launches[k] for k in KERNELS},
               plain=sum(fa.plain_calls.values()),
               paged_attention=pa.kernel_launches + pa.replayed_launches,
               fused_adamw=fw.kernel_launches,
               embedding_grad=eg.kernel_launches + eg.replayed_launches,
               while_nodes=gc.captured_launches,
               while_replays=gc.replayed_launches,
               if_nodes=gc.if_captured)
    return out


def _reset():
    from ..ops import embedding_grad as eg
    from ..ops import flash_attention as fa
    from ..ops import fused_adamw as fw
    from ..ops import graph_cond as gc
    from ..ops import paged_attention as pa

    for m in (fa, pa, fw, eg, gc):
        m.reset_counters()


def _batches(cfg, S, sizes, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for B in sizes:
        ids = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int64)
        out.append((ids, np.roll(ids, -1, axis=1)))
    return out


# ----------------------------------------------------------------- (a)
def train(device: str, small: bool) -> dict:
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from ..models import GPTForCausalLM

    cfg, S = _config(small)
    data = _batches(cfg, S, TRAIN_B)
    # the port's eager dygraph loop
    eager = GPTForCausalLM(cfg, device=device, seed=0)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=eager.parameters())
    eager_losses = []
    for ids, lab in data:
        _, loss = eager(paddle.to_tensor(ids, place=device),
                        labels=paddle.to_tensor(lab, place=device))
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager_losses.append(loss._value.detach().clone())
    want = [p.detach().clone() for p in eager.parameters()]
    del eager, opt, loss
    _sync(device)
    # the static Program
    model = GPTForCausalLM(cfg, device=device, seed=0)
    t0 = time.perf_counter()
    main, startup = static.Program(), static.Program()
    with paddle.device.using_device(device), \
            static.program_guard(main, startup):
        ids = static.data("ids", [None, S], "int64")
        lab = static.data("lab", [None, S], "int64")
        _, loss = model(ids, labels=lab)
        sopt = paddle.optimizer.AdamW(learning_rate=1e-4)
        sopt.minimize(loss)
    build_s = time.perf_counter() - t0
    n_params = len(sopt._parameter_list)
    exe = static.Executor(device)
    exe.run(startup)
    _sync(device)
    _reset()
    losses, step_s = [], []
    for ids_np, lab_np in data:
        t1 = time.perf_counter()
        (lv,) = exe.run(main, feed={"ids": ids_np, "lab": lab_np},
                        fetch_list=[loss], return_numpy=False)
        _sync(device)
        step_s.append(time.perf_counter() - t1)
        losses.append(lv._value)
    counts = _counts()
    problems = []
    same_loss = [bool(torch.equal(a.reshape(()), b.reshape(())))
                 for a, b in zip(losses, eager_losses)]
    if not all(same_loss):
        problems.append(f"losses differ from the eager loop: "
                        f"{[float(x) for x in losses]} vs "
                        f"{[float(x) for x in eager_losses]}")
    differ = sum(not torch.equal(p.detach(), w)
                 for p, w in zip(model.parameters(), want))
    if differ:
        problems.append(f"{differ} parameters differ from the eager loop")
    fns = list(exe._cache.values())
    captured = sum(f.compile_counts()["captured"] for f in fns)
    if _cuda(device):
        per_step = cfg.num_layers
        for k in KERNELS:
            if counts[k] != per_step * len(data):
                problems.append(f"{k} launched {counts[k]} times, expected "
                                f"{per_step} a step over {len(data)}")
        if captured != 2:
            problems.append(f"{captured} captures, expected 2")
        for k in ("paged_attention", "fused_adamw", "plain"):
            if counts[k]:
                problems.append(f"{k}: {counts[k]} launches, expected 0")
    if problems:
        raise DrillFailed("static training: " + "; ".join(problems))
    cap = [s for f in fns for s in f.capture_seconds().values()]
    return {"losses": [float(x) for x in losses],
            "losses_equal": all(same_loss), "params_differing": differ,
            "params": n_params, "signatures": len(fns),
            "captures": captured, "capture_s": cap, "build_s": build_s,
            "step_ms": [1e3 * s for s in step_s],
            "step_ms_replayed_b4": 1e3 * float(np.median(step_s[2:4])),
            "launches": {k: counts[k] for k in KERNELS}
            | {k: counts[k] for k in ("paged_attention", "fused_adamw",
                                      "embedding_grad", "plain")}}


# ----------------------------------------------------------------- (b)
def greedy_decode(model, tokens, cur, stop):
    """Greedy decoding into the full ``[B, L]`` buffer ``tokens`` from
    position ``cur`` until ``L`` or until every row has produced
    ``stop``; returns the buffer and the final ``cur``."""
    import paddle_tpu_torch as paddle

    B, L = tokens.shape[0], tokens.shape[1]
    done = paddle.zeros([B], dtype="bool")
    pos = paddle.arange(L, dtype="int64")
    while cur < L and not paddle.all(done):
        logits = model(tokens)
        last = paddle.index_select(logits, (cur - 1).reshape([1]), axis=1)
        nxt = paddle.argmax(last, axis=-1)
        tokens = paddle.where(pos == cur, nxt, tokens)
        done = paddle.logical_or(done, nxt.reshape([B]) == stop)
        cur = cur + 1
    return tokens, cur


def _stop_token(row: np.ndarray, start: int, within: int) -> int:
    """The token of ``row[start:start + within]`` whose first occurrence
    there is latest: a greedy decode of that prompt stops there."""
    first = {}
    for j, t in enumerate(row[start:start + within].tolist()):
        first.setdefault(int(t), j)
    return max(first, key=first.get)


def decode(device: str, small: bool) -> dict:
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jit
    from ..models import GPTForCausalLM

    cfg, _ = _config(small)
    L = 32 if small else DECODE_L
    prompt = 8 if small else PROMPT
    B = DECODE_B
    model = GPTForCausalLM(cfg, device=device, seed=0).eval()
    rng = np.random.default_rng(7)

    def buf(rows):
        t = np.zeros((B, L), np.int64)
        t[:, :prompt] = rows
        return t

    def scalar(v):
        return paddle.to_tensor(np.int64(v), place=device)

    def plain(tokens, cur, stop):
        with torch.no_grad(), paddle.device.using_device(device):
            tok, c = greedy_decode(model, paddle.to_tensor(tokens,
                                                           place=device),
                                   scalar(cur), scalar(stop))
        return tok._value.clone(), int(c)

    one = rng.integers(0, cfg.vocab_size, (1, prompt))
    same = buf(np.repeat(one, B, axis=0))
    free = buf(rng.integers(0, cfg.vocab_size, (B, prompt)))
    t0 = time.perf_counter()
    # the stop token: the loop's first STOP_SEARCH tokens on the equal
    # prompts (a buffer that ends there runs to its end)
    head, _ = plain(same[:, :prompt + STOP_SEARCH], prompt, -1)
    stop = _stop_token(head[0].cpu().numpy(), prompt, STOP_SEARCH)
    cases = {"early": (same, prompt, stop), "to_L": (free, prompt, -1),
             "zero_trips": (free, L, -1)}
    want = {name: plain(*c) for name, c in cases.items()}
    plain_s = time.perf_counter() - t0
    if not want["early"][1] < L:
        raise DrillFailed(f"decode: the early case ran to {want['early'][1]}")
    sf = jit.to_static(greedy_decode)

    def call(tokens, cur, stop_):
        with torch.no_grad(), paddle.device.using_device(device):
            tok, c = sf(model, paddle.to_tensor(tokens, place=device),
                        scalar(cur), scalar(stop_))
        return tok._value, c._value

    _sync(device)
    _reset()
    got, ms = {}, {}
    call(*cases["early"])  # the signature's eager first call
    _sync(device)
    eager_counts = _counts()
    for name, c in cases.items():
        t1 = time.perf_counter()
        tok, cur = call(*c)
        _sync(device)
        ms[name] = 1e3 * (time.perf_counter() - t1)
        got[name] = (tok.clone(), int(cur))
    counts = _counts()
    problems = []
    trips = {}
    for name, (tok, cur) in got.items():
        wtok, wcur = want[name]
        trips[name] = cur - cases[name][1]
        if cur != wcur or not torch.equal(tok, wtok):
            problems.append(f"{name}: cur {cur} vs {wcur}, tokens equal "
                            f"{bool(torch.equal(tok, wtok))}")
    if not (0 < trips["early"] < L - prompt and trips["to_L"] == L - prompt
            and trips["zero_trips"] == 0):
        problems.append(f"trips {trips}")
    compiles = sf.compile_counts()
    captured_k1 = counts["captured"]["flash_fwd"]
    if _cuda(device):
        if compiles["captured"] != 1:
            problems.append(f"compile counts {compiles}")
        if captured_k1 != cfg.num_layers:
            problems.append(f"K1 captured {captured_k1} times, expected "
                            f"{cfg.num_layers}")
        if counts["while_nodes"] != 1 or counts["while_replays"] != 3:
            problems.append(f"WHILE nodes {counts['while_nodes']} captured,"
                            f" {counts['while_replays']} replayed")
        if counts["plain"] or counts["flash_dq"] or counts["flash_dkv"]:
            problems.append(f"plain K1 or K2/K3 ran: {counts}")
    if problems:
        raise DrillFailed("static decode: " + "; ".join(problems))
    # for tools/export_drills.py: the same calls through a loaded program
    LAST_DECODE.clear()
    LAST_DECODE.update(device=str(device), small=small, cases=cases,
                       python_loop=want, while_node=got,
                       ms_per_trip=ms["to_L"] / max(trips["to_L"], 1))
    eager_k1 = eager_counts["flash_fwd"]
    return {"trips": trips, "final_cur": {n: g[1] for n, g in got.items()},
            "stop_token": stop, "tokens_equal": True,
            "ms_per_call": ms,
            "ms_per_trip": ms["to_L"] / max(trips["to_L"], 1),
            "plain_loops_s": plain_s, "compile_counts": compiles,
            "capture_s": list(sf.capture_seconds().values()),
            "k1_captured": captured_k1, "k1_eager_first_call": eager_k1,
            # K1's real launches on the path: the eager first call's, then
            # a layer's K1 each trip of each replayed call
            "launches": {"flash_fwd": eager_k1
                         + captured_k1 * sum(trips.values()),
                         "flash_dq": counts["flash_dq"],
                         "flash_dkv": counts["flash_dkv"],
                         "while_nodes": counts["while_replays"]}
            | {k: counts[k] for k in ("paged_attention", "fused_adamw",
                                      "embedding_grad", "plain")}}


# ----------------------------------------------------------------- (c)
def _cf_fn_if(x, w):
    if x.sum() > 0:
        y = x * w
    else:
        y = x - w
    return y


def _cf_fn_nested(x, n):
    import paddle_tpu_torch as paddle

    i = paddle.zeros([], dtype="int64")
    s = x
    while i < n:
        if (i % 2) == 0:
            s = s + 1.0
        else:
            s = s * 2.0
        i = i + 1
    return s, i


def _cf_case(a, x):
    from paddle_tpu_torch.static import nn

    return nn.case([(a > 3, lambda: x + 100.0), (a > 1, lambda: x + 10.0)],
                   default=lambda: x)


def _cf_switch(idx, v):
    from paddle_tpu_torch.static import nn

    return nn.switch_case(idx, [lambda: v * 1.0, lambda: v * 10.0,
                                lambda: v * 20.0])


def _cf_while(x, n):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.static import nn

    i0 = paddle.zeros([], dtype="int64")
    _, v = nn.while_loop(lambda i, v: i < n, lambda i, v: [i + 1, v * 1.5],
                         [i0, x])
    return v


def _cf_host_read(x):
    from paddle_tpu_torch.static import nn

    return nn.cond(x.sum() > 0, lambda: x * float(x.sum().item()),
                   lambda: x)


def _near(a, b, tol=1e-5) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.allclose(a, b, rtol=tol, atol=tol)


def control_flow(device: str, small: bool) -> dict:
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jit, static
    from paddle_tpu_torch.static import nn

    def T(v, dtype=None):
        return paddle.to_tensor(np.asarray(v, dtype), place=device)

    problems, checked = [], {}
    with paddle.device.using_device(device):
        W = T(np.float32(3.0))
        # to_static: each construct, every branch, one signature
        sf = jit.to_static(_cf_fn_if)
        for xv in ([1.0, 2.0], [-1.0, -2.0], [3.0, 1.0], [-4.0, 0.5]):
            x = np.asarray(xv, np.float32)
            want = x * 3 if x.sum() > 0 else x - 3
            if not _near(sf(T(x), W).numpy(), want):
                problems.append(f"to_static if {xv}")
        checked["to_static_if"] = sf.compile_counts()
        sf = jit.to_static(_cf_case)
        for av, want in ((2.0, 11.0), (5.0, 101.0), (0.0, 1.0), (4.0, 101.0),
                         (1.5, 11.0)):
            got = sf(T(np.float32(av)), T(np.ones(1, np.float32))).numpy()
            if not _near(got, [want]):
                problems.append(f"to_static case {av}: {got}")
        checked["to_static_case"] = sf.compile_counts()
        sf = jit.to_static(_cf_switch)
        for iv, want in ((2, 20.0), (0, 1.0), (1, 10.0), (7, 20.0), (1, 10.0)):
            got = sf(T(np.int64(iv)), T(np.ones(1, np.float32))).numpy()
            if not _near(got, [want]):
                problems.append(f"to_static switch_case {iv}: {got}")
        checked["to_static_switch_case"] = sf.compile_counts()
        sf = jit.to_static(_cf_while)
        for nv in (5, 2, 0, 7):
            got = sf(T(np.ones(1, np.float32)), T(np.int64(nv))).numpy()
            if not _near(got, [1.5 ** nv]):
                problems.append(f"to_static while_loop {nv}: {got}")
        checked["to_static_while_loop"] = sf.compile_counts()
        sf = jit.to_static(_cf_fn_nested)
        for nv in (3, 0, 4, 5):
            s, i = sf(T(np.ones(2, np.float32)), T(np.int64(nv)))
            v = 1.0
            for k in range(nv):
                v = v + 1.0 if k % 2 == 0 else v * 2.0
            if not (_near(s.numpy(), [v, v]) and int(i) == nv):
                problems.append(f"cond in a WHILE body, n {nv}: "
                                f"{s.numpy()}, {int(i)}")
        checked["to_static_cond_in_while"] = sf.compile_counts()
        # the gradient through a captured cond, on both branches
        grads = {}
        for mode in ("eager", "captured"):
            w = paddle.create_parameter([2], "float32")
            with torch.no_grad():
                w._value.copy_(torch.tensor([2.0, 3.0]))

            def step(x, w=w):
                loss = nn.cond(x.sum() > 0, lambda: (x * w).sum(),
                               lambda: (x - w * w).sum())
                (g,) = paddle.grad([loss], [w])
                return loss, g

            fn = step if mode == "eager" else jit.to_static(step)
            out = []
            for xv in ([1.0, 2.0], [-1.0, -2.0], [1.0, 2.0], [-3.0, 1.0]):
                loss, g = fn(T(np.asarray(xv, np.float32)))
                out.append((float(loss), g.numpy().tolist()))
            grads[mode] = out
        if grads["eager"] != grads["captured"]:
            problems.append(f"captured cond gradients {grads}")
        checked["cond_gradients"] = grads["captured"]
        # a host read in a captured branch
        if _cuda(device):
            sf = jit.to_static(_cf_host_read)
            x = T(np.ones(2, np.float32))
            sf(x)
            try:
                sf(x)
                problems.append("a host read in a captured branch did not "
                                "raise")
            except RuntimeError as e:
                checked["host_read_raised"] = str(e)[:160]
            sf = jit.to_static(_cf_fn_if)
            sf(T(np.ones(2, np.float32)), W)
            if not _near(sf(T(-np.ones(2, np.float32)), W).numpy(),
                         [-4.0, -4.0]):
                problems.append("a capture after the refused one is wrong")
        # inside an Executor program
        exe = static.Executor(device)
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4], "float32")
            a = static.data("a", [], "float32")
            k = static.data("k", [], "int64")
            n = static.data("n", [], "int64")
            c = nn.cond(paddle.sum(x) > 0, lambda: x * 2.0,
                        lambda: x - 1.0)
            cs = nn.case([(a > 3, lambda: x + 100.0),
                          (a > 1, lambda: x + 10.0)], default=lambda: x)
            sw = nn.switch_case(k, {0: lambda: x * 1.0, 1: lambda: x * 10.0,
                                    3: lambda: x * 30.0})
            i0 = paddle.zeros([], dtype="int64")
            _, wl = nn.while_loop(lambda i, v: i < n,
                                  lambda i, v: [i + 1, v * 1.5], [i0, x])
        for xv, av, kv, nv in ((1.0, 5.0, 0, 3), (-1.0, 2.0, 1, 0),
                               (2.0, 0.0, 3, 5), (-2.0, 4.0, 7, 1)):
            xs = np.full(4, xv, np.float32)
            got = exe.run(main, feed={"x": xs, "a": np.float32(av),
                                      "k": np.int64(kv), "n": np.int64(nv)},
                          fetch_list=[c, cs, sw, wl])
            want = [xs * 2 if xs.sum() > 0 else xs - 1,
                    xs + 100 if av > 3 else xs + 10 if av > 1 else xs,
                    xs * {0: 1, 1: 10, 3: 30}.get(kv, 30), xs * 1.5 ** nv]
            for name, g, w_ in zip(("cond", "case", "switch_case",
                                    "while_loop"), got, want):
                if not _near(g, w_):
                    problems.append(f"program {name} at x {xv}, a {av}, k "
                                    f"{kv}, n {nv}: {g} vs {w_}")
        checked["program_signatures"] = len(exe._cache)
        checked["program_captured"] = sum(
            f.compile_counts()["captured"] for f in exe._cache.values())
    if problems:
        raise DrillFailed("control flow: " + "; ".join(problems))
    return checked


# ----------------------------------------------------------------- (d)
def while_node(device: str, small: bool) -> dict:
    """The WHILE node's cost a trip, from a graph replay, against the
    plain loop (module docstring)."""
    from ..ops import graph_cond as gc

    if not _cuda(device):
        return {}
    n = torch.full((), WHILE_TRIPS, dtype=torch.int64, device=device)
    i0 = torch.zeros((), dtype=torch.int64, device=device)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(s), torch.cuda.graph(g, stream=s):
        (i,) = gc.while_node(lambda i: i < n, lambda i: [i + 1], [i0])
    torch.cuda.current_stream().wait_stream(s)
    g.replay()
    torch.cuda.synchronize()
    if int(i) != WHILE_TRIPS:
        raise DrillFailed(f"WHILE node: {int(i)} trips, expected "
                          f"{WHILE_TRIPS}")
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(5):
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / WHILE_TRIPS)
    t0 = time.perf_counter()
    (p,) = gc.plain_while(lambda i: i < n, lambda i: [i + 1], [i0])
    torch.cuda.synchronize()
    plain = 1e3 * (time.perf_counter() - t0) / WHILE_TRIPS
    if int(p) != WHILE_TRIPS:
        raise DrillFailed("plain while: wrong trip count")
    # each trip reads the carry and the predicate and writes them: 8 + 8
    # + 1 + 1 bytes, and one launch of one thread
    bound = 18 / 3.35e12 * 1e3
    return {"ms_per_trip": float(np.median(times)), "plain_ms_per_trip": plain,
            "bound_ms_per_trip": bound, "bound_by": "bytes",
            "max_abs_err": float(abs(int(i) - int(p)))}


def run(device: str = "cuda", small: bool = False, log=print) -> dict:
    """The four parts; returns their records and the seconds each took."""
    if _cuda(device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out, secs = {}, {}
    for name, fn in (("train", train), ("decode", decode),
                     ("control_flow", control_flow),
                     ("while_node", while_node)):
        t0 = time.perf_counter()
        out[name] = fn(device, small)
        secs[name] = time.perf_counter() - t0
        log(f"static drills {name}: " + json.dumps(out[name], default=str))
        if _cuda(device):
            torch.cuda.empty_cache()
    out["seconds"] = secs
    out["launches"] = {"train_static_gpt355m": out["train"]["launches"],
                       "decode_static_gpt355m": out["decode"]["launches"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    try:
        run(args.device, args.small)
    except DrillFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
