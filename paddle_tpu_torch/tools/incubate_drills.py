"""``incubate`` on one card: a BERT-base-width fused encoder trained, a
GPT-355M-width ``FusedMultiTransformer`` decoding, and the rest of the
slice held against the CPU.

    python -m paddle_tpu_torch.tools.incubate_drills            # on cuda
    python -m paddle_tpu_torch.tools.incubate_drills --small --device cpu

Three parts, each checked (a failure raises ``DrillFailed``):

(a) 12 ``FusedTransformerEncoderLayer(768, 12, 3072, activation="gelu",
    normalize_before=False, dropout_rate=0.1)`` (``bench.py:425-470``'s
    BERT-base width), B 32, S 128, a bool key-padding mask ``[B, 1, 1,
    S]`` (each row's length drawn from [64, 128] by numpy seed 0), O2
    bf16 with master weights, AdamW (lr 1e-4); the loss is the mean
    squared error of the f32 output against a seeded target. Four steps
    eagerly from ``generator.seed(0)``, then, rebuilt from the same
    seed, the same four through ``jit.to_static`` (the eager first call,
    the capture, replays): every loss and every parameter bit for bit.
    K1, K2 and K3 launch 12 times a step on both runs (eager launches
    plus graph replays), nothing else on the card, no plain call. Then
    the eager steps again from the same seeds with the kernels switched
    off (``incubate.set_config({"kernel": {"enable": False}})``): no
    flash launch, losses within ``KERNEL_OFF_RTOL`` of the kernels' (the
    dense attention draws the kernels' dropout bits from the same seeds).
    Step ms eager and graphed (``TIMED`` more calls).
(b) ``FusedMultiTransformer(1024, 16, 4096, num_layers=24,
    activation="gelu")`` (``bench.py:271-283``'s GPT-355M width) in
    eval with bf16 weights; B 8 of seeded hidden states: a prefill of
    128 tokens through empty ``[B, 0, 16, 64]`` caches under a float
    causal mask (the dense attention), then ``DECODE_STEPS`` one-token
    steps carrying the returned caches with no mask, so K1 runs at Sq 1
    and Sk 129-160. K1 launches 24 a decode step, K2 and K3 none; each
    K1 call's output is held against the plain K1 on its q, k, v within
    ``K1_BF16_TOL`` (``chip_smoke.py`` phase 3b's bf16 tolerance); every
    step's output within ``DECODE_REL`` by norm of the same run with the
    kernels switched off. ms a decode step (the unchecked run).
(c) Against the CPU (f32, TF32 off), each within its stated tolerance:
    ``flash_attn_unpadded`` on 8 packed sequences of 64-512 tokens with
    16 heads of 64; ``softmax_mask_fuse_upper_triangle``; ``segment_max``
    and ``graph_send_recv`` (sum, max) on 100,000 edges over 10,000
    nodes of 64 features with their gradients (maxima exactly: ties are
    split by counts; sums by tolerance: the card adds with atomics);
    ``FusedEcMoe`` (8 experts, 1024 -> 4096); one ``LookAhead``,
    ``ModelAverage`` and ``DistributedFusedLamb`` step; ``LBFGS`` and
    ``minimize_bfgs`` on a seeded quadratic; ``asp.prune_model`` and a
    decorated AdamW step, 2:4 kept on every pruned weight.

``--small`` runs each part at a size the CPU takes; the launch checks
need the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .zoo_drills import _counts, _reset

__all__ = ["run", "DrillFailed", "K1_BF16_TOL", "KERNEL_OFF_RTOL",
           "DECODE_REL"]

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
STEPS = 4
TIMED = 5
DECODE_STEPS = 32
# phase 3b's bf16 tolerance of K1 against its plain version: (atol, rtol,
# norm-relative)
K1_BF16_TOL = (2e-3, 2.0 ** -6, 5e-3)
# the encoder's losses with the kernels off, relative to theirs: the dense
# attention rounds differently in bf16 over 12 layers and 4 steps
KERNEL_OFF_RTOL = 1e-2
# a decode step's output with the kernels off, by the norm of the
# difference over the norm: bf16 through 24 layers
DECODE_REL = 2e-2
CPU_TOL = 1e-4        # f32 card against CPU, by norm (TF32 off)


class DrillFailed(RuntimeError):
    pass


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _cuda(device) -> bool:
    return str(device).startswith("cuda")


def _rel(a, b) -> float:
    a, b = (getattr(t, "_value", t).detach().double().cpu() for t in (a, b))
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _flash_only(path, n, want, device, problems) -> None:
    """K1-K3 launched ``want[k]`` times each, nothing else on the card, no
    plain call."""
    if not _cuda(device):
        return
    other = {k: v for k, v in n.items() if k not in KERNELS + ("plain",)}
    if any(n[k] != want[k] for k in KERNELS) or n["plain"] \
            or any(other.values()):
        problems.append(f"{path}: launches {n}, {want} and nothing else "
                        "expected")


def _kernels(enable: bool) -> None:
    from ..incubate import set_config

    set_config({"kernel": {"enable": enable}})


# --------------------------------------------------------- (a) encoder
def _encoder_setup(small):
    """(layers, B, S, E, heads, FF)."""
    return (2, 4, 32, 64, 4, 128) if small else (12, 32, 128, 768, 12, 3072)


def _encoder(device, small):
    from .. import amp, generator, nn
    from ..device import using_device
    from ..incubate.nn import FusedTransformerEncoderLayer
    from ..optimizer import AdamW

    L, _, _, E, H, FF = _encoder_setup(small)
    generator.seed(0)
    with using_device(device):
        model = nn.LayerList([FusedTransformerEncoderLayer(
            E, H, FF, dropout_rate=0.1, activation="gelu",
            normalize_before=False) for _ in range(L)])
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    return amp.decorate(model, opt, level="O2", dtype="bfloat16")


def _encoder_data(device, small):
    import paddle_tpu_torch as paddle

    _, B, S, E, _, _ = _encoder_setup(small)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, E)).astype("float32")
    lens = rng.integers(S // 2, S + 1, B)
    mask = (np.arange(S)[None, :] < lens[:, None])[:, None, None, :]
    target = rng.standard_normal((B, S, E)).astype("float32")
    return tuple(paddle.to_tensor(a, place=device)
                 for a in (x, mask, target)), float(1 - mask.mean())


def _train_fn(model, opt):
    from .. import amp
    from ..nn import functional as F

    def train_fn(x, mask, target):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            h = x
            for layer in model:
                h = layer(h, src_mask=mask)
            loss = F.mse_loss(h.astype("float32"), target)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return train_fn


def _encoder_run(device, small, graphed):
    """Four steps (eager or through ``jit.to_static``); the losses, the
    parameters, the flash counts and the step ms of ``TIMED`` more
    calls."""
    from .. import jit

    model, opt = _encoder(device, small)
    args, _ = _encoder_data(device, small)
    fn = _train_fn(model, opt)
    step = jit.to_static(fn, warmup=False) if graphed else fn
    _reset()
    losses = [float(step(*args)) for _ in range(STEPS)]
    counts = _counts()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(1 if small else TIMED):
        step(*args)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / (1 if small else TIMED)
    params = [p._value.detach().clone() for p in model.parameters()]
    # the timed calls moved the state on: the compared parameters are
    # those after STEPS + the timed steps on both runs
    return losses, params, counts, ms, step


def encoder(device: str, small: bool) -> dict:
    L = _encoder_setup(small)[0]
    _, padded = _encoder_data("cpu", small)
    le, pe, ne, ms_e, _ = _encoder_run(device, small, graphed=False)
    lg, pg, ng, ms_g, step = _encoder_run(device, small, graphed=True)
    differ = [i for i, (a, b) in enumerate(zip(pe, pg))
              if not torch.equal(a, b)]
    del pe, pg
    try:
        _kernels(False)
        lo, _, no, ms_o, _ = _encoder_run(device, small, graphed=False)
    finally:
        _kernels(True)
    off_rel = max(abs(a - b) / abs(b) for a, b in zip(lo, le))
    rec = {"layers": L, "padded_share": padded,
           "losses_eager": le, "losses_graphed": lg, "losses_kernel_off": lo,
           "losses_equal": le == lg, "params_differ": differ[:8],
           "kernel_off_rel": off_rel, "step_ms_eager": ms_e,
           "step_ms_graphed": ms_g, "step_ms_kernel_off": ms_o,
           "compile_counts": step.compile_counts(),
           "capture_s": sum(step.capture_seconds().values()),
           "launches_eager": ne, "launches_graphed": ng,
           "launches_kernel_off": no}
    problems = []
    if not rec["losses_equal"] or differ:
        problems.append(f"graphed and eager differ: losses {lg} vs {le}, "
                        f"{len(differ)} parameters")
    if not all(np.isfinite(le + lo)):
        problems.append(f"a loss is not finite: {le}, {lo}")
    if off_rel > KERNEL_OFF_RTOL:
        problems.append(f"kernels off: losses {lo} against {le}, "
                        f"{off_rel:.3e} > {KERNEL_OFF_RTOL}")
    want = dict.fromkeys(KERNELS, L * STEPS)
    _flash_only("eager", ne, want, device, problems)
    _flash_only("graphed", ng, want, device, problems)
    _flash_only("kernel off", no, dict.fromkeys(KERNELS, 0), device,
                problems)
    if _cuda(device) and step.compile_counts()["captured"] != 1:
        problems.append(f"not one capture: {step.compile_counts()}")
    if problems:
        raise DrillFailed("encoder: " + "; ".join(problems))
    return rec


# ---------------------------------------------------------- (b) decode
def _decoder_setup(small):
    """(layers, B, prefill, E, heads, FF, decode steps)."""
    return ((2, 2, 16, 64, 4, 128, 4) if small
            else (24, 8, 128, 1024, 16, 4096, DECODE_STEPS))


def _held(got, want, tol):
    atol, rtol, rel = tol
    want = want.float()
    err = (got.float() - want).abs()
    rel_err = float(torch.linalg.vector_norm(err)
                    / torch.linalg.vector_norm(want).clamp_min(1e-30))
    ok = bool((err <= atol + rtol * want.abs()).all()) and rel_err <= rel
    return ok, float(err.max()), rel_err


class _K1Check:
    """Around ``attention.flash_attention_bshd`` while installed: holds
    each call's output against the plain K1 on its q, k, v (a plain call
    that no counter sees) and keeps the shapes, the worst errors and the
    last call's inputs."""

    def __init__(self):
        from ..nn.functional import attention

        self.attention, self.real = attention, attention.flash_attention_bshd
        self.calls, self.failed, self.max_abs, self.max_rel = 0, 0, 0.0, 0.0
        self.sq, self.sk = set(), set()
        self.last = None

    def __call__(self, q, k, v, **kw):
        from ..ops import flash_attention as fa

        o = self.real(q, k, v, **kw)
        want, _ = fa.ref_flash_fwd(q, k, v, kw.get("causal", False),
                                   1.0 / q.shape[-1] ** 0.5)
        ok, err, rel = _held(o, want, K1_BF16_TOL)
        self.calls += 1
        self.failed += not ok
        self.max_abs, self.max_rel = max(self.max_abs, err), max(
            self.max_rel, rel)
        self.sq.add(q.shape[1])
        self.sk.add(k.shape[1])
        self.last = (q, k, v)
        return o

    def __enter__(self):
        self.attention.flash_attention_bshd = self
        return self

    def __exit__(self, *exc):
        self.attention.flash_attention_bshd = self.real


def _decode_run(model, device, small, check=None):
    """The prefill and the decode steps; every decode step's output (a
    host copy), the launches over the decode steps and their ms."""
    import paddle_tpu_torch as paddle

    L, B, P, E, H, _, T = _decoder_setup(small)
    rng = np.random.default_rng(1)
    x0 = paddle.to_tensor(rng.standard_normal((B, P, E)).astype("float32"),
                          place=device).astype("bfloat16")
    xs = [paddle.to_tensor(rng.standard_normal((B, 1, E)).astype("float32"),
                           place=device).astype("bfloat16")
          for _ in range(T)]
    causal = paddle.to_tensor(
        np.triu(np.full((P, P), -1e9, "float32"), 1)[None, None],
        place=device)
    empty = paddle.to_tensor(np.zeros((B, 0, H, E // H), "float32"),
                             place=device).astype("bfloat16")
    outs = []
    with paddle.no_grad():
        _, caches = model(x0, attn_mask=causal, caches=[(empty, empty)] * L)
        _sync(device)
        _reset()
        t0 = time.perf_counter()
        for x in xs:
            out, caches = model(x, caches=caches)
            if check is None:
                outs.append(out)
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0) / T
        counts = _counts()
        if check is not None:
            return None, counts, ms
    return [o._value.detach().float().cpu() for o in outs], counts, ms


def decode(device: str, small: bool):
    """(b); returns the record and the last K1 call's q, k, v."""
    from .. import generator
    from ..device import using_device
    from ..incubate.nn import FusedMultiTransformer

    L, B, P, E, H, FF, T = _decoder_setup(small)
    generator.seed(0)
    with using_device(device):
        model = FusedMultiTransformer(E, H, FF, num_layers=L,
                                      activation="gelu")
    model.eval()
    model.astype("bfloat16")
    with _K1Check() as check:
        _, n_checked, _ = _decode_run(model, device, small, check)
    outs_on, n_on, ms_on = _decode_run(model, device, small)
    try:
        _kernels(False)
        outs_off, n_off, ms_off = _decode_run(model, device, small)
    finally:
        _kernels(True)
    rels = [_rel(a, b) for a, b in zip(outs_on, outs_off)]
    rec = {"layers": L, "batch": B, "prefill": P, "decode_steps": T,
           "k1_calls_checked": check.calls, "k1_failed": check.failed,
           "k1_max_abs_err": check.max_abs, "k1_max_rel_err": check.max_rel,
           "k1_sq": sorted(check.sq), "k1_sk": [min(check.sk),
                                                max(check.sk)],
           "kernel_off_rel_max": max(rels), "step_ms": ms_on,
           "step_ms_kernel_off": ms_off, "launches_checked": n_checked,
           "launches": n_on, "launches_kernel_off": n_off}
    problems = []
    if check.failed or check.calls != L * T:
        problems.append(f"K1 against the plain K1: {check.failed} of "
                        f"{check.calls} calls outside {K1_BF16_TOL} (max "
                        f"abs {check.max_abs:.3e}, rel {check.max_rel:.3e})")
    if rec["k1_sq"] != [1] or rec["k1_sk"] != [P + 1, P + T]:
        problems.append(f"K1 shapes Sq {rec['k1_sq']}, Sk {rec['k1_sk']}")
    if not all(bool(torch.isfinite(o).all()) for o in outs_on) \
            or max(rels) > DECODE_REL:
        problems.append(f"kernels off: worst step {max(rels):.3e} > "
                        f"{DECODE_REL}")
    want = {"flash_fwd": L * T, "flash_dq": 0, "flash_dkv": 0}
    _flash_only("decode", n_on, want, device, problems)
    _flash_only("decode (checked)", n_checked, want, device, problems)
    _flash_only("decode kernel off", n_off, dict.fromkeys(KERNELS, 0),
                device, problems)
    if problems:
        raise DrillFailed("decode: " + "; ".join(problems))
    return rec, check.last


# ------------------------------------------------------ (c) the rest
def _both(fn, device):
    """``fn(device)`` and ``fn("cpu")``: their outputs as host tensors."""
    def host(out):
        if isinstance(out, (list, tuple)):
            return [host(o) for o in out]
        t = getattr(out, "_value", out)
        return t.detach().double().cpu() if isinstance(t, torch.Tensor) \
            else torch.tensor(float(t), dtype=torch.float64)
    return host(fn(device)), host(fn("cpu"))


def _built(make, device):
    """``make()`` from ``generator.seed(0)`` on the CPU, moved to
    ``device``: the initializers draw on the parameters' device, so the
    card and the CPU start from the CPU's draw."""
    from .. import generator
    from ..device import using_device

    generator.seed(0)
    with using_device("cpu"):
        layer = make()
    return layer.to(device)


def _flat(x):
    if isinstance(x, list):
        return [a for v in x for a in _flat(v)]
    return [x]


def _case(name, fn, device, tol, exact=()):
    """``fn`` on the card and the CPU; every output within ``tol`` by
    norm, those at the positions ``exact`` equal."""
    got, want = (_flat(o) for o in _both(fn, device))
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if i in exact:
            if not torch.equal(g, w):
                raise DrillFailed(f"{name}: output {i} differs from the "
                                  "CPU's")
        else:
            worst = max(worst, _rel(g, w))
    if worst > tol:
        raise DrillFailed(f"{name}: {worst:.3e} from the CPU's > {tol}")
    return {"rel": worst, "tol": tol, "exact": list(exact)}


def _unpadded(small):
    def fn(device):
        import paddle_tpu_torch as paddle

        rng = np.random.default_rng(2)
        lens = rng.integers(8, 33, 3) if small else rng.integers(64, 513, 8)
        cu = np.concatenate([[0], np.cumsum(lens)]).astype("int32")
        H = 4 if small else 16
        q, k, v = (paddle.to_tensor(rng.standard_normal(
            (int(cu[-1]), H, 64)).astype("float32"), place=device)
            for _ in range(3))
        cut = paddle.to_tensor(cu, place=device)
        return [paddle.nn.functional.flash_attn_unpadded(
            q, k, v, cut, cut, int(lens.max()), int(lens.max()),
            causal=causal)[0] for causal in (False, True)]
    return fn


def _softmax_upper(small):
    def fn(device):
        import paddle_tpu_torch as paddle

        shape = (2, 4, 64, 64) if small else (8, 16, 512, 512)
        x = np.random.default_rng(3).standard_normal(shape).astype("float32")
        return paddle.incubate.softmax_mask_fuse_upper_triangle(
            paddle.to_tensor(x, place=device))
    return fn


def _graph(small):
    """segment_max, send_u_recv sum and max, each with the gradient of a
    seeded cotangent: outputs 0 (segment_max), 1 (its gradient, split
    among ties by counts) and 4 (the send max) are exact; the sends'
    gradients add messages back into rows with atomics on the card."""
    def fn(device):
        import paddle_tpu_torch as paddle

        N, M = (500, 5000) if small else (10_000, 100_000)
        rng = np.random.default_rng(4)
        x = rng.standard_normal((N, 64)).astype("float32")
        src, dst = rng.integers(0, N, M), rng.integers(0, N, M)
        msgs = rng.standard_normal((M, 64)).astype("float32")
        seg = np.sort(rng.integers(0, N, M))
        out = []
        for op in ("segment_max", "send_sum", "send_max"):
            xt = paddle.to_tensor(msgs if op == "segment_max" else x,
                                  place=device, stop_gradient=False)
            if op == "segment_max":
                y = paddle.geometric.segment_max(
                    xt, paddle.to_tensor(seg, place=device))
            else:
                y = paddle.incubate.graph_send_recv(
                    xt, paddle.to_tensor(src, place=device),
                    paddle.to_tensor(dst, place=device),
                    pool_type=op.split("_")[1])
            cot = np.random.default_rng(5).standard_normal(
                y.shape).astype("float32")
            (y * paddle.to_tensor(cot, place=device)).sum().backward()
            out += [y, xt.grad]
        return out
    return fn


def _ec_moe(small):
    def fn(device):
        import paddle_tpu_torch as paddle

        E, F_, X, B, S = (64, 128, 4, 2, 8) if small else (1024, 4096, 8, 2,
                                                           32)
        moe = _built(lambda: paddle.incubate.nn.FusedEcMoe(E, F_, X),
                     device)
        rng = np.random.default_rng(6)
        x, g = (paddle.to_tensor(rng.standard_normal(s).astype("float32"),
                                 place=device) for s in ((B, S, E),
                                                         (B, S, X)))
        return moe(x, g)
    return fn


def _optimizers(small):
    """One LookAhead (k 1), ModelAverage and DistributedFusedLamb step on
    a Linear; the weights after each."""
    def fn(device):
        import paddle_tpu_torch as paddle

        D = 64 if small else 1024
        rng = np.random.default_rng(7)
        x = paddle.to_tensor(rng.standard_normal((16, D)).astype("float32"),
                             place=device)
        out = []
        for kind in ("lookahead", "modelaverage", "lamb"):
            lin = _built(lambda: paddle.nn.Linear(D, D), device)
            params = lin.parameters()
            if kind == "lookahead":
                opt = paddle.incubate.LookAhead(paddle.optimizer.SGD(
                    learning_rate=0.1, parameters=params), alpha=0.5, k=1)
            elif kind == "lamb":
                opt = paddle.incubate.DistributedFusedLamb(
                    learning_rate=0.01, parameters=params)
            else:
                opt = paddle.optimizer.SGD(learning_rate=0.1,
                                           parameters=params)
                ma = paddle.incubate.ModelAverage(
                    0.5, parameters=params, min_average_window=2,
                    max_average_window=4)
            for _ in range(2):
                (lin(x) ** 2).mean().backward()
                opt.step()
                opt.clear_grad()
                if kind == "modelaverage":
                    ma.step()
            if kind == "modelaverage":
                with ma.apply():
                    out.append(lin.weight._value.detach().clone())
            out.append(lin.weight._value.detach().clone())
        return out
    return fn


def _quadratic(paddle, device, n):
    rng = np.random.default_rng(8)
    m = rng.standard_normal((n, n)).astype("float32")
    a = paddle.to_tensor(m @ m.T / n + np.eye(n, dtype="float32"),
                         place=device)
    b = paddle.to_tensor(rng.standard_normal(n).astype("float32"),
                         place=device)
    return a, b


def _solvers(small):
    """``LBFGS`` (strong Wolfe) three steps and ``minimize_bfgs`` (at a
    tolerance its gradient reaches) on 0.5 x'Ax - b'x: the weights, then
    the BFGS tuple's convergence flag, count, position and value."""
    def fn(device):
        import paddle_tpu_torch as paddle
        from ..incubate.optimizer.functional import minimize_bfgs

        n = 8
        a, b = _quadratic(paddle, device, n)
        w = paddle.Parameter(paddle.to_tensor(np.zeros((n,), "float32"),
                                              place=device))
        opt = paddle.incubate.LBFGS(learning_rate=1.0, max_iter=10,
                                    line_search_fn="strong_wolfe",
                                    parameters=[w])

        def closure():
            loss = 0.5 * (w * paddle.matmul(a, w)).sum() - (b * w).sum()
            loss.backward()
            return loss

        for _ in range(3):
            opt.step(closure)
        res = minimize_bfgs(
            lambda x: 0.5 * (x * paddle.matmul(a, x)).sum() - (b * x).sum(),
            paddle.to_tensor(np.zeros(n, "float32"), place=device),
            tolerance_grad=1e-3)
        # the final gradient (about tolerance_grad in size) is left out:
        # its relative rounding noise is not the solver's
        return [w._value.detach().clone()] + list(res[:4])
    return fn


def _asp(small):
    """A pruned MLP, one decorated AdamW step; the weights, and 1.0 for
    every pruned weight that keeps 2:4 (the count of them last)."""
    def fn(device):
        import paddle_tpu_torch as paddle

        asp = paddle.incubate.asp
        D = 64 if small else 1024
        net = _built(lambda: paddle.nn.Sequential(
            paddle.nn.Linear(D, D), paddle.nn.ReLU(),
            paddle.nn.Linear(D, 256)), device)
        asp.ASPHelper._masks.clear()
        masks = asp.prune_model(net, n=2, m=4)
        opt = asp.decorate(paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=net.parameters()))
        x = paddle.to_tensor(np.random.default_rng(9).standard_normal(
            (32, D)).astype("float32"), place=device)
        (net(x) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
        kept = [float(asp.check_mask_1d(
            np.asarray(p.numpy()).T, 2, 4)) for name, p in
            net.named_parameters() if name in masks]
        asp.ASPHelper._masks.clear()
        if len(kept) != 2 or not all(kept):
            raise DrillFailed(f"asp on {device}: 2:4 kept {kept}")
        return ([p._value.detach().clone() for p in net.parameters()]
                + [torch.tensor(kept), torch.tensor(float(len(kept)))])
    return fn


def rest(device: str, small: bool) -> dict:
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _rest(device, small)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _rest(device: str, small: bool) -> dict:
    out = {}
    for name, fn, tol, exact in (
            ("flash_attn_unpadded", _unpadded(small), CPU_TOL, ()),
            ("softmax_mask_fuse_upper_triangle", _softmax_upper(small),
             1e-6, ()),
            ("segment_max_send_recv", _graph(small), 1e-5, (0, 1, 4)),
            ("fused_ec_moe", _ec_moe(small), CPU_TOL, ()),
            ("lookahead_modelaverage_lamb", _optimizers(small), 1e-5, ()),
            # both solvers stop at a gradient of about 1e-3: the
            # positions are fixed to that, not to f32 rounding
            ("lbfgs_bfgs", _solvers(small), 1e-3, (1, 2)),
            ("asp", _asp(small), 1e-5, ())):
        t0 = time.perf_counter()
        out[name] = _case(name, fn, device, tol, exact)
        out[name]["seconds"] = time.perf_counter() - t0
    return out


# -------------------------------------------------------- entry points
def run(device: str = "cuda", small: bool = False, log=print) -> dict:
    """(a)-(c), each checked; the summary with every path's launches and
    (under ``k1_decode_inputs``, not logged) the last decode step's K1
    inputs."""
    from ..device import resolve_device

    resolve_device(device)
    out, seconds = {}, {}
    for part, fn in (("encoder", lambda: encoder(device, small)),
                     ("decode", lambda: decode(device, small)),
                     ("rest", lambda: rest(device, small))):
        t0 = time.perf_counter()
        rec = fn()
        if part == "decode":
            rec, out["k1_decode_inputs"] = rec
        out[part] = rec
        seconds[part] = time.perf_counter() - t0
        log(f"incubate drills ({part}): " + json.dumps(rec, default=str))
        if _cuda(device):
            torch.cuda.empty_cache()
    out["seconds"] = seconds
    e, d = out["encoder"], out["decode"]
    out["launches"] = {
        "train_fused_encoder_bert": e["launches_graphed"],
        "train_fused_encoder_bert_eager": e["launches_eager"],
        "train_fused_encoder_bert_kernel_off": e["launches_kernel_off"],
        "decode_fused_gpt355m": d["launches"],
        "decode_fused_gpt355m_kernel_off": d["launches_kernel_off"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cpu":
        from ..device import set_device

        set_device("cpu")
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        out = run(args.device, args.small)
    except DrillFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    out.pop("k1_decode_inputs", None)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
