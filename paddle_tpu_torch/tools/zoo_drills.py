"""The model zoo on one card: GPT-355M's bench step, the classification
zoo, and PP-YOLOE-s and CRNN on their bucketed shape streams.

    python -m paddle_tpu_torch.tools.zoo_drills            # on cuda
    python -m paddle_tpu_torch.tools.zoo_drills --small --device cpu

Four parts, each checked (a failure raises ``DrillFailed``):

(a) ``bench --model gpt``'s step: GPT-355M (vocab 50304, hidden 1024, 24
    layers, 16 heads), B 8, S 1024, O2 bf16 with master weights, AdamW,
    the plain cross entropy. Three eager calls of ``train_fn``, then,
    rebuilt from the same seed, three calls of its ``StaticFunction``
    (the eager first call, the capture, a replay): every loss and every
    parameter bit for bit. Then ``GPT_TIMED`` more replays, timed, for
    tokens/s and step ms. K1-K3 and the embedding backward are counted
    over the graphed run. Peak bytes are over what was allocated before
    the graphed run (the stream's likewise).
(b) The zoo at full width: every constructor of
    ``tests/test_vision.py::TestModelZoo`` outside ResNet, plus
    ``alexnet``, ``vgg16``, ``googlenet``, ``inception_v3``,
    ``mobilenet_v3_large`` and ``shufflenet_v2_x1_0``; B 8, 224 x 224
    (InceptionV3 299 x 299), 1000 classes, eval, f32 with TF32 off. Each
    forward on the card against the same model on the CPU (weights by
    ``set_state_dict``) by the norm of the difference over the CPU's
    norm, within ``ZOO_TOL``; the control, the first model with one
    weight doubled (its first conv's largest), must fall outside it.
    Then one O2 bf16 AdamW step graphed (the ``StaticFunction``'s capture
    after its eager first call) against the same step eagerly, from the
    same state, for ``mobilenet_v3_large``, ``densenet121`` and
    ``inception_v3``: the loss, every parameter and every BatchNorm
    statistic bit for bit.
(c) PP-YOLOE-s on ``bench --model yoloe``'s stream (sides [320, 416,
    512], B 8, up to 16 boxes, 8 batches) through ``BucketedFunction``:
    the bench's two warm-up passes (16 steps: each bucket's eager first
    call, then its capture) against the same 16 steps of ``train_fn``
    eagerly on the padded batches, from a model rebuilt from the same
    seed: every step's loss and the final state bit for bit, so each
    bucket's first graphed step equals its eager step from the same
    state. ``recompiles`` at most the distinct bucket keys of the stream.
    Then the bench's 3 timed passes: images/s, capture seconds, peak
    bytes. Then ``predict``'s path on one 512 x 512 image (an f32 model
    from the same seed, eval): the kept indices of ``nms`` on the card
    equal ``nms`` on the CPU over the same boxes and scores; ``nms`` on
    the card timed at that size.
(d) CRNN on ``bench --model ocr``'s stream (widths [96, 160, 256, 320],
    B 32, labels up to 24 tokens, 97 classes), checked and timed as (c).

Every graphed step is held to its eager twin under cuDNN's defaults
(``benchmark`` off, so a capture and an eager call pick the same
algorithms). K1-K5 and the embedding backward are counted on every path
(launched and replayed; the vision paths launch none).

``--small`` runs each part at a size the CPU can take: the small GPT, the
zoo at 64 x 64 (InceptionV3 75) with B 2 on three models, and the small
streams (on the CPU a ``StaticFunction`` runs every call eagerly).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

__all__ = ["run", "gpt355m", "zoo", "stream", "DrillFailed", "ZOO_TOL",
           "ZOO_FORWARD", "ZOO_TRAIN"]

ZOO_TOL = 1e-4        # f32, TF32 off: the card's logits against the CPU's,
#                       by the norm of the difference over the CPU's norm
GPT_TIMED = 10
ZOO_FORWARD = ["mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
               "vgg11", "squeezenet1_1", "shufflenet_v2_x0_25",
               "densenet121", "alexnet", "vgg16", "googlenet",
               "inception_v3", "mobilenet_v3_large", "shufflenet_v2_x1_0"]
ZOO_TRAIN = ["mobilenet_v3_large", "densenet121", "inception_v3"]


class DrillFailed(RuntimeError):
    pass


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _counts() -> Dict[str, int]:
    """Launches so far of K1-K5 and of the embedding backward on the card
    (eager and graph-replayed), and their plain versions' calls."""
    from ..ops import embedding_grad as eg
    from ..ops import flash_attention as fa
    from ..ops import fused_adamw as fw
    from ..ops import paged_attention as pa

    out = {n: fa.kernel_launches[n] + fa.replayed_launches[n]
           for n in fa.kernel_launches}
    out.update(paged_attention=pa.kernel_launches + pa.replayed_launches,
               fused_adamw=fw.kernel_launches, embedding_grad=eg.launches(),
               plain=sum(fa.plain_calls.values()) + pa.plain_calls
               + fw.plain_calls + eg.plain_calls)
    return out


def _reset() -> None:
    from ..ops import embedding_grad as eg
    from ..ops import flash_attention as fa
    from ..ops import fused_adamw as fw
    from ..ops import paged_attention as pa

    for mod in (fa, pa, fw, eg):
        mod.reset_counters()


def _state(model) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer, cloned."""
    return {k: getattr(v, "_value", v).detach().clone()
            for k, v in model.state_dict().items()}


def _differ(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    return [k for k in a if not torch.equal(a[k], b[k])]


def _host(t) -> np.ndarray:
    return np.asarray(getattr(t, "_value", t).detach().double().cpu())


def _f(t) -> float:
    return float(_host(t))


# ------------------------------------------------------------- (a) GPT
def gpt355m(device: str, small: bool) -> dict:
    """(a): three eager steps against three ``StaticFunction`` calls from
    the same seed, then ``GPT_TIMED`` timed replays."""
    import paddle_tpu_torch as paddle

    from .. import bench, jit

    cfg, B, S, _ = bench.SETUPS["gpt"](small)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    args = (paddle.to_tensor(ids, place=device),
            paddle.to_tensor(np.roll(ids, -1, 1), place=device))
    runs = {}
    base = None
    for kind in ("eager", "graphed"):
        if kind == "graphed" and device == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        model, opt = bench.build(cfg, device, bench.MASTER_WEIGHT["gpt"])
        fn = bench.make_train_fn(model, opt)
        step = fn if kind == "eager" else jit.StaticFunction(
            fn, observe=[model, opt], warmup=False)
        _reset()
        losses = [_f(step(*args)) for _ in range(3)]
        runs[kind] = (losses,
                      [getattr(p, "_value", p).detach().clone()
                       for p in model.parameters()])
        if kind == "eager":
            del model, opt, fn, step
            if device == "cuda":
                torch.cuda.empty_cache()
    (le, pe), (lg, pg) = runs["eager"], runs["graphed"]
    differ = [i for i, (a, b) in enumerate(zip(pe, pg))
              if not torch.equal(a, b)]
    del runs, pe, pg
    steps = 1 if small else GPT_TIMED
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(*args)
    _sync(device)
    dt = (time.perf_counter() - t0) / steps
    params = list(model.parameters())
    rec = {"config": bench.config_name("gpt", cfg, B, S),
           "params_m": round(sum(p.numel() for p in params) / 1e6, 1),
           "losses_eager": le, "losses_graphed": lg,
           "losses_equal": le == lg, "params_compared": len(params),
           "params_differ": differ[:8], "last_loss": _f(loss),
           "step_ms": 1000 * dt, "tokens_per_s": B * S / dt,
           "capture_s": sum(step.capture_seconds().values()),
           "compile_counts": step.compile_counts(),
           "peak_bytes": (torch.cuda.max_memory_allocated() - base
                          if device == "cuda" else None),
           "launches": _counts()}
    del model, opt, step, params
    problems = []
    if not rec["losses_equal"] or differ:
        problems.append(f"graphed and eager differ: losses {lg} vs {le}, "
                        f"{len(differ)} parameters")
    if not all(np.isfinite(lg)) or not np.isfinite(rec["last_loss"]):
        problems.append(f"a loss is not finite: {lg}, {rec['last_loss']}")
    if rec["compile_counts"] != {"signatures": 1, "captured": 1,
                                 "calls": 3 + steps}:
        problems.append(f"not one capture: {rec['compile_counts']}")
    if device == "cuda":
        n = rec["launches"]
        want = cfg.num_layers * (3 + steps)  # eager, then each replay
        if any(n[k] != want for k in ("flash_fwd", "flash_dq", "flash_dkv")) \
                or n["plain"] or n["embedding_grad"] == 0:
            problems.append(f"launches {n}: K1-K3 {want} each expected, "
                            "the embedding kernel > 0, plain versions 0")
    if problems:
        raise DrillFailed("gpt355m: " + "; ".join(problems))
    return rec


# --------------------------------------------------------------- (b) zoo
def _make(name: str, device: str):
    from .. import generator, vision
    from ..device import using_device

    generator.seed(0)
    with using_device(device):
        return getattr(vision.models, name)(num_classes=1000)


def _side(name: str, small: bool) -> int:
    if name == "inception_v3":
        return 75 if small else 299
    return 64 if small else 224


def _first_conv_weight(model):
    for name, p in model.named_parameters():
        if p._value.ndim == 4:
            return name, p
    raise DrillFailed("no conv weight")


def zoo_forward(device: str, small: bool) -> dict:
    """(b)'s forwards against the CPU, and the perturbed-weight
    control."""
    import paddle_tpu_torch as paddle

    names = ZOO_FORWARD[:3] if small else ZOO_FORWARD
    B = 2 if small else 8
    out = {}
    control = None
    for name in names:
        side = _side(name, small)
        x = np.random.default_rng(1).standard_normal(
            (B, 3, side, side)).astype("float32")
        dev_model = _make(name, device)
        cpu_model = _make(name, "cpu")
        missing, unexpected = cpu_model.set_state_dict(
            {k: v._value.detach().cpu() for k, v in
             dev_model.state_dict().items()})
        if missing or unexpected:
            raise DrillFailed(f"zoo {name}: state {missing} {unexpected}")
        dev_model.eval()
        cpu_model.eval()
        with paddle.no_grad():
            got = dev_model(paddle.to_tensor(x, place=device))
            _sync(device)
            t0 = time.perf_counter()
            got = dev_model(paddle.to_tensor(x, place=device))
            _sync(device)
            ms = 1000 * (time.perf_counter() - t0)
            want = cpu_model(paddle.to_tensor(x, place="cpu"))
        g, w = _host(got), _host(want)
        rel = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        out[name] = {"rel": rel, "shape": list(g.shape), "side": side,
                     "finite": bool(np.isfinite(g).all()), "ms": ms}
        if control is None:
            pname, p = _first_conv_weight(dev_model)
            flat = p._value.view(-1)
            i = int(flat.abs().argmax())
            with torch.no_grad():
                flat[i] *= 2.0
            with paddle.no_grad():
                bad = _host(dev_model(paddle.to_tensor(x, place=device)))
            control = {"model": name, "weight": f"{pname}[{i}] x 2",
                       "rel": float(np.linalg.norm(bad - w)
                                    / max(np.linalg.norm(w), 1e-30))}
        del dev_model, cpu_model
    problems = [f"{n}: rel {r['rel']:.3e} (finite {r['finite']})"
                for n, r in out.items()
                if not (r["finite"] and r["rel"] <= ZOO_TOL)]
    if control["rel"] <= ZOO_TOL:
        problems.append(f"the control passed: {control}")
    if problems:
        raise DrillFailed("zoo forward: " + "; ".join(problems))
    return {"models": out, "control": control, "tol": ZOO_TOL, "batch": B}


def _zoo_train_pair(name: str, device: str, small: bool) -> dict:
    """One O2 bf16 AdamW step of ``name``: the ``StaticFunction``'s
    capture (after its eager first call) against the eager step from the
    same state."""
    import paddle_tpu_torch as paddle

    from .. import bench, jit

    B = 2 if small else 8
    side = _side(name, small)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 3, side, side)).astype("float32")
    y = rng.integers(0, 1000, (B,))
    args = (paddle.to_tensor(x, place=device),
            paddle.to_tensor(y, place=device))
    runs = {}
    for kind in ("eager", "graphed"):
        model, opt = bench.build_vision(lambda: _make(name, device), device)
        fn = bench.make_resnet_train_fn(model, opt)
        step = fn if kind == "eager" else jit.StaticFunction(
            fn, observe=[model, opt], warmup=False)
        losses = [_f(step(*args)) for _ in range(2)]
        _sync(device)
        runs[kind] = (losses, _state(model))
        del model, opt, fn, step
    (le, se), (lg, sg) = runs["eager"], runs["graphed"]
    differ = _differ(se, sg)
    return {"losses_eager": le, "losses_graphed": lg,
            "losses_equal": le == lg, "state_tensors": len(se),
            "differ": differ[:8], "equal": le == lg and not differ}


def zoo(device: str, small: bool) -> dict:
    """(b): the forwards, then the three graphed train steps."""
    t0 = time.perf_counter()
    _reset()
    fwd = zoo_forward(device, small)
    fwd_launches = _counts()
    t1 = time.perf_counter()
    _reset()
    train = {}
    for name in (ZOO_TRAIN[:1] if small else ZOO_TRAIN):
        train[name] = _zoo_train_pair(name, device, small)
        if device == "cuda":
            torch.cuda.empty_cache()
    train_launches = _counts()
    bad = {n: r for n, r in train.items() if not r["equal"]}
    if bad:
        raise DrillFailed(f"zoo train: graphed and eager differ: {bad}")
    return {"forward": fwd, "train": train,
            "launches": {"zoo_forward": fwd_launches,
                         "zoo_train": train_launches},
            "seconds": {"forward": t1 - t0,
                        "train": time.perf_counter() - t1}}


# ------------------------------------------------------ (c), (d) streams
def _stream_pair(model: str, device: str, small: bool) -> dict:
    """The bench's stream: 16 warm-up steps through ``BucketedFunction``
    against the same padded batches eagerly, from the same seed; then the
    bench's timed passes."""
    from .. import bench

    setup, make_stream, build_, make_fn, make_step = bench.STREAMS[model]
    ladder, B, longest, reps = setup(small)
    batches = make_stream(ladder, B, longest, device)
    # eager: train_fn itself on the padded batches
    net, opt = build_(device)
    fn = make_fn(net, opt)
    pad = make_step(fn, net, opt, ladder, longest)._padded
    eager = []
    for _ in range(2):
        for b in batches:
            eager.append(_f(fn(*pad(*b))))
    _sync(device)
    state_e = _state(net)
    del net, opt, fn
    base = 0
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    # graphed: the bench's stream
    net, opt = build_(device)
    step = make_step(make_fn(net, opt), net, opt, ladder, longest)
    snap = {}
    best, warm_s, losses = bench.time_stream(
        step, batches, 1 if small else reps, torch.device(device),
        after_warmup=lambda: snap.update(_state(net)))
    differ = _differ(state_e, snap)
    keys = [tuple(tuple(t.shape) for t in step._padded(*b)) for b in batches]
    graphs = step._fn.compile_counts()
    rec = {"config": f"{model}-b{B}-{ladder}",
           "losses_eager": eager, "losses_graphed": losses[:16],
           "losses_equal": eager == losses[:16],
           "state_tensors": len(state_e), "differ": differ[:8],
           "equal": eager == losses[:16] and not differ,
           "distinct_input_shapes": len({tuple(b[0].shape)
                                         + tuple(b[1].shape)
                                         for b in batches}),
           "bucket_keys": len(set(keys)), "recompiles": step.compile_count,
           "compile_counts": graphs, "max_programs": step.max_programs(),
           "stream_batches": len(batches),
           "stream_ms": 1000 * best,
           "images_per_s": len(batches) * B / best, "warmup_s": warm_s,
           "capture_s": sorted(step._fn.capture_seconds().values()),
           "peak_bytes": (torch.cuda.max_memory_allocated() - base
                          if device == "cuda" else None),
           "losses_timed": losses[16:]}
    return rec


def _predict_nms(device: str, small: bool) -> dict:
    """``predict``'s path on one image: the kept indices of ``nms`` on the
    card against ``nms`` on the CPU over the same boxes and scores."""
    import paddle_tpu_torch as paddle

    from .. import generator
    from ..device import using_device
    from ..nn import functional as F
    from ..ops.manipulation import concat
    from ..vision.models import ppyoloe_s
    from ..vision.ops import nms

    side = 96 if small else 512
    generator.seed(0)
    with using_device(device):
        model = ppyoloe_s(num_classes=80)
    model.eval()
    x = np.random.default_rng(3).standard_normal(
        (1, 3, side, side)).astype("float32")
    img = paddle.to_tensor(x, place=device)
    with paddle.no_grad():
        boxes, scores, labels = model.predict(img)
        preds = model(img)
        bx = concat([model.head.decode(r, c, s) for _, r, c, s in preds],
                    axis=1)[0]
        sc = concat([F.sigmoid(c) for c, _, _, _ in preds], axis=1)[0]
    best = sc.max(axis=-1)
    keep = _host(best) > 0.3
    sel = torch.from_numpy(np.nonzero(keep)[0]).to(bx._value.device)
    b = paddle.Tensor._wrap(bx._value[sel])
    s = paddle.Tensor._wrap(best._value[sel])
    kept = nms(b, iou_threshold=0.5, scores=s)
    _sync(device)
    t0 = time.perf_counter()
    kept = nms(b, iou_threshold=0.5, scores=s)
    _sync(device)
    ms = 1000 * (time.perf_counter() - t0)
    cpu = nms(paddle.Tensor._wrap(b._value.cpu()), iou_threshold=0.5,
              scores=paddle.Tensor._wrap(s._value.cpu()))
    k_dev, k_cpu = _host(kept).astype(np.int64), _host(cpu).astype(np.int64)
    rec = {"side": side, "candidates": int(keep.sum()),
           "kept": int(len(k_dev)), "equal": bool(np.array_equal(k_dev,
                                                                 k_cpu)),
           "nms_ms": ms, "predict_boxes": int(len(boxes)),
           "predict_matches": bool(np.allclose(
               boxes, _host(b)[k_dev[:100]], rtol=1e-5, atol=1e-3))}
    if not (rec["equal"] and rec["predict_matches"] and rec["kept"] > 0):
        raise DrillFailed(f"predict nms: {rec}")
    return rec


def stream(model: str, device: str, small: bool) -> dict:
    """(c) or (d): the checked and timed stream; (c) adds ``predict``."""
    t0 = time.perf_counter()
    _reset()
    rec = _stream_pair(model, device, small)
    rec["launches"] = _counts()
    problems = []
    if not rec["equal"]:
        problems.append(f"graphed and eager differ: losses equal "
                        f"{rec['losses_equal']}, state {rec['differ']}")
    if rec["recompiles"] > rec["bucket_keys"]:
        problems.append(f"{rec['recompiles']} programs for "
                        f"{rec['bucket_keys']} bucket keys")
    if not all(np.isfinite(rec["losses_eager"] + rec["losses_timed"])):
        problems.append("a loss is not finite")
    if problems:
        raise DrillFailed(f"{model} stream: " + "; ".join(problems))
    if model == "yoloe":
        rec["predict"] = _predict_nms(device, small)
    rec["seconds"] = time.perf_counter() - t0
    return rec


# -------------------------------------------------------- entry points
def run(device: str = "cuda", small: bool = False, log=print) -> dict:
    """(a)-(d), each checked; the summary with every path's launches."""
    from ..device import resolve_device

    resolve_device(device)
    out, seconds = {}, {}
    for part, fn in (("gpt355m", lambda: gpt355m(device, small)),
                     ("zoo", lambda: zoo(device, small)),
                     ("yoloe", lambda: stream("yoloe", device, small)),
                     ("ocr", lambda: stream("ocr", device, small))):
        t0 = time.perf_counter()
        out[part] = fn()
        seconds[part] = time.perf_counter() - t0
        log(f"zoo drills ({part}): " + json.dumps(out[part], default=str))
        if device == "cuda":
            torch.cuda.empty_cache()
    out["seconds"] = seconds
    out["launches"] = {"train_gpt355m": out["gpt355m"]["launches"],
                       **out["zoo"]["launches"],
                       "train_yoloe_stream": out["yoloe"]["launches"],
                       "train_ocr_stream": out["ocr"]["launches"]}
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
        torch.backends.cudnn.benchmark = False
    try:
        out = run(args.device, args.small)
    except DrillFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
