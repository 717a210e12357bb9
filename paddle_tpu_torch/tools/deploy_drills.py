"""Deployment and observability on one card: GPT-355M exported, served,
profiled; the device API; QAT.

    python -m paddle_tpu_torch.tools.deploy_drills            # on cuda
    python -m paddle_tpu_torch.tools.deploy_drills --small --device cpu

Six parts, each checked (a failure raises ``DrillFailed``):

(a) ``bench --model gpt``'s GPT-355M (vocab 50304, hidden 1024, 24
    layers, 16 heads of 64), O2 bf16 from ``bench.build``'s seed,
    exported by ``jit.save`` under ``amp.auto_cast(level="O2")`` with a
    dynamic batch and S 1024 (one ``paddle_tpu_torch::flash_fwd`` node a
    layer), loaded through ``inference.Config``/``create_predictor`` on
    the card and run at B 8 and B 2: the logits equal the eager model's
    bit for bit (the same operators and kernels in the same order); K1
    launches 24 a call through the loaded program, its plain version
    never, K2-K5 and the embedding backward never. Export, load and
    per-call seconds are recorded.
(b) The same artifact through the ``PD_*`` C API
    (``PD_PredictorCreate(prefix, "gpu")``, ids in, f32-widened logits
    out) at B 2: equal to (a)'s, 24 K1 launches.
(c) ``convert_to_mixed_precision`` to bf16 storage, reloaded: the same
    logits at B 2 (the f32 LayerNorm weights and biases are 1 and 0 at
    this seed, exact in bf16).
(d) ``profiler.Profiler`` (GPU target, ``make_scheduler(closed=1,
    ready=1, record=2)``, ``export_chrome_tracing``) around four calls of
    GPT-355M's bench step (``StaticFunction``: the eager first call, the
    capture, replays), each in a ``RecordEvent``: the chrome trace holds
    the two recorded steps' spans and device events named for K1, K2 and
    K3 as many as the launch counters add over those steps;
    ``summary()``'s device table (the step's time by operation).
(e) The device API on the card: ``device.memory_allocated``/
    ``max_memory_allocated`` equal ``torch.cuda``'s; an ``Event`` pair
    times K1 at the GPT-355M shape; K1 under
    ``stream_guard(Stream())`` gives what it gives on the default stream,
    and the trace puts the two launches on two streams; the host time of
    K1's operator dispatch per eager call against the launcher called
    directly (at a tiny shape, where the host bounds the call).
(f) QAT at a twin's size: a conv + linear facade net, fake quanters on
    its weights (and on the first layer's input), one SGD step on the
    card against the same step on the CPU: loss, every parameter and its
    gradient within 1e-5 of each array's largest value (f32, TF32 off).

``--small`` runs each part at a size the CPU takes (the small GPT; (b)
on ``"cpu"``); the launch checks and (d)'s device events need the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from .zoo_drills import _counts, _reset

__all__ = ["run", "DrillFailed", "QAT_TOL"]

QAT_TOL = 1e-5   # f32, TF32 off: of each array's largest magnitude
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


class DrillFailed(RuntimeError):
    pass


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _expect(path, n, want_k1, device, problems) -> None:
    """K1 ``want_k1`` launches, nothing else on the card, no plain call."""
    if not str(device).startswith("cuda"):
        return
    other = {k: v for k, v in n.items() if k not in ("flash_fwd", "plain")}
    if n["flash_fwd"] != want_k1 or n["plain"] or any(other.values()):
        problems.append(f"{path}: launches {n}, K1 {want_k1} and nothing "
                        "else expected")


# ------------------------------------------------------- (a)-(c) serving
def _gpt(device, small):
    from .. import bench

    cfg, B, S, _ = bench.SETUPS["gpt"](small)
    model, _ = bench.build(cfg, device, bench.MASTER_WEIGHT["gpt"])
    model.eval()
    return cfg, B, S, model


def _logits(model, ids):
    from .. import amp

    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        return model(ids)


def _timed(device, fn, n=3):
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    _sync(device)
    return out, 1e3 * (time.perf_counter() - t0) / n


def serve(device: str, small: bool, workdir: str) -> dict:
    """(a), (b), (c)."""
    from .. import amp, inference, jit

    cfg, B, S, model = _gpt(device, small)
    rng = np.random.default_rng(0)
    ids = {b: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, S))).to(
        device) for b in (B, 2)}
    eager, eager_ms = {}, {}
    for b, x in ids.items():
        eager[b], eager_ms[b] = _timed(device, lambda x=x: _logits(model, x))
    prefix = os.path.join(workdir, "gpt355m")
    t0 = time.perf_counter()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        jit.save(model, prefix, input_spec=[
            jit.InputSpec([None, S], "int64", name="input_ids")])
    export_s = time.perf_counter() - t0
    nodes = _flash_nodes(prefix)
    del model
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    cfg_inf = inference.Config()
    cfg_inf.set_model(prefix)
    if not str(device).startswith("cuda"):
        cfg_inf.disable_gpu()
    t0 = time.perf_counter()
    pred = inference.create_predictor(cfg_inf)
    load_s = time.perf_counter() - t0
    problems, rec = [], {"export_s": export_s, "load_s": load_s,
                         "flash_nodes": nodes, "eager_ms": eager_ms,
                         "pdmodel_bytes": os.path.getsize(prefix + ".pdmodel"),
                         "pdiparams_bytes": os.path.getsize(
                             prefix + ".pdiparams")}
    if nodes != cfg.num_layers:
        problems.append(f"{nodes} K1 nodes in the graph, "
                        f"{cfg.num_layers} expected")
    launches, equal, pred_ms = {}, {}, {}
    for b, x in ids.items():
        _reset()
        got = pred.run_tensors([x])[0]
        _sync(device)
        launches[b] = _counts()
        equal[b] = bool(torch.equal(got, eager[b]))
        _expect(f"predictor B {b}", launches[b], cfg.num_layers, device,
                problems)
        _, pred_ms[b] = _timed(device, lambda x=x: pred.run_tensors([x])[0])
        if not equal[b]:
            problems.append(f"predictor B {b}: logits differ from eager, "
                            "max abs diff "
                            f"{(got.float() - eager[b].float()).abs().max()}")
    rec.update(predictor_equal=equal, predictor_ms=pred_ms,
               launches_predictor=launches[B], logits_dtype=str(got.dtype))
    del pred, got
    # (b) the C API at B 2
    lib = _capi()
    ref2 = eager[2].float().cpu().numpy()
    del eager
    _reset()
    capi = _capi_run(lib, prefix, ids[2].cpu().numpy(),
                     b"gpu" if str(device).startswith("cuda") else b"cpu")
    rec["launches_capi"] = _counts()
    _expect("C API", rec["launches_capi"], cfg.num_layers, device, problems)
    rec["capi_equal"] = bool(np.array_equal(capi, ref2))
    if not rec["capi_equal"]:
        problems.append("C API logits differ from eager")
    del capi
    # (c) bf16 storage
    mixed = os.path.join(workdir, "gpt355m_bf16")
    t0 = time.perf_counter()
    inference.convert_to_mixed_precision(
        prefix + ".pdmodel", prefix + ".pdiparams", mixed + ".pdmodel",
        mixed + ".pdiparams", inference.PrecisionType.Bfloat16)
    rec["convert_s"] = time.perf_counter() - t0
    rec["bf16_pdiparams_bytes"] = os.path.getsize(mixed + ".pdiparams")
    cfg16 = inference.Config(mixed + ".pdmodel", mixed + ".pdiparams")
    if not str(device).startswith("cuda"):
        cfg16.disable_gpu()
    pred16 = inference.create_predictor(cfg16)
    _reset()
    got16 = pred16.run_tensors([ids[2]])[0]
    _sync(device)
    rec["launches_bf16_store"] = _counts()
    _expect("bf16 storage", rec["launches_bf16_store"], cfg.num_layers,
            device, problems)
    rec["bf16_store_equal"] = bool(np.array_equal(
        got16.float().cpu().numpy(), ref2))
    if not rec["bf16_store_equal"]:
        problems.append("bf16 storage: logits differ from eager")
    if problems:
        raise DrillFailed("serve: " + "; ".join(problems))
    return rec


def _flash_nodes(prefix) -> int:
    import io
    import pickle

    with open(prefix + ".pdmodel", "rb") as f:
        prog = pickle.load(f)
    ep = torch.export.load(io.BytesIO(prog["exported"]))
    return sum(n.op == "call_function"
               and "paddle_tpu_torch.flash_fwd" in str(n.target)
               for n in ep.graph.nodes)


def _capi():
    from ..ops._build import load_host

    lib = load_host("pd_inference_c")
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.PD_Init.argtypes = [ctypes.c_char_p]
    lib.PD_GetLastError.restype = ctypes.c_char_p
    lib.PD_PredictorCreate.restype = i64
    lib.PD_PredictorCreate.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.PD_PredictorDestroy.argtypes = [i64]
    lib.PD_PredictorSetInput.argtypes = [
        i64, ctypes.c_char_p, p, ctypes.POINTER(i64), ctypes.c_int,
        ctypes.c_char_p]
    lib.PD_PredictorRun.argtypes = [i64]
    lib.PD_PredictorGetOutputDims.argtypes = [
        i64, ctypes.c_int, ctypes.POINTER(i64), ctypes.c_int]
    lib.PD_PredictorGetOutputDtype.argtypes = [
        i64, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.PD_PredictorCopyOutput.restype = i64
    lib.PD_PredictorCopyOutput.argtypes = [i64, ctypes.c_int, p, i64]
    if lib.PD_Init(b"") != 0:
        raise DrillFailed(f"PD_Init: {lib.PD_GetLastError().decode()}")
    return lib


def _capi_run(lib, prefix, ids, device: bytes) -> np.ndarray:
    def err(what):
        return DrillFailed(f"{what}: {lib.PD_GetLastError().decode()}")

    h = lib.PD_PredictorCreate(prefix.encode(), device)
    if h <= 0:
        raise err("PD_PredictorCreate")
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    dims = (ctypes.c_int64 * ids.ndim)(*ids.shape)
    if lib.PD_PredictorSetInput(h, b"input_ids", ids.ctypes.data, dims,
                                ids.ndim, b"int64") != 0:
        raise err("PD_PredictorSetInput")
    if lib.PD_PredictorRun(h) != 1:
        raise err("PD_PredictorRun")
    odims = (ctypes.c_int64 * 8)()
    nd = lib.PD_PredictorGetOutputDims(h, 0, odims, 8)
    dt = ctypes.create_string_buffer(16)
    lib.PD_PredictorGetOutputDtype(h, 0, dt, 16)
    if dt.value != b"float32":
        raise DrillFailed(f"C API output dtype {dt.value}")
    out = np.empty(tuple(odims[:nd]), np.float32)
    if lib.PD_PredictorCopyOutput(h, 0, out.ctypes.data,
                                  out.nbytes) != out.nbytes:
        raise err("PD_PredictorCopyOutput")
    lib.PD_PredictorDestroy(h)
    return out


# ------------------------------------------------------------ (d) profile
# device operations by part, by name (first match wins)
GROUPS = (("flash K1-K3", ("flash_fwd", "flash_dq", "flash_dkv")),
          ("embedding backward", ("embedding_grad",)),
          ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
          ("softmax and cross entropy", ("softmax", "nll_loss", "cross_ent")),
          ("layernorm", ("layer_norm", "layernorm", "gammabeta")),
          ("copies", ("memcpy", "memset", "copy_kernel", "direct_copy")),
          ("reductions", ("reduce_kernel",)))


def _group(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in GROUPS if any(k in low for k in keys)),
                "other elementwise")


def profile(device: str, small: bool, workdir: str) -> dict:
    """(d): the profiled bench step."""
    import paddle_tpu_torch as paddle

    from .. import bench, jit, profiler

    cfg, B, S, _ = bench.SETUPS["gpt"](small)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    args = (paddle.to_tensor(ids, place=device),
            paddle.to_tensor(np.roll(ids, -1, 1), place=device))
    model, opt = bench.build(cfg, device, bench.MASTER_WEIGHT["gpt"])
    step = jit.StaticFunction(bench.make_train_fn(model, opt),
                              observe=[model, opt], warmup=False)
    cuda = str(device).startswith("cuda")
    targets = [profiler.ProfilerTarget.CPU] + (
        [profiler.ProfilerTarget.GPU] if cuda else [])
    tdir = os.path.join(workdir, "trace")
    prof = profiler.Profiler(
        targets=targets,
        scheduler=profiler.make_scheduler(closed=1, ready=1, record=2),
        on_trace_ready=profiler.export_chrome_tracing(tdir, "gpt355m"))
    _reset()
    window = {}
    with prof:
        for i in range(4):
            if i == 2:
                _sync(device)
                window["before"] = _counts()
            with profiler.RecordEvent("gpt355m_train_step"):
                loss = step(*args)
                profiler.record_counter("deploy_drills.step_loss",
                                        float(loss))
            if i == 3:
                _sync(device)
                window["after"] = _counts()
            prof.step(num_samples=B * S)
    counted = {k: window["after"][k] - window["before"][k]
               for k in window["after"]}
    (path,) = [os.path.join(tdir, f) for f in os.listdir(tdir)]
    trace = profiler.load_profiler_result(path)["traceEvents"]
    spans = sum(e["name"] == "gpt355m_train_step" and e["ph"] == "X"
                for e in trace)
    dev = [e for e in trace if e.get("cat") in profiler.DEVICE_CATEGORIES]
    in_trace = {k: sum(k in e["name"] for e in dev) for k in KERNELS}
    totals = prof.device_totals()
    step_us = sum(t for t, _ in totals.values())
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:12]
    groups: Dict[str, list] = {}
    for name, (t, c) in totals.items():
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += t / 2e3
        g[1] += c // 2
    text = prof.summary()
    rec = {"counted": counted, "in_trace": in_trace, "spans": spans,
           "device_events": len(dev), "trace_bytes": os.path.getsize(path),
           "device_ms_per_step": step_us / 2e3,
           "top": [(n, round(t / 2e3, 4), c // 2) for n, (t, c) in top],
           "groups_ms_per_step": {g: [round(t, 4), c] for g, (t, c) in
                                  sorted(groups.items(),
                                         key=lambda kv: -kv[1][0])},
           "step_info": prof.step_info("tokens"),
           "summary_lines": len(text.splitlines())}
    problems = []
    if spans != 2:
        problems.append(f"{spans} step spans in the trace, 2 expected")
    if cuda:
        if any(in_trace[k] != counted[k] or counted[k] != 2 * cfg.num_layers
               for k in KERNELS):
            problems.append(f"flash events {in_trace} against the counters "
                            f"{counted} ({2 * cfg.num_layers} each expected)")
        if counted["embedding_grad"] == 0 or counted["plain"] or \
                counted["paged_attention"] or counted["fused_adamw"]:
            problems.append(f"launches {counted}: the embedding kernel > 0, "
                            "K4, K5 and the plain versions 0 expected")
    if problems:
        raise DrillFailed("profile: " + "; ".join(problems))
    return rec


# --------------------------------------------------------- (e) device API
def device_api(device: str, small: bool) -> dict:
    """(e)."""
    from .. import device as dev_api
    from ..ops import flash_attention as fa
    from ..profiler import Profiler, ProfilerTarget

    cuda = str(device).startswith("cuda")
    B, S, H, D = (2, 128, 4, 64) if small else (8, 1024, 16, 64)
    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    rec, problems = {}, []
    if cuda:
        mem = (dev_api.memory_allocated(), torch.cuda.memory_allocated(),
               dev_api.max_memory_allocated(),
               torch.cuda.max_memory_allocated(),
               dev_api.cuda.memory_reserved(), torch.cuda.memory_reserved())
        rec["memory"] = mem
        if mem[0] != mem[1] or mem[2] != mem[3] or mem[4] != mem[5]:
            problems.append(f"memory queries {mem} differ from torch.cuda's")
        start, end = (dev_api.Event(enable_timing=True) for _ in range(2))
        fa.flash_fwd(q, k, v, causal=True)
        start.record()
        fa.flash_fwd(q, k, v, causal=True)
        end.record()
        end.synchronize()
        rec["k1_event_ms"] = start.elapsed_time(end)
        side = dev_api.Stream()
        prof = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                        on_trace_ready=lambda p: None)
        with prof:
            o0, l0 = fa.flash_fwd(q, k, v, causal=True)
            with dev_api.stream_guard(side):
                on_side = (torch.cuda.current_stream().cuda_stream
                           == side.cuda_stream)
                o1, l1 = fa.flash_fwd(q, k, v, causal=True)
            torch.cuda.current_stream().wait_stream(side)
        streams = [e.get("args", {}).get("stream")
                   for e in prof._hist_device_events
                   if "flash_fwd" in e["name"]]
        rec.update(side_equal=bool(torch.equal(o0, o1)
                                   and torch.equal(l0, l1)),
                   k1_streams=streams, guard_current=on_side)
        if not (rec["side_equal"] and on_side and len(streams) == 2
                and streams[0] != streams[1]):
            problems.append(f"K1 under stream_guard: equal "
                            f"{rec['side_equal']}, current {on_side}, "
                            f"streams {streams}")
    # the operator's host cost at a tiny shape (the host bounds the call)
    tq, tk, tv = (t[:1, :64, :1].contiguous() for t in (q, k, v))
    scale = 1.0 / D ** 0.5
    n = 20 if small else 400

    def direct():
        if cuda:
            return fa._fwd_cuda(tq, tk, tv, True, scale, 0.0, None, None)
        return fa.ref_flash_fwd(tq, tk, tv, True, scale)

    def via_op():
        return fa.flash_fwd(tq, tk, tv, causal=True)

    times = {}
    for name, fn in (("direct", direct), ("op", via_op), ("op2", via_op),
                     ("direct2", direct)):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        times[name] = 1e6 * (time.perf_counter() - t0) / n
    rec["dispatch_us"] = times
    rec["op_overhead_us"] = (times["op"] + times["op2"]
                             - times["direct"] - times["direct2"]) / 2
    if problems:
        raise DrillFailed("device API: " + "; ".join(problems))
    return rec


# ---------------------------------------------------------------- (f) QAT
def _qat_net(P):
    return P.nn.Sequential(P.nn.Conv2D(3, 8, 3, padding=1), P.nn.ReLU(),
                           P.nn.Flatten(), P.nn.Linear(8 * 8 * 8, 10))


def qat(device: str, small: bool) -> dict:
    """(f): one fake-quant SGD step on ``device`` and on the CPU."""
    import paddle_tpu_torch as paddle
    from ..device import using_device
    from ..quantization import QAT, FakeQuanterWithAbsMaxObserver, QuantConfig

    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3, 8, 8)).astype("f4")
    y = rng.integers(0, 10, (4,))
    res = {}
    for dev in (device, "cpu"):
        with using_device(dev):
            paddle.seed(0)
            net = _qat_net(paddle)
            if dev != device:
                net.set_state_dict(state)
            else:
                state = {k: v.numpy() for k, v in net.state_dict().items()}
            net.train()
            cfg = QuantConfig(weight=FakeQuanterWithAbsMaxObserver())
            cfg.add_layer_config(net[0],
                                 activation=FakeQuanterWithAbsMaxObserver(),
                                 weight=FakeQuanterWithAbsMaxObserver())
            qm = QAT(cfg).quantize(net)
            opt = paddle.optimizer.SGD(learning_rate=0.1,
                                       parameters=qm.parameters())
            loss = paddle.nn.functional.cross_entropy(
                qm(paddle.to_tensor(x)), paddle.to_tensor(y))
            loss.backward()
            grads = {n: p.grad.numpy().copy()
                     for n, p in qm.named_parameters()}
            opt.step()
            res[dev] = (float(loss.numpy()), grads,
                        {n: p.numpy().copy()
                         for n, p in qm.named_parameters()})
    (lc, gc, pc), (lh, gh, ph) = res[device], res["cpu"]
    worst = 0.0
    for a, b in [(gc[k], gh[k]) for k in gh] + [(pc[k], ph[k]) for k in ph]:
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    rec = {"loss": lc, "loss_cpu": lh, "worst_rel_to_max": worst,
           "quanted": sum(type(m).__name__.startswith("Quanted")
                          for m in qm.sublayers())}
    if abs(lc - lh) > QAT_TOL * abs(lh) or worst > QAT_TOL:
        raise DrillFailed(f"qat: card {lc} vs CPU {lh}, worst {worst:.3e}")
    return rec


def run(device: str = "cuda", small: bool = False, log=print) -> dict:
    """(a)-(f), each checked; the summary with every path's launches."""
    from ..device import resolve_device

    resolve_device(device)
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory(prefix="deploy_drills_") as workdir:
        for part, fn in (("serve", lambda: serve(device, small, workdir)),
                         ("profile", lambda: profile(device, small, workdir)),
                         ("device_api", lambda: device_api(device, small)),
                         ("qat", lambda: qat(device, small))):
            t0 = time.perf_counter()
            out[part] = fn()
            seconds[part] = time.perf_counter() - t0
            log(f"deploy drills ({part}): "
                + json.dumps(out[part], default=str))
            if str(device).startswith("cuda"):
                torch.cuda.empty_cache()
    s = out["serve"]
    out["seconds"] = seconds
    out["launches"] = {"infer_gpt355m": s["launches_predictor"],
                       "infer_capi_gpt355m": s["launches_capi"],
                       "infer_bf16_store_gpt355m": s["launches_bf16_store"],
                       "profile_gpt355m": out["profile"]["counted"]}
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
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
