"""Exported control flow, ONNX and the spectral families on one card.

    python -m paddle_tpu_torch.tools.export_drills            # on cuda
    python -m paddle_tpu_torch.tools.export_drills --small --device cpu

Three parts, each checked (a failure raises ``DrillFailed``):

(a) Exported control flow at full width. ``static_drills``' ``to_static``
    greedy decode over GPT-355M (``bench.py:271-283``: vocab 50304, hidden
    1024, 24 layers, 16 heads of 64, f32, seeded weights, eval) at B 4, L
    256 and a 32-token prompt, wrapped in a module and saved with
    ``jit.save``: the program holds one ``while_loop`` node whose body
    holds 24 ``paddle_tpu_torch::flash_fwd`` nodes (K1). ``jit.load`` on
    the card runs ``static_drills.decode``'s three calls (a stop token
    reached early, a run to L, zero trips): tokens and the final ``cur``
    equal that drill's Python loop and its replayed WHILE node bit for
    bit, and K1 launches 24 times a trip. Readings: export and load
    seconds, ``.pdmodel`` bytes, ms a trip of the loaded program against
    the captured graph's. A small ``Layer`` with a tensor ``if`` is saved
    and loaded on the card; both branches equal its eager forward.
(b) ONNX at full width. ``onnx.export_decode`` of GPT-355M at B 1, f32,
    from the card (about 1.4 GB of initializers): the caches of a
    16-token prompt are written by the port's eager ``forward_cached``,
    then four decode steps run on the card's eager step and in the numpy
    evaluator (``tools/onnx_eval.py``) on the host from the same inputs:
    equal next tokens, caches within 1e-4 of their norm. ``onnx.export``
    of MobileNetV2 at B 1, 224 x 224: the evaluator's logits within 1e-4
    by norm of the card's eager ones. Every op type is one the JAX
    converter emits. Readings: nodes, op types, export and evaluation
    seconds, bytes. This part runs in a child process (``--part onnx``,
    :class:`OnnxChild`): its exports are host-bound tracing, which then
    overlaps (a) and (c), or whatever work the caller starts it beside.
(c) The spectral paths on the card against the CPU: an ASR front end on
    B 8 x 160,000 samples (10 s at 16 kHz; n_fft 512, hop 160, Hann):
    the ``stft``/``istft`` round trip, ``LogMelSpectrogram`` with 80 mels
    and ``MFCC`` with 40 coefficients; ``viterbi_decode`` at a CRF
    tagger's shape (B 64, T 128, 52 tags with BOS and EOS, lengths over
    32-128), paths equal; the gradients of the ``fft`` family on real
    inputs.

Each path's launches of the six kernels are counted from 0 just before
it and read just after it (in the child for (b)); a kernel other than
K1 launched in (a), or any launched in (b) or (c), fails the drill.
``--small`` runs each part at a width the CPU takes (the launch checks
need the card).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# the drills' failure, device helpers and launch counters are phase 27's
from .static_drills import KERNELS, DrillFailed, _counts, _cuda, _reset, \
    _sync

# the kernels whose launches each path reports
SIX = (*KERNELS, "paged_attention", "fused_adamw", "embedding_grad")
ONNX_PROMPT, ONNX_STEPS = 16, 4
ASR = {"B": 8, "T": 160_000, "n_fft": 512, "hop": 160, "n_mels": 80,
       "n_mfcc": 40, "sr": 16_000}
CRF = {"B": 64, "T": 128, "N": 52}
# tolerances of the comparisons (module docstring)
ONNX_TOL = 1e-4
SPECTRAL_TOL = {"stft": 1e-5, "istft": 1e-4, "logmel_db": 1e-3,
                "mfcc": 1e-4, "viterbi_scores": 1e-5, "fft_grads": 1e-5}


def _rel(a, b) -> float:
    """``|a - b| / |b|`` (torch tensors or arrays, any device), in f64
    (complex128 for complex values)."""
    a, b = (x.detach().cpu() if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.asarray(x)) for x in (a, b))
    wide = torch.complex128 if a.is_complex() else torch.float64
    a, b = a.to(wide), b.to(wide)
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


class _Decoder(torch.nn.Module):
    """``static_drills.greedy_decode`` under ``to_static`` as a module, so
    that ``jit.save`` takes the model's weights as the program's inputs."""

    def __init__(self, model):
        super().__init__()
        from .. import jit
        from . import static_drills

        self.model = model
        self.decode = jit.to_static(static_drills.greedy_decode)

    def forward(self, tokens, cur, stop):
        from ..tensor import Tensor

        return self.decode(self.model, Tensor._wrap(tokens),
                           Tensor._wrap(cur), Tensor._wrap(stop))


def _launched() -> dict:
    """The six kernels' launches since the last ``_reset()``."""
    counts = _counts()
    return {k: counts[k] for k in SIX}


def _program_nodes(ep) -> dict:
    """The top graph's ``while_loop`` nodes and the K1 nodes inside each
    body of a loaded program (``TranslatedLayer._exported``)."""
    gm = ep.graph_module
    loops = [n for n in gm.graph.nodes if n.op == "call_function"
             and getattr(n.target, "__name__", "") == "while_loop"]
    bodies = [getattr(gm, n.args[1].target) for n in loops]
    return {"while_loop": len(loops),
            "flash_fwd_in_body": [sum("flash_fwd" in str(b.target)
                                      for b in body.graph.nodes)
                                  for body in bodies],
            "flash_fwd_outside": sum("flash_fwd" in str(n.target)
                                     for n in gm.graph.nodes)}


def _gated(P):
    class Gated(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = P.nn.Linear(64, 64)
            self.b = P.nn.Linear(64, 64)

        def forward(self, x):
            if x.sum() > 0:
                y = self.a(x)
            else:
                y = self.b(x)
            return y

    return Gated()


# ----------------------------------------------------------------- (a)
def exported_control_flow(device: str, small: bool, workdir: str,
                          model) -> dict:
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jit
    from ..jit.dy2static import ast_transform
    from . import static_drills as sd

    cfg = model.config
    L = 32 if small else sd.DECODE_L
    rec = sd.LAST_DECODE
    if rec.get("device") != str(device) or rec.get("small") != small:
        sd.decode(device, small)  # phase 27's loop and WHILE node
        rec = sd.LAST_DECODE
    prefix = os.path.join(workdir, "decode")
    t0 = time.perf_counter()
    jit.save(_Decoder(model), prefix, input_spec=[
        jit.InputSpec([sd.DECODE_B, L], "int64", name="tokens"),
        jit.InputSpec([], "int64", name="cur"),
        jit.InputSpec([], "int64", name="stop")])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = jit.load(prefix, device=device)
    _sync(device)
    load_s = time.perf_counter() - t0
    nodes = _program_nodes(loaded._exported)
    problems, trips, ms, k1 = [], {}, {}, {}
    launches = dict.fromkeys(SIX, 0)
    if nodes["while_loop"] != 1 or nodes["flash_fwd_in_body"] != [
            cfg.num_layers] or nodes["flash_fwd_outside"]:
        problems.append(f"program nodes {nodes}")
    for name, (tokens, cur, stop) in rec["cases"].items():
        _reset()
        t1 = time.perf_counter()
        tok, c = loaded(tokens, np.int64(cur), np.int64(stop))
        _sync(device)
        ms[name] = 1e3 * (time.perf_counter() - t1)
        counts = _counts()
        c = int(c)
        trips[name] = c - cur
        for ref in ("python_loop", "while_node"):
            wtok, wcur = rec[ref][name]
            if c != wcur or not torch.equal(tok._value, wtok):
                problems.append(f"{name}: cur {c} vs the {ref}'s {wcur}, "
                                "tokens equal "
                                f"{bool(torch.equal(tok._value, wtok))}")
        k1[name] = counts["flash_fwd"]
        for k in SIX:
            launches[k] += counts[k]
        others = [counts[k] for k in SIX if k != "flash_fwd"]
        if _cuda(device) and (counts["flash_fwd"] != cfg.num_layers
                              * trips[name] or counts["plain"]
                              or any(others)):
            problems.append(f"{name}: launches {counts} over {trips[name]} "
                            f"trips, expected K1 {cfg.num_layers} a trip "
                            "and no other kernel")
    # a small Layer with a tensor if, both branches on the card
    with paddle.device.using_device(device):
        paddle.seed(0)
        gated = _gated(paddle)
        gpath = os.path.join(workdir, "gated")
        jit.save(gated, gpath, input_spec=[jit.InputSpec([4, 64],
                                                         "float32")])
        gl = jit.load(gpath, device=device)
        fwd = ast_transform(gated.forward)
        branches = {}
        for sign in (1.0, -1.0):
            x = paddle.to_tensor(np.full((4, 64), sign, np.float32),
                                 place=device)
            with torch.no_grad():
                want = fwd(x)._value
            got = gl(x)._value
            branches["pos" if sign > 0 else "neg"] = bool(
                torch.equal(got, want))
    if not all(branches.values()):
        problems.append(f"gated layer branches equal eager: {branches}")
    if problems:
        raise DrillFailed("exported control flow: " + "; ".join(problems))
    per_trip = ms["to_L"] / max(trips["to_L"], 1)
    return {"export_s": export_s, "load_s": load_s,
            "pdmodel_bytes": os.path.getsize(prefix + ".pdmodel"),
            "pdiparams_bytes": os.path.getsize(prefix + ".pdiparams"),
            "nodes": nodes, "trips": trips, "ms_per_call": ms,
            "ms_per_trip_loaded": per_trip,
            "ms_per_trip_captured": rec["ms_per_trip"],
            "k1_by_case": k1, "tokens_equal": True,
            "gated_branches_equal": branches, "launches": launches}


# ----------------------------------------------------------------- (b)
def _decode_onnx(device, small, workdir, model) -> dict:
    from .. import onnx
    from ..onnx.convert import JAX_OP_TYPES
    from . import onnx_eval

    cfg = model.config
    _reset()
    t0 = time.perf_counter()
    path = onnx.export_decode(model, os.path.join(workdir, "gpt_decode"),
                              batch=1)
    export_s = time.perf_counter() - t0
    trace_launches = _launched()
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    g = onnx_eval.load(path)
    read_s = time.perf_counter() - t0
    types = g.op_types()
    n_layers, heads, hd = model._cache_spec()
    total = cfg.max_position_embeddings
    step = onnx._DecodeStep(model, n_layers, [])
    caches = [torch.zeros((1, total, heads, hd), device=device)
              for _ in range(2 * n_layers)]
    ids = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, ONNX_PROMPT))).to(device)
    with torch.no_grad():
        hidden, _ = model._decode_trunk()(
            ids, caches=[(caches[2 * i], caches[2 * i + 1])
                         for i in range(n_layers)],
            cur_len=torch.zeros((), dtype=torch.int64, device=device))
        tok = torch.argmax(model.logits(hidden)[:, -1, :].float(), -1)
    host = [c.cpu().numpy() for c in caches]
    tok = tok.reshape(1, 1)
    problems, tokens, worst, eval_s = [], [], 0.0, 0.0
    for k in range(ONNX_STEPS):
        cur = ONNX_PROMPT + k
        with torch.no_grad():
            out = step(tok, torch.full((), cur, dtype=torch.int32,
                                       device=device), *caches)
        nxt = int(out[0].reshape(-1)[0])
        t0 = time.perf_counter()
        res = onnx_eval.run(g, dict(zip(g.inputs, [
            tok.cpu().numpy(), np.int32(cur)] + host)))
        eval_s += time.perf_counter() - t0
        host = list(res[1:])
        got = int(res[0].reshape(-1)[0])
        worst = max([worst] + [_rel(h, c) for h, c in zip(host, caches)])
        tokens.append((nxt, got))
        if got != nxt:
            problems.append(f"step {k}: next token {got} vs the card's "
                            f"{nxt}")
        tok = torch.full((1, 1), nxt, dtype=torch.int64, device=device)
    if worst > ONNX_TOL:
        problems.append(f"caches {worst:.2e} by norm")
    if not set(types) <= JAX_OP_TYPES:
        problems.append(f"op types outside the JAX converter's: "
                        f"{set(types) - JAX_OP_TYPES}")
    if any(trace_launches.values()):
        problems.append(f"the trace launched {trace_launches}")
    if problems:
        raise DrillFailed("onnx decode: " + "; ".join(problems))
    return {"export_s": export_s, "read_s": read_s, "eval_s": eval_s,
            "bytes": nbytes, "nodes": len(g.nodes),
            "op_types": dict(sorted(types.items())), "tokens": tokens,
            "caches_rel": worst, "launches": trace_launches}


def _mobilenet_onnx(device, small, workdir) -> dict:
    import paddle_tpu_torch as paddle
    from .. import onnx
    from ..onnx.convert import JAX_OP_TYPES
    from ..vision.models import mobilenet_v2
    from . import onnx_eval

    size = 32 if small else 224
    with paddle.device.using_device(device):
        paddle.seed(0)
        net = mobilenet_v2()
        net.eval()
        x = np.random.default_rng(12).standard_normal(
            (1, 3, size, size)).astype(np.float32)
        with torch.no_grad():
            want = net(paddle.to_tensor(x, place=device))._value.cpu()
        spec = paddle.to_tensor(x, place=device)
        _reset()
        t0 = time.perf_counter()
        path = onnx.export(net, os.path.join(workdir, "mobilenet_v2"),
                           input_spec=[spec])
        export_s = time.perf_counter() - t0
        trace_launches = _launched()
    t0 = time.perf_counter()
    g = onnx_eval.load(path)
    (got,) = onnx_eval.run(g, {g.inputs[0]: x})
    eval_s = time.perf_counter() - t0
    types = g.op_types()
    rel = _rel(got, want)
    if rel > ONNX_TOL or types["Conv"] != 52 or not set(types) <= \
            JAX_OP_TYPES or any(trace_launches.values()):
        raise DrillFailed(f"onnx mobilenet_v2: logits {rel:.2e} by norm, "
                          f"{types['Conv']} convs, op types {set(types)}, "
                          f"the trace launched {trace_launches}")
    return {"export_s": export_s, "eval_s": eval_s,
            "bytes": os.path.getsize(path), "nodes": len(g.nodes),
            "op_types": dict(sorted(types.items())), "logits_rel": rel,
            "launches": trace_launches}


def onnx_models(device: str, small: bool, workdir: str, model) -> dict:
    """Part (b) on ``model`` (GPT-355M in f32 from phase 27's seed)."""
    return {"gpt_decode": _decode_onnx(device, small, workdir, model),
            "mobilenet_v2": _mobilenet_onnx(device, small, workdir)}


# ----------------------------------------------------------------- (c)
def _spectral_on(dev: str, small: bool) -> dict:
    import paddle_tpu_torch as paddle

    a = dict(ASR, B=2, T=16_000) if small else ASR
    c = dict(CRF, B=4, T=16, N=8) if small else CRF
    rng = np.random.default_rng(13)
    audio = (0.1 * rng.standard_normal((a["B"], a["T"]))).astype(np.float32)
    pot = rng.standard_normal((c["B"], c["T"], c["N"])).astype(np.float32)
    trans = rng.standard_normal((c["N"], c["N"])).astype(np.float32)
    lens = rng.integers(c["T"] // 4, c["T"] + 1, c["B"]).astype(np.int64)
    sig = rng.standard_normal((4, 1024)).astype(np.float32)
    out, ms = {}, {}

    def timed(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        r = fn()
        _sync(dev)
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return r

    with paddle.device.using_device(dev), torch.no_grad():
        x = paddle.to_tensor(audio, place=dev)
        win = paddle.audio.functional.get_window("hann", a["n_fft"])
        spec = timed("stft", lambda: paddle.signal.stft(
            x, n_fft=a["n_fft"], hop_length=a["hop"], window=win))
        back = timed("istft", lambda: paddle.signal.istft(
            spec, n_fft=a["n_fft"], hop_length=a["hop"], window=win,
            length=a["T"]))
        logmel = paddle.audio.features.LogMelSpectrogram(
            sr=a["sr"], n_fft=a["n_fft"], hop_length=a["hop"],
            n_mels=a["n_mels"])
        mfcc = paddle.audio.features.MFCC(
            sr=a["sr"], n_mfcc=a["n_mfcc"], n_fft=a["n_fft"],
            hop_length=a["hop"], n_mels=a["n_mels"])
        out["logmel"] = timed("logmel", lambda: logmel(x))._value.cpu()
        out["mfcc"] = timed("mfcc", lambda: mfcc(x))._value.cpu()
        scores, paths = timed("viterbi", lambda: paddle.text.viterbi_decode(
            paddle.to_tensor(pot, place=dev),
            paddle.to_tensor(trans, place=dev),
            paddle.to_tensor(lens, place=dev)))
    out["stft"] = spec._value.cpu()
    out["roundtrip_err"] = float((back._value.cpu()
                                  - torch.from_numpy(audio)).abs().max())
    out["scores"], out["paths"] = scores._value.cpu(), paths._value.cpu()
    grads = []
    with paddle.device.using_device(dev):
        for fn in (lambda t: paddle.abs(paddle.fft.rfft(t)) ** 2,
                   lambda t: paddle.real(paddle.fft.fft2(t, norm="ortho")),
                   lambda t: paddle.imag(paddle.fft.ihfft(t)),
                   lambda t: paddle.fft.irfft(paddle.fft.rfft(t) * 2.0)):
            t = paddle.to_tensor(sig, place=dev, stop_gradient=False)
            fn(t).sum().backward()
            grads.append(t.grad._value.cpu())
    out["fft_grads"] = grads
    out["ms"] = ms
    return out


def spectral(device: str, small: bool) -> dict:
    card = _spectral_on(device, small)
    cpu = _spectral_on("cpu", small)
    _reset()
    card2 = _spectral_on(device, small)  # counted: none expected
    counts = _counts()
    rel = {"stft": _rel(card["stft"], cpu["stft"]),
           "logmel_db": float((card["logmel"] - cpu["logmel"]).abs().max()),
           "mfcc": _rel(card["mfcc"], cpu["mfcc"]),
           "viterbi_scores": _rel(card["scores"], cpu["scores"]),
           "fft_grads": max(_rel(a, b) for a, b in zip(card["fft_grads"],
                                                       cpu["fft_grads"]))}
    rel["istft"] = max(card["roundtrip_err"], cpu["roundtrip_err"])
    problems = [f"{k} {v:.2e} > {SPECTRAL_TOL[k]}" for k, v in rel.items()
                if v > SPECTRAL_TOL[k]]
    if not torch.equal(card["paths"], cpu["paths"]):
        problems.append("viterbi paths differ from the CPU's")
    launched = {k: counts[k] for k in SIX}
    if any(launched.values()) or counts["plain"]:
        problems.append(f"kernels launched: {launched}, plain flash "
                        f"{counts['plain']}")
    if problems:
        raise DrillFailed("spectral: " + "; ".join(problems))
    return {"diffs": rel, "tol": SPECTRAL_TOL, "paths_equal": True,
            "ms": card2["ms"], "cpu_ms": cpu["ms"], "launches": launched,
            "shapes": {"stft": list(card["stft"].shape),
                       "logmel": list(card["logmel"].shape),
                       "mfcc": list(card["mfcc"].shape),
                       "paths": list(card["paths"].shape)}}


def _model(device, small):
    """GPT-355M in f32 from phase 27's seed, TF32 off."""
    from ..models import GPTForCausalLM
    from . import static_drills as sd

    if _cuda(device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return GPTForCausalLM(sd._config(small)[0], device=device, seed=0).eval()


def _onnx_part(device: str, small: bool) -> dict:
    """Part (b) alone, as the child process of :class:`OnnxChild` runs
    it."""
    workdir = tempfile.mkdtemp(prefix="export_drills_onnx_")
    try:
        return onnx_models(device, small, workdir, _model(device, small))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


class OnnxChild:
    """Part (b) in a child process (``--part onnx``), started here: its
    exports are host-bound tracing, which then runs beside the caller's
    work (``chip_smoke.py`` starts it beside the train chaos phase, whose
    drills mostly wait on their own children). :meth:`result` waits for
    its record; the child is killed if this process exits first."""

    def __init__(self, device: str = "cuda", small: bool = False):
        import atexit
        import subprocess

        fd, self.path = tempfile.mkstemp(prefix="export_drills_onnx_",
                                         suffix=".json")
        os.close(fd)
        self.log = tempfile.TemporaryFile()
        cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.export_drills",
               "--part", "onnx", "--device", str(device), "--json",
               self.path, "--t0", repr(time.time())] \
            + (["--small"] if small else [])
        self.proc = subprocess.Popen(
            cmd, cwd=str(Path(__file__).resolve().parents[2]),
            stdout=self.log, stderr=subprocess.STDOUT)
        self.record = None
        atexit.register(self.kill)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def result(self, timeout: float = 900.0) -> dict:
        """The child's record (waited for once), with ``child_s``: the
        seconds from its start to its record, by the child's clock."""
        import subprocess

        if self.record is not None:
            return self.record
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise DrillFailed(f"onnx: the child gave no result in {timeout} "
                              "s")
        try:
            if rc != 0:
                self.log.seek(0)
                tail = self.log.read()[-4000:].decode(errors="replace")
                raise DrillFailed(f"onnx: the child exited {rc}: {tail}")
            with open(self.path) as f:
                self.record = json.load(f)
        finally:
            self.log.close()
            os.unlink(self.path)
        return self.record


def run(device: str = "cuda", small: bool = False, log=print,
        onnx: OnnxChild | None = None) -> dict:
    """The three parts; returns their records, the seconds each took and
    each path's launches as counted. Part (b) is ``onnx`` (an
    :class:`OnnxChild` the caller started earlier), else a child started
    here beside (a) and (c); its seconds here are those waited for it."""
    child = onnx if onnx is not None else OnnxChild(device, small)
    out, secs = {}, {}
    workdir = tempfile.mkdtemp(prefix="export_drills_")
    try:
        model = _model(device, small)
        t0 = time.perf_counter()
        out["control_flow"] = exported_control_flow(device, small, workdir,
                                                    model)
        secs["control_flow"] = time.perf_counter() - t0
        log("export drills control_flow: "
            + json.dumps(out["control_flow"], default=str))
        del model
        if _cuda(device):
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["spectral"] = spectral(device, small)
        secs["spectral"] = time.perf_counter() - t0
        log("export drills spectral: " + json.dumps(out["spectral"],
                                                    default=str))
        t0 = time.perf_counter()
        out["onnx"] = child.result()
        secs["onnx"] = time.perf_counter() - t0
        log("export drills onnx: " + json.dumps(out["onnx"], default=str))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        child.kill()
    out["seconds"] = secs
    out["launches"] = {
        "export_decode_loaded_gpt355m": out["control_flow"]["launches"],
        "onnx_trace_gpt355m": out["onnx"]["gpt_decode"]["launches"],
        "onnx_trace_mobilenet_v2": out["onnx"]["mobilenet_v2"]["launches"],
        "spectral": out["spectral"]["launches"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--part", choices=("all", "onnx"), default="all",
                    help="onnx: part (b) alone, its record to --json")
    ap.add_argument("--json", help="where --part onnx writes its record")
    ap.add_argument("--t0", type=float, default=time.time(),
                    help="--part onnx: the wall time its parent started it")
    args = ap.parse_args(argv)
    try:
        if args.part == "onnx":
            rec = _onnx_part(args.device, args.small)
            rec["child_s"] = time.time() - args.t0
            with open(args.json, "w") as f:
                json.dump(rec, f)
        else:
            run(args.device, args.small)
    except DrillFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
