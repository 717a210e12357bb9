"""Cross-process restart drill: kill a WAL-armed serving process, bring it
back, prove nothing was lost.

Counterpart of ``paddle_tpu/loadgen/restart.py``. Both halves:

- **Child** (``python -m paddle_tpu_torch.loadgen.restart ...``): builds
  a seeded Llama fleet behind ``Router(wal_dir=...)`` on ``--device``
  (``cuda`` unless the caller asks for the CPU), replays a seeded
  :func:`~.trace.generate_trace` workload, and appends every delivered
  stream chunk as one JSON line to ``chunks.jsonl``: the file is the
  client, and a line in it is a delivery (commit-then-emit means the WAL
  holds what the file holds). After every router step it also appends
  its counts (K4's launches by path, CUDA-graph captures, ``nvcc`` runs)
  to ``counts.jsonl``, so a killed child's work is still counted.
  ``--recover`` rebuilds the fleet (possibly with another replica
  count), calls :meth:`Router.recover`, re-attaches each journaled
  stream after the parent's ``after_seq`` cursor, drains, and writes a
  timing JSON.
- **Parent** (:func:`run_restart_drill`): runs the uninterrupted
  reference, then the child it SIGKILLs once the chunks file shows
  mid-stream progress (on a card: while the child holds its CUDA
  context and replays its graphs), then the recovering child with fewer
  engines, and returns the three chunk streams, the recovering child's
  timing and every child's last counts. The callers assert
  (``tools/serve_fleet.py``, ``tests/test_torch_loadgen.py``).

The compile contract of a restart differs from the JAX package's, whose
restarted process loads its step programs from a persistent compile
cache and so compiles nothing fresh. A CUDA graph cannot outlive its
process, so the recovering child captures its own engines' buckets
again (counted as ``jit_compiles_total{source="fresh"}``, one per bucket
per engine, their seconds in the timing); what it must not do is build
a kernel: the CUDA sources were built by an earlier process into
``build/paddle_tpu_torch/``, and the child only loads them
(``timing["nvcc_runs"] == 0``).

Determinism across the kill: every process builds the model from the
same seed and every request samples by (seed, position), so the
recovered decode regenerates the tokens the dead process would have
produced.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["SEED", "SIZES", "build_model", "build_router", "serve",
           "spawn_serve", "read_chunks", "read_manifest",
           "cursors_from_chunks", "wait_for_chunk_lines",
           "run_restart_drill", "streams_by_index", "last_counts"]

SEED = 20
MODEL_ID = "m"

# per size: the model, the engines and the trace. "tiny" is the JAX
# drill's (CPU tests); "llama_076b" serves Llama-0.76B at full width on
# bf16 pages of 16 (the card)
SIZES = {
    "tiny": dict(
        model=dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
                   num_key_value_heads=1, max_position_embeddings=64),
        dtype="float32",
        engine=dict(page_size=4, max_batch_slots=2, token_budget=32,
                    watchdog_stall_s=None),
        trace=dict(vocab_size=96, num_prompt_families=3, prefix_len=6,
                   max_prompt_len=20, suffix_len_mean=4.0,
                   output_len_mean=6.0, output_len_sigma=0.4,
                   max_output_len=10, temperature=0.8)),
    "llama_076b": dict(
        model=dict(vocab_size=32000, hidden_size=2048, num_layers=12,
                   num_heads=16, num_key_value_heads=16,
                   max_position_embeddings=2048),
        dtype="bfloat16",
        engine=dict(page_size=16, max_batch_slots=8, max_model_len=2048,
                    num_pages=8 * 40 + 1, token_budget=1024,
                    kv_dtype="bfloat16", watchdog_stall_s=None),
        trace=dict(vocab_size=32000, num_prompt_families=3, prefix_len=64,
                   max_prompt_len=320, suffix_len_mean=96.0,
                   output_len_mean=24.0, output_len_sigma=0.4,
                   max_output_len=32, temperature=0.8)),
}


def build_model(device=None, size: str = "tiny"):
    """The drill model, identical in every process that builds it on the
    same device: its weights are drawn from ``SEED``."""
    import torch

    from ..models import LlamaConfig, LlamaForCausalLM
    spec = SIZES[size]
    return LlamaForCausalLM(LlamaConfig(**spec["model"]), device=device,
                            dtype=getattr(torch, spec["dtype"]), seed=SEED)


def build_router(wal_dir: Optional[str], replicas: int, device=None,
                 size: str = "tiny", model=None):
    """A drill fleet: ``replicas`` engines of the seeded model (``model``
    if given, else built here), WAL-armed when ``wal_dir`` is given."""
    from ..serving import Router
    router = Router(wal_dir=wal_dir)
    router.add_model(MODEL_ID, model if model is not None
                     else build_model(device, size), replicas=replicas,
                     device=device, **SIZES[size]["engine"])
    return router


def _counts(router) -> dict:
    """This process's counts: K4's paths, the fleet's captures and their
    seconds, ``nvcc`` runs."""
    from ..ops import _build
    from ..ops import paged_attention as pa
    engines = router.engines()
    return {"kernel_launches": pa.kernel_launches,
            "captured_launches": pa.captured_launches,
            "replayed_launches": pa.replayed_launches,
            "plain_calls": pa.plain_calls,
            "captures": sum(e.compile_counts()["step"] for e in engines),
            "capture_s": {e.engine_id: e.capture_seconds()
                          for e in engines},
            "nvcc_runs": _build.nvcc_runs}


def serve(wal_dir: str, chunks_path: str, manifest_path: str,
          replicas: int, device=None, size: str = "tiny",
          num_requests: int = 8, recover: bool = False,
          cursors: Optional[Dict[int, int]] = None,
          timing_path: Optional[str] = None,
          counts_path: Optional[str] = None, model=None) -> dict:
    """The child body (also callable in-process).

    Fresh mode: generate the seeded trace, submit everything through the
    WAL-armed router, drive ``step()`` until drained, sealing via
    :meth:`Router.shutdown`. Every delivered chunk appends one
    line-buffered JSON record ``{"idx", "wal", "tok", "fin", "seq"}`` to
    ``chunks_path``; ``manifest_path`` gets one ``{"idx", "wal"}`` line
    per admission (flushed at submit, so the recovering process can map
    journaled WAL ids back to trace indices after a SIGKILL).

    Recover mode: rebuild the fleet, :meth:`Router.recover`, re-attach
    each manifest stream at ``cursors[wal_id]`` (the last seq the chunks
    file holds), drain, and write ``timing_path``: recover latency, time
    to first recovered token, the fresh captures with their seconds,
    ``nvcc`` runs, per-outcome tallies, router steps and the WAL's fsyncs
    (count and seconds) over them. ``counts_path`` gets
    :func:`_counts` after every step."""
    import numpy as np
    import torch

    from .trace import TraceConfig, generate_trace

    t_start = time.perf_counter()
    router = build_router(wal_dir, replicas, device=device, size=size,
                          model=model)
    chunks_f = open(chunks_path, "a", buffering=1)
    counts_f = (None if counts_path is None
                else open(counts_path, "a", buffering=1))
    timing: dict = {"mode": "recover" if recover else "fresh",
                    "replicas": replicas, "first_token_s": None}

    def _cb(idx: int, wal_cell: list):
        def cb(rid, tok, fin, seq):
            if timing["first_token_s"] is None:
                timing["first_token_s"] = time.perf_counter() - t_start
            chunks_f.write(json.dumps(
                {"idx": idx, "wal": wal_cell[0],
                 "tok": None if tok is None else int(tok),
                 "fin": fin if fin else None, "seq": int(seq)}) + "\n")
        return cb

    from .. import metrics
    reg = metrics.get_registry()

    def fsyncs():
        fam = reg.get("paddle_tpu_wal_fsync_seconds")
        return (0, 0.0) if fam is None else (fam.count, fam.sum)

    fsync0 = fsyncs()
    timing["steps"] = 0

    def drain():
        while router.has_work:
            router.step()
            timing["steps"] += 1
            if counts_f is not None:
                counts_f.write(json.dumps(_counts(router)) + "\n")

    if not recover:
        trace = generate_trace(TraceConfig(
            seed=SEED, num_requests=num_requests, **SIZES[size]["trace"]))
        with open(manifest_path, "a", buffering=1) as man:
            for tr in trace.requests:
                cell = [None]
                rid = router.submit(
                    np.asarray(tr.prompt, np.int32), model=MODEL_ID,
                    max_new_tokens=tr.max_new_tokens,
                    temperature=tr.temperature, seed=tr.seed,
                    priority=tr.priority, stream_cb=_cb(tr.index, cell))
                cell[0] = router.wal_id_of(rid)
                man.write(json.dumps(
                    {"idx": tr.index, "wal": cell[0]}) + "\n")
        drain()
        router.shutdown()
    else:
        cursors = cursors or {}
        res = router.recover()
        timing["recover_s"] = time.perf_counter() - t_start
        timing["outcomes"] = {}
        for r in res.values():
            o = r["outcome"]
            timing["outcomes"][o] = timing["outcomes"].get(o, 0) + 1
        for idx, wal in read_manifest(manifest_path):
            cell = [wal]
            router.attach_stream(wal, _cb(idx, cell),
                                 after_seq=int(cursors.get(wal, -1)))
        drain()
        router.shutdown()
    counts = _counts(router)
    fsync1 = fsyncs()
    timing["fsyncs"] = fsync1[0] - fsync0[0]
    timing["fsync_s"] = fsync1[1] - fsync0[1]
    fam = reg.get("paddle_tpu_jit_compiles_total")
    timing["fresh_compiles"] = (
        0 if fam is None else int(fam.sum_labels(source="fresh")))
    timing["nvcc_runs"] = counts["nvcc_runs"]
    timing["captures"] = counts["captures"]
    timing["capture_s"] = counts["capture_s"]
    if router.engines()[0].device.type == "cuda":
        timing["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    timing["total_s"] = time.perf_counter() - t_start
    chunks_f.close()
    if counts_f is not None:
        counts_f.write(json.dumps(counts) + "\n")
        counts_f.close()
    if timing_path is not None:
        with open(timing_path, "w") as f:
            json.dump(timing, f, indent=2, sort_keys=True)
    return timing


# ---------------------------------------------------------------- parent
def spawn_serve(wal_dir: str, chunks_path: str, manifest_path: str,
                replicas: int, device: str = "cuda", size: str = "tiny",
                num_requests: int = 8, recover: bool = False,
                cursors: Optional[Dict[int, int]] = None,
                timing_path: Optional[str] = None,
                counts_path: Optional[str] = None) -> subprocess.Popen:
    """Launch :func:`serve` in a CHILD python (the process the drill
    kills), importing this checkout's ``paddle_tpu_torch``."""
    argv = [sys.executable, "-m", "paddle_tpu_torch.loadgen.restart",
            "--wal-dir", wal_dir, "--chunks", chunks_path,
            "--manifest", manifest_path, "--replicas", str(replicas),
            "--device", str(device), "--size", size,
            "--num-requests", str(num_requests)]
    if recover:
        argv += ["--recover"]
    if cursors:
        argv += ["--cursors", json.dumps(
            {str(k): v for k, v in cursors.items()})]
    if timing_path is not None:
        argv += ["--timing", timing_path]
    if counts_path is not None:
        argv += ["--counts", counts_path]
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def read_chunks(path: str) -> List[dict]:
    """Parse a JSON-lines file, tolerating the torn final line a SIGKILL
    mid-``write`` can leave (the WAL's own torn-tail discipline)."""
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                break               # torn tail: everything before it holds
    return out


def read_manifest(path: str) -> List[Tuple[int, int]]:
    """``[(trace index, wal_id), ...]`` — same torn-tail tolerance."""
    return [(c["idx"], c["wal"]) for c in read_chunks(path)]


def last_counts(path: str) -> Optional[dict]:
    """The last whole counts record a child wrote (None: none)."""
    recs = read_chunks(path)
    return recs[-1] if recs else None


def cursors_from_chunks(chunks: List[dict]) -> Dict[int, int]:
    """The exactly-once resume cursors: last seq delivered per WAL id."""
    cur: Dict[int, int] = {}
    for c in chunks:
        w = c["wal"]
        if w is not None:
            cur[w] = max(cur.get(w, -1), int(c["seq"]))
    return cur


def wait_for_chunk_lines(path: str, n: int, timeout_s: float = 120.0,
                         proc: Optional[subprocess.Popen] = None) -> int:
    """Poll until ``path`` holds >= n chunk lines (the parent's
    mid-stream trigger); returns the count seen. Raises if the child
    exits first or the timeout lapses."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = len(read_chunks(path))
        if got >= n:
            return got
        if proc is not None and proc.poll() is not None:
            tail = proc.stdout.read().decode(errors="replace")[-2000:]
            raise RuntimeError(
                f"child exited rc={proc.returncode} before producing "
                f"{n} chunks (saw {got}):\n{tail}")
        time.sleep(0.01)
    raise TimeoutError(f"no {n} chunks within {timeout_s}s "
                       f"(saw {len(read_chunks(path))})")


def _finish(proc: subprocess.Popen, what: str, timeout_s: float) -> None:
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed rc={proc.returncode}:"
                           f"\n{out.decode(errors='replace')[-2000:]}")


def run_restart_drill(workdir: str, replicas_before: int = 2,
                      replicas_after: int = 1, num_requests: int = 6,
                      kill_after_chunks: int = 8, device: str = "cuda",
                      size: str = "tiny", timeout_s: float = 300.0,
                      reference_model=None) -> dict:
    """The full kill-the-process drill over one ``workdir``:

    1. ``ref/`` — the uninterrupted WAL-armed run, the byte truth: in
       this process on ``reference_model`` when one is given (the drill
       model, built by :func:`build_model` on ``device``), else a child.
    2. ``live/`` — the same workload in a child, SIGKILLed once
       ``kill_after_chunks`` chunks landed (mid-decode: the trigger is
       below the reference total).
    3. ``live/`` recover — a child with ``replicas_after`` engines adopts
       the WAL and resumes each stream after the cursor the chunks file
       proves delivered.

    Returns the reference, pre-kill and post-recovery chunks, the
    recovering child's timing, ``rto_s`` (SIGKILL to the first
    recovered chunk in the file) and ``counts``: each child's last counts
    record (the killed child's from before the kill; an in-process
    reference counts in this process's own counters). Every process
    started is waited for, killed on a timeout."""
    ref_dir = os.path.join(workdir, "ref")
    live_dir = os.path.join(workdir, "live")
    paths = {
        tag: {"wal": os.path.join(d, "wal"),
              "chunks": os.path.join(d, "chunks.jsonl"),
              "manifest": os.path.join(d, "manifest.jsonl"),
              "timing": os.path.join(d, "timing.json"),
              "counts": os.path.join(d, f"counts-{tag}.jsonl")}
        for tag, d in (("ref", ref_dir), ("live", live_dir))}
    for p in paths.values():
        os.makedirs(p["wal"], exist_ok=True)
    counts = {}

    # 1. the uninterrupted reference
    ref = paths["ref"]
    if reference_model is not None:
        serve(ref["wal"], ref["chunks"], ref["manifest"],
              replicas=replicas_before, device=device, size=size,
              num_requests=num_requests, timing_path=ref["timing"],
              model=reference_model)
    else:
        proc = spawn_serve(ref["wal"], ref["chunks"], ref["manifest"],
                           replicas=replicas_before, device=device,
                           size=size, num_requests=num_requests,
                           timing_path=ref["timing"],
                           counts_path=ref["counts"])
        _finish(proc, "reference run", timeout_s)
        counts["ref"] = last_counts(ref["counts"])
    ref_chunks = read_chunks(ref["chunks"])
    if kill_after_chunks >= len(ref_chunks):
        raise ValueError(
            f"kill_after_chunks={kill_after_chunks} >= reference total "
            f"{len(ref_chunks)}: the kill would not be mid-decode")

    # 2. the doomed run: SIGKILL once mid-stream
    live = paths["live"]
    killed_counts = live["counts"].replace(".jsonl", "-killed.jsonl")
    proc = spawn_serve(live["wal"], live["chunks"], live["manifest"],
                       replicas=replicas_before, device=device, size=size,
                       num_requests=num_requests, counts_path=killed_counts)
    try:
        wait_for_chunk_lines(live["chunks"], kill_after_chunks,
                             timeout_s=timeout_s, proc=proc)
    finally:
        t_kill = time.monotonic()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
        proc.stdout.close()
    pre_chunks = read_chunks(live["chunks"])
    counts["killed"] = last_counts(killed_counts)

    # 3. recover on a smaller fleet, resuming after the proven cursors
    n_pre = len(pre_chunks)
    proc = spawn_serve(live["wal"], live["chunks"], live["manifest"],
                       replicas=replicas_after, device=device, size=size,
                       num_requests=num_requests, recover=True,
                       cursors=cursors_from_chunks(pre_chunks),
                       timing_path=live["timing"],
                       counts_path=live["counts"])
    rto_s = None
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if len(read_chunks(live["chunks"])) > n_pre:
            rto_s = time.monotonic() - t_kill
            break
        if proc.poll() is not None:
            break
        time.sleep(0.01)
    _finish(proc, "recovery run", timeout_s)
    counts["recover"] = last_counts(live["counts"])
    all_chunks = read_chunks(live["chunks"])
    with open(live["timing"]) as f:
        timing = json.load(f)
    return {"ref_chunks": ref_chunks, "pre_chunks": pre_chunks,
            "post_chunks": all_chunks[n_pre:], "timing": timing,
            "rto_s": rto_s, "manifest": read_manifest(live["manifest"]),
            "killed_after": n_pre, "counts": counts}


def streams_by_index(chunks: List[dict]) -> Dict[int, List[tuple]]:
    """Fold a chunk list into per-trace-index ``(tok, fin, seq)``
    streams, preserving delivery order — the unit the drill compares."""
    out: Dict[int, List[tuple]] = {}
    for c in chunks:
        out.setdefault(c["idx"], []).append(
            (c["tok"], c["fin"], c["seq"]))
    return out


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wal-dir", required=True)
    ap.add_argument("--chunks", required=True)
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--size", default="tiny", choices=sorted(SIZES))
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--recover", action="store_true")
    ap.add_argument("--cursors", default=None,
                    help="JSON {wal_id: last_seq} resume cursors")
    ap.add_argument("--timing", default=None)
    ap.add_argument("--counts", default=None)
    args = ap.parse_args(argv)
    cursors = None
    if args.cursors:
        cursors = {int(k): int(v)
                   for k, v in json.loads(args.cursors).items()}
    serve(args.wal_dir, args.chunks, args.manifest, args.replicas,
          device=args.device, size=args.size,
          num_requests=args.num_requests, recover=args.recover,
          cursors=cursors, timing_path=args.timing,
          counts_path=args.counts)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
