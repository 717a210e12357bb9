#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure exits non-zero before the result line:

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: every CUDA source under paddle_tpu_torch/csrc/, one nvcc each,
   all started together, into build/paddle_tpu_torch/.
3. Kernels against their plain PyTorch versions on the card, with
   timings, the card's bound and, where one PyTorch call computes the
   same function, its time:
   a. paged attention at the serving path's shapes (Llama-0.76B
      attention: 16 heads of 128, pages of 16, rows up to 2048 tokens),
      the serving path's f32 q over bf16 pages first, through each path
      of the kernel (``paged_cases``): decode rows split across blocks
      and merged, one 2048-token row, lengths at a page's and a
      partition's edge, a chunk's rows tiled, tiles across slot
      boundaries, padding rows on the null table, GQA and int8 pages;
      the decode and chunk cases timed beside their bounds;
   b. flash attention forward (K1), dQ (K2) and dK/dV (K3) at GPT-3
      1.3B's training shape (B 8, H 16, S 1024, D 128, causal; q/k/v
      strided views of one QKV projection) in bf16 (all three on tensor
      cores) and f32, and at Sq != Sk, S = 1000, key padding with an
      empty batch row (f32 and bf16), dropout, D 32 (f32 and bf16) and D
      64; each output held elementwise and by its norm (``FLASH_TOL``),
      and at gpt13 bf16 the same check must reject the plain versions run
      at a scale 1% off; a bf16 input whose sequence stride is off 16
      bytes must be refused with ValueError before any launch; SDPA's
      forward and backward time the library, and each timed kernel's
      factor against it is printed beside its share of the bound;
   c. fused AdamW (K5) at N = 10,000 (step 5), 2,000,000 (step 10), an
      odd N off 16-byte alignment (step 1, zero moments) and 354,942,976
      (step 10, timed): w', m', v' held elementwise (``ADAMW_TOL``) and
      the update w - w' at rtol 1e-5; the same check must reject the
      plain version run with Paddle AdamW's epsilon (eps / sqrt(bc2));
      PyTorch's fused AdamW times the library.
4. Serve: Llama-0.76B (vocab 32000, hidden 2048, 12 layers, 16 heads,
   intermediate 5632) with seeded random weights cast by
   ``amp.decorate(level="O2")``'s rule (bf16, the norms f32, so the
   activations f32 from the first layer on, as the JAX package serves
   it), bf16 KV pages, 8 requests of 64-1024 prompt tokens and 64 new
   tokens through ServingEngine, twice: with the step captured as a CUDA
   graph per token-grid bucket and replayed (the default), then eagerly.
   The streams must be equal, ``compile_counts()`` step == step_buckets,
   and K4's counts, zeroed just before each run and read just after,
   must show it in every layer of every step (eager: one launch a layer
   a step; graphed: one replayed launch a layer a step, plus one
   warm-up launch and one captured call a layer per bucket), the plain
   version never. Each run prints its decode-step p50, tokens/s, TTFT
   p50, capture seconds per bucket and peak memory.
5. Serve checks: one mixed step (3 decode rows + a 256-token chunk) run
   with the kernel and with the plain version on the same inputs, on the
   served model (held per layer) and on the same model in f32 (held per
   layer and at the logits). Serve features: Llama-0.76B on int8 pages
   with the prefix cache and ``spec_k=4``, 8 requests sharing a
   512-token prefix (suffixes of 64-512 tokens, two ending in a repeated
   n-gram; the first served alone until its prompt is cached), graphed
   and eagerly: equal streams, K4's counts as above, prefix hits and
   accepted drafts > 0, the pool's bytes beside bf16 pages'; then one
   step of three slots on the cached prefix pages with four drafts each,
   K4 held per layer against its plain version and, at the first layer,
   replayed from a CUDA graph and held the same way; a fork of one slot
   copies its last page (codes and scale rows) on the card; then every
   page must come back once the cache is cleared. Serve tenancy
   (``tools/serve_tenancy.py``'s traffic): Llama-0.76B on bf16 pages with
   the prefix cache, ``spec_k=4``, three rank-4 LoRA adapters (capacity
   4), a JSON-schema grammar over ``ToyTokenizer(32000, eos)`` and the
   host page tier, the pool holding the worst case of 5 of the 8 slots'
   streams (181 pages); 6 requests at priority 2, then 6 at priority 0
   four steps later (4 base, 5 on adapters, 3 constrained, one of them on
   an adapter; two at t = 0.8; one base request sharing an adapter
   request's first 256 tokens), adapter ``a2`` re-registered with new
   weights at step 10; graphed and eagerly: equal streams, one capture
   per bucket and the same graphs replayed after the swap, ``a2``'s
   streams unlike a run without the swap, every constrained stream
   valid, parks and auto-unparks with no late prefetch, K4's counts as
   above; the LoRA products timed from a graph replay at 8 and 64 rows;
   one mixed step with three adapters registered and every row on slot
   0 equal (``torch.equal``) to the same step over an empty store; an
   explicit park/unpark of a live stream giving back every layer's k/v
   bytes through its new block table (twice, timed per page); the pool
   empty once the cache is cleared; prints decode p50, park and unpark
   ms per page, cross-adapter prefix hits, drafts cut by the grammar,
   peak memory. Reference: a small f32 model served on the card
   (graphed, prefix cache, ``spec_k=2``) and on the CPU (plain path, both
   off) gives the same token streams, one request on a LoRA adapter and
   one under a grammar among them.
6. Train: GPT-3 1.3B (vocab 50304, hidden 2048, 24 layers, 16 heads)
   through ``paddle_tpu_torch.bench`` (B 8, S 1024, O2 bf16 without
   master weights, fused cross entropy, AdamW), 8 steps (1 + 2 warm + 5
   timed), every loss finite. The flash counts are zeroed just before
   and read just after: each of K1, K2 and K3 launched 24 times a step,
   the plain versions never.
7. Train check: a small f32 GPT (2 layers, hidden 256, 2 heads of 128,
   S 512) takes three AdamW steps on the card (kernels) and on the CPU
   (plain versions): the losses and the parameters agree.
8. K5's path: ``paddle_tpu_torch.tools.bench_adamw`` (K5 against
   PyTorch's fused AdamW at 2,000,000 elements, then both timed at
   354,942,976). K5's counts are zeroed just before and read just after:
   it launched, its plain version never.
9. Train Llama-0.76B (vocab 32000, hidden 2048, 12 layers, 16 heads)
   through ``paddle_tpu_torch.bench --model llama`` (B 8, S 1024, full
   recompute, O2 bf16 with master weights, fused cross entropy, AdamW), 8
   steps, every loss finite. K1 launched 24 times a step (forward and
   recomputation), K2 and K3 12 times each, the plain versions never.
10. Train check: a small f32 Llama with GQA (2 layers, hidden 256, 4
   heads of 64 over 2 KV heads, S 512, recompute on) takes three AdamW
   steps on the card and on the CPU: the losses and parameters agree.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor-core bf16; f32 FMA


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


# ───────────────────────────── timing and bounds ─────────────────────────────


def cuda_ms(torch, fn, launches=20, rounds=5):
    """Median over ``rounds`` of the mean device time of ``launches``
    back-to-back calls, timed with CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return statistics.median(per)


def graph_ms(torch, fn, launches=20, rounds=5):
    """Median over ``rounds`` of the mean device time of ``launches``
    calls captured in one CUDA graph and replayed: the card's time for
    the calls without the host's time to issue them (which exceeds the
    device time of a call of a few microseconds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(per)


def paged_bound(torch, q, k_pool, bt, lens, scales):
    """Least time for one ragged paged-attention call on these inputs:
    the larger of (bytes it must move / memory rate) and (its multiply-
    adds / peak rate of its type). Bytes: every KV page the rows' lengths
    reach (once, however many rows share it) with its scales, the block
    table entries read, the lengths, q and the output. Operations: 2 per
    multiply-add of q.k and p.v over each row's keys and heads."""
    T, nh, hd = q.shape
    page, nkv = k_pool.shape[1], k_pool.shape[2]
    lens_h = lens.cpu().tolist()
    bt_h = bt.cpu().tolist()
    pages, table_entries = set(), 0
    for row, n in zip(bt_h, lens_h):
        need = -(-n // page)
        pages.update(row[:need])
        table_entries += need
    kv = 2 * len(pages) * page * nkv * hd * k_pool.element_size()
    if scales:
        kv += 2 * len(pages) * page * nkv * 4
    nbytes = kv + 4 * table_entries + 4 * T + 2 * q.numel() * q.element_size()
    ops = 4.0 * sum(lens_h) * nh * hd
    kind = ("bf16" if q.dtype == torch.bfloat16
            and k_pool.dtype == torch.bfloat16 else "f32")
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ───────────────────────────── phases ─────────────────────────────


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"nvidia-smi: {card}")
    return name, card


def phase_build():
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {len(secs)} source(s) in {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    for n in secs:
        log_path = _build.library_path(n).with_suffix(".log")
        if not log_path.exists():
            continue
        kernel = "?"
        for line in log_path.read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"  ptxas[{n}] {kernel}: "
                    f"{line.replace('ptxas info    :', '').strip()}")


def kernel_label(mangled):
    """``flash_fwd_bf16_kernel<128>`` from a mangled kernel name: its
    length-prefixed names read in order up to the one that ends in
    ``kernel``, then its template arguments (``f`` f32,
    ``13__nv_bfloat16`` bf16, ``a`` int8, ``Li128E`` an int, ``S0_`` or
    ``S1_``, a back-reference, the bf16 named before it)."""
    import re

    pos = len("_ZN") if mangled.startswith("_ZN") else len("_Z")
    while (n := re.match(r"\d+", mangled[pos:])) is not None:
        pos += n.end()
        name = mangled[pos:pos + int(n.group())]
        pos += len(name)
        if not name.endswith("kernel"):
            continue
        args = re.match(r"I(.*?)E+v", mangled[pos:])
        if args is None:
            return name
        kinds = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16"}
        return name + "<" + ", ".join(
            t.group(1) or kinds.get(t.group(0), "bf16") for t in re.finditer(
                r"Li(\d+)E?|13__nv_bfloat16|S\d*_|f|a", args.group(1))) + ">"
    return mangled


def _pool(torch, gen, shape, dtype, dev):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def make_case(torch, dev, *, q_lens, starts, nh, nkv, q_dtype, kv_dtype,
              hd=128, page=16, pages_per_seq=128, null_rows=0, seed=0):
    """Inputs of one ragged call: slot i contributes q_lens[i] rows at
    positions starts[i].. over its own pages, then ``null_rows`` padding
    rows on the null table (page 0) at position 0, as the engine lays
    them out."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_slots = len(q_lens)
    num_pages = n_slots * pages_per_seq + 1
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    slot_bt = perm.view(n_slots, pages_per_seq).to(torch.int32)
    reps = torch.tensor(q_lens, device=dev)
    bt = slot_bt.repeat_interleave(reps, dim=0)
    lens = torch.cat([torch.arange(s, s + n, device=dev) + 1
                      for s, n in zip(starts, q_lens)]).to(torch.int32)
    if null_rows:
        bt = torch.cat([bt, torch.zeros((null_rows, pages_per_seq),
                                        dtype=torch.int32, device=dev)])
        lens = torch.cat([lens, torch.ones(null_rows, dtype=torch.int32,
                                           device=dev)])
    bt = bt.contiguous()
    T = int(lens.numel())
    q = torch.randn((T, nh, hd), generator=gen, device=dev).to(q_dtype)
    shape = (num_pages, page, nkv, hd)
    k = _pool(torch, gen, shape, kv_dtype, dev)
    v = _pool(torch, gen, shape, kv_dtype, dev)
    ks = vs = None
    if kv_dtype == torch.int8:
        ks = torch.rand(shape[:3], generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand(shape[:3], generator=gen, device=dev) * 0.02 + 1e-3
    return q, k, v, bt, lens, ks, vs


def paged_cases(torch, pa):
    """Phase 3a's cases: (name, make_case arguments, tolerance, timed).
    The serving path's shapes (Llama-0.76B: 16 heads of 128, pages of
    16, tables of 128 pages), through every path of the kernel: rows
    split across blocks with a merge (decode), rows tiled per chunk (no
    split), tiles that cross a slot boundary, padding rows."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    decode_lens = [2048, 1, 731, 1500, 64, 1999, 17, 1024]
    decode = dict(q_lens=[1] * 8, starts=[n - 1 for n in decode_lens])
    chunk = dict(q_lens=[1, 1, 1, 256], starts=[900, 2047, 33, 1500])
    # four decode rows: 1 key, a page, a partition, a partition + 1
    part = pa.launch_plan(4, 16, 16, 16, 128).part_pages * 16
    edges = dict(q_lens=[1] * 4, starts=[0, 15, part - 1, part])
    serve = dict(nh=16, nkv=16, q_dtype=f32, kv_dtype=bf16)
    return [
        # the serving path's pairing: f32 q (rope'd by f32 tables) over
        # bf16 pages; both versions widen the pages and compute in f32
        ("a_decode_f32q_bf16kv", dict(decode, **serve), 5e-5, True),
        ("a_decode_f32", dict(decode, nh=16, nkv=16, q_dtype=f32,
                              kv_dtype=f32), 5e-5, True),
        ("a_decode_bf16", dict(decode, nh=16, nkv=16, q_dtype=bf16,
                               kv_dtype=bf16), 2e-2, True),
        ("b_chunk_bf16", dict(chunk, nh=16, nkv=16, q_dtype=bf16,
                              kv_dtype=bf16), 2e-2, True),
        ("c_gqa_bf16", dict(decode, nh=32, nkv=8, q_dtype=bf16,
                            kv_dtype=bf16), 2e-2, False),
        ("d_int8_pages", dict(decode, nh=16, nkv=16, q_dtype=f32,
                              kv_dtype=i8), 5e-5, False),
        ("e_one_row_2048", dict(q_lens=[1], starts=[2047], **serve), 5e-5,
         True),
        ("f_edges", dict(edges, **serve), 5e-5, False),
        ("g_chunk_cross_slots", dict(q_lens=[5, 20, 1], starts=[700, 1200, 40],
                                     **serve), 5e-5, False),
        ("h_padding_rows", dict(q_lens=[1, 1, 1], starts=[300, 5, 1100],
                                null_rows=13, **serve), 5e-5, False),
        ("i_gqa_int8_split", dict(q_lens=[1, 1], starts=[2047, 600], nh=32,
                                  nkv=8, q_dtype=f32, kv_dtype=i8), 5e-5,
         False),
        ("j_chunk_f32q", dict(chunk, **serve), 5e-5, False),
    ]


def phase_paged_kernels(torch):
    from paddle_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    results = {}
    for name, kw, tol, timed in paged_cases(torch, pa):
        q, k, v, bt, lens, ks, vs = make_case(torch, dev, **kw)
        plan = pa.launch_plan(q.shape[0], q.shape[1], k.shape[2], k.shape[1],
                              bt.shape[1])
        got = pa.paged_attention(q, k, v, bt, lens, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        want = pa.ref_paged_attention(q, k, v, bt, lens, k_scale=ks,
                                      v_scale=vs)
        err = (got.float() - want.float()).abs()
        max_err = float(err.max())
        ok = bool((err <= tol + tol * want.float().abs()).all())
        line = (f"kernel {name}: T={q.shape[0]} nh={q.shape[1]} "
                f"nkv={k.shape[2]} {k.dtype} pages, plan n_split="
                f"{plan.n_split} part_pages={plan.part_pages} rows_per_tile="
                f"{plan.rows_per_tile}; max_abs_err={max_err:.3e} "
                f"(atol=rtol={tol:g}) {'ok' if ok else 'MISMATCH'}")
        rec = {"max_abs_err": max_err}
        if timed:
            def call():
                return pa.paged_attention(q, k, v, bt, lens, k_scale=ks,
                                          v_scale=vs)
            # the kernel's time: calls replayed from a CUDA graph; beside
            # it the eager calls' time, which includes the host's time to
            # issue each call where that is the longer
            ms = graph_ms(torch, call)
            eager_ms = cuda_ms(torch, call)
            plain_ms = cuda_ms(torch, lambda: pa.ref_paged_attention(
                q, k, v, bt, lens, k_scale=ks, v_scale=vs),
                launches=2, rounds=3)
            bound_ms, bound_by = paged_bound(torch, q, k, bt, lens,
                                             ks is not None)
            rec.update(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            line += (f" | kernel {ms:.4f} ms (eager calls {eager_ms:.4f} "
                     f"ms), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}), {bound_ms / ms:.1%} of bound")
        log(line)
        if not ok:
            fail(f"kernel case {name} disagrees with its plain version")
        results[name] = rec
    return results


# ───────────────────────────── flash attention ─────────────────────────────


def flash_pairs(torch, B, sq, sk, causal, kpad):
    """(q, k) pairs the masks leave valid, over the batch, per head: the
    work a flash kernel needs on these inputs."""
    ok = torch.ones((sq, sk), dtype=torch.bool, device="cuda")
    if causal:
        ok = ok.tril(sk - sq)
    if kpad is None:
        return B * int(ok.sum())
    return int((ok[None] & (kpad[:, None, :] > 0.5)).sum())


def flash_bounds(torch, q, k, causal, kpad):
    """Least time of K1, K2 and K3 on these inputs: the larger of (bytes
    each must move / memory rate) and (its flops / the peak rate of its
    type). Bytes: each input read once, each output written once (K1: q,
    k, v, kpad in; O, LSE out. K2: q, k, v, dO, LSE, Delta, kpad in; dQ
    out. K3: the same in; dK, dV out). Flops per valid (q, k) pair and
    head: K1 4 D (q.k and p.v), K2 6 D (q.k, dO.v, dS.k), K3 8 D (q.k,
    dO.v, p^T.dO, dS^T.q)."""
    B, sq, H, D = q.shape
    sk = k.shape[1]
    e = q.element_size()
    qb, kb = B * sq * H * D * e, B * sk * H * D * e
    rows = 4 * B * H * sq
    kp = 4 * B * sk if kpad is not None else 0
    pairs = H * flash_pairs(torch, B, sq, sk, causal, kpad)
    kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
    out = {}
    for name, nbytes, flops in (
            ("flash_fwd", 2 * qb + 2 * kb + kp + rows, 4 * D * pairs),
            ("flash_dq", 3 * qb + 2 * kb + kp + 2 * rows, 6 * D * pairs),
            ("flash_dkv", 2 * qb + 4 * kb + kp + 2 * rows, 8 * D * pairs)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_OPS[kind]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def flash_case(torch, gen, B, sq, sk, H, D, dtype, kpad_rows=False):
    """q as a strided [B, Sq, H, D] view of a [B, Sq, 3, H, D] QKV
    tensor (GPT's layout), k and v the same at Sk, dO contiguous."""
    dev = "cuda"
    qkv = torch.randn((B, sq, 3, H, D), generator=gen, device=dev).to(dtype)
    kvx = torch.randn((B, sk, 3, H, D), generator=gen, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], kvx[:, :, 1], kvx[:, :, 2]
    do = torch.randn((B, sq, H, D), generator=gen, device=dev).to(dtype)
    kpad = None
    if kpad_rows:
        kpad = torch.ones((B, sk), device=dev)
        kpad[0, sk // 2:] = 0.0
        kpad[-1] = 0.0  # the last batch row keeps no key
    return q, k, v, do, kpad


# (atol, rtol, norm-relative) of the flash checks. bf16: the kernels and
# the plain versions round p and dS to bf16 at the same points, so an
# element may land at most a bf16 ulp (2^-8..2^-7 of its size) apart;
# rtol 2^-6 allows two, atol 2e-3 the elements near zero, and the whole
# tensor's error must stay within 5e-3 of its norm.
FLASH_TOL = {"f32": (5e-5, 5e-5, 1e-5), "bf16": (2e-3, 2.0 ** -6, 5e-3)}


def held(torch, got, want, tol):
    """``(ok, max abs err, norm-relative err)`` of ``got`` against
    ``want``: every element within ``atol + rtol |want|`` and
    ``||got - want|| / ||want||`` within ``rel``."""
    atol, rtol, rel = tol
    want = want.float()
    err = (got.float() - want).abs()
    rel_err = float(torch.linalg.vector_norm(err)
                    / torch.linalg.vector_norm(want).clamp_min(1e-30))
    ok = bool((err <= atol + rtol * want.abs()).all()) and rel_err <= rel
    return ok, float(err.max()), rel_err


def flash_plain(fa, q, k, v, do, causal, scale, drop, seed, kpad):
    """The plain versions' O, LSE, dQ, dK, dV on these inputs, the
    backward from their own forward's LSE and Delta."""
    pargs = (causal, scale, drop, seed, kpad)
    o, lse = fa.ref_flash_fwd(q, k, v, *pargs)
    delta = fa.flash_delta(o, do)
    bargs = (q, k, v, do, lse, delta) + pargs
    return (o, lse, fa.ref_flash_dq(*bargs), *fa.ref_flash_dkv(*bargs))


def flash_controls(torch, fa, got, q, k, v, do, kw, tol):
    """The bf16 check's reach, on gpt13's kernel outputs ``got`` (O, LSE,
    dQ, dK, dV): against the plain versions with the scale 1% off (what a
    kernel with a wrong constant would give), which the check must
    reject, and against the plain versions on f32 copies of the inputs
    (p, dS and the outputs unrounded), which it reports."""
    scale = kw["scale"]
    drop, seed, kpad = (kw["dropout_p"], kw["dropout_seed"],
                        kw["key_padding_mask"])
    f32 = [t.float() for t in (q, k, v, do)]
    out = {}
    for label, want in (
            ("scale_1pct_off", flash_plain(fa, q, k, v, do, kw["causal"],
                                           scale * 1.01, drop, seed, kpad)),
            ("f32_p", flash_plain(fa, *f32, kw["causal"], scale, drop, seed,
                                  kpad))):
        res = {n: held(torch, g, w, tol) for n, g, w in
               zip(("o", "lse", "dq", "dk", "dv"), got, want)}
        out[label] = res
        log(f"  control {label}: " + ", ".join(
            f"{n} {'passes' if ok else 'rejected'} (max {m:.2e}, rel "
            f"{r:.2e})" for n, (ok, m, r) in res.items()))
    if all(ok for ok, _m, _r in out["scale_1pct_off"].values()):
        fail("flash check: a 1% scale error passes the bf16 tolerance")
    return out


def phase_flash_kernels(torch):
    """K1, K2 and K3 against their plain versions on the same inputs,
    per case: O, LSE, dQ, dK, dV, each held elementwise and by its norm at
    ``FLASH_TOL``. The gpt13 cases are timed; the bf16 one also reads the
    check's reach (``flash_controls``)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [
        # name, B, Sq, Sk, H, D, dtype, causal, kpad, dropout, timed
        ("gpt13_bf16", 8, 1024, 1024, 16, 128, bf16, True, False, 0.0, True),
        ("gpt13_f32", 8, 1024, 1024, 16, 128, f32, True, False, 0.0, True),
        ("sq256_sk1024_bf16", 2, 256, 1024, 16, 128, bf16, True, False, 0.0,
         False),
        ("s1000_bf16", 2, 1000, 1000, 16, 128, bf16, True, False, 0.0, False),
        ("kpad_f32", 3, 512, 512, 4, 128, f32, False, True, 0.0, False),
        ("dropout_bf16", 2, 1024, 1024, 4, 128, bf16, True, False, 0.1,
         False),
        ("d32_f32", 2, 300, 300, 8, 32, f32, True, False, 0.0, False),
        ("d32_bf16", 2, 300, 300, 8, 32, bf16, True, False, 0.0, False),
        ("d64_bf16", 2, 512, 512, 8, 64, bf16, True, False, 0.0, False),
        ("kpad_bf16", 3, 512, 512, 4, 128, bf16, False, True, 0.0, False),
    ]
    results = {}
    for (name, B, sq, sk, H, D, dt, causal, kp, drop, timed) in cases:
        q, k, v, do, kpad = flash_case(torch, gen, B, sq, sk, H, D, dt, kp)
        kw = dict(causal=causal, scale=D ** -0.5, dropout_p=drop,
                  dropout_seed=4321 if drop else 0, key_padding_mask=kpad)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        delta = fa.flash_delta(o, do)
        dq = fa.flash_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        pargs = (causal, D ** -0.5, drop, kw["dropout_seed"], kpad)
        o_r, lse_r = fa.ref_flash_fwd(q, k, v, *pargs)
        bargs = (q, k, v, do, lse, delta) + pargs
        dq_r = fa.ref_flash_dq(*bargs)
        dk_r, dv_r = fa.ref_flash_dkv(*bargs)
        tol = FLASH_TOL["f32" if dt == f32 else "bf16"]
        errs, rels, ok = {}, {}, True
        for label, got, want in (("o", o, o_r), ("lse", lse, lse_r),
                                 ("dq", dq, dq_r), ("dk", dk, dk_r),
                                 ("dv", dv, dv_r)):
            good, errs[label], rels[label] = held(torch, got, want, tol)
            ok &= good
        rec = {"max_abs_err": {"flash_fwd": max(errs["o"], errs["lse"]),
                               "flash_dq": errs["dq"],
                               "flash_dkv": max(errs["dk"], errs["dv"])},
               "rel_err": rels}
        line = (f"flash {name}: B={B} Sq={sq} Sk={sk} H={H} D={D} "
                f"causal={causal} kpad={kp} dropout={drop} max_abs_err "
                + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
                + " rel " + " ".join(f"{n}={e:.2e}" for n, e in rels.items())
                + f" (atol {tol[0]:g}, rtol {tol[1]:g}, rel {tol[2]:g}) "
                + ("ok" if ok else "MISMATCH"))
        log(line)
        if not ok:
            fail(f"flash case {name}: a kernel disagrees with its plain "
                 "version")
        if name == "gpt13_bf16":
            rec["controls"] = flash_controls(
                torch, fa, (o, lse, dq, dk, dv), q, k, v, do, kw, tol)
        if timed:
            rec.update(time_flash(torch, fa, q, k, v, do, o, lse, delta, kw,
                                  pargs))
            bounds = flash_bounds(torch, q, k, causal, kpad)
            for kname in fa.KERNELS:
                r = rec[kname]
                r["bound_ms"], r["bound_by"] = bounds[kname]
                log(f"  {kname}: kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of "
                    f"bound; SDPA {r['library_ms']:.4f} ms "
                    f"({r['library_of']}), kernel "
                    f"{r['ms'] / r['library_ms']:.2f}x SDPA")
        results[name] = rec
        del q, k, v, do, o, lse, delta, dq, dk, dv, o_r, lse_r, dq_r, dk_r
        del dv_r
        torch.cuda.empty_cache()
    flash_refuses_misaligned(torch, fa)
    return results


def flash_refuses_misaligned(torch, fa):
    """A bf16 q whose sequence stride (132 elements, 264 bytes) is off 16
    bytes: K1's, K2's and K3's wrappers must raise ValueError before any
    launch."""
    B, S, H, D = 1, 64, 2, 64
    gen = torch.Generator(device="cuda").manual_seed(6)
    base = torch.randn((B, S, H * D + 4), generator=gen, device="cuda").to(
        torch.bfloat16)
    q = base.as_strided((B, S, H, D), (S * (H * D + 4), H * D + 4, D, 1))
    k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    lse = torch.zeros((B * H, S), device="cuda")
    before = dict(fa.kernel_launches)
    refused = []
    for kname, call in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, causal=True)),
            ("flash_dq", lambda: fa.flash_dq(q, k, v, do, lse, lse,
                                             causal=True)),
            ("flash_dkv", lambda: fa.flash_dkv(q, k, v, do, lse, lse,
                                               causal=True))):
        try:
            call()
        except ValueError as e:
            refused.append(kname)
            msg = str(e)
    torch.cuda.synchronize()
    ok = (refused == ["flash_fwd", "flash_dq", "flash_dkv"]
          and fa.kernel_launches == before)
    log(f"flash misaligned bf16 q (sequence stride {q.stride(1) * 2} bytes): "
        f"refused by {refused}, launches {fa.kernel_launches} "
        f"{'ok' if ok else 'NOT REFUSED'}" + (f" ({msg})" if refused else ""))
    if not ok:
        fail("flash wrappers took a bf16 input off 16-byte alignment")


def time_flash(torch, fa, q, k, v, do, o, lse, delta, kw, pargs):
    """Device ms of each kernel, its plain version, and SDPA's forward
    and backward (one call each: the library's flash attention on the
    same q, k, v, dO; its backward computes dQ, dK and dV together)."""
    F = torch.nn.functional
    bargs = (q, k, v, do, lse, delta) + pargs
    out = {
        "flash_fwd": dict(
            ms=cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw)),
            plain_ms=cuda_ms(torch, lambda: fa.ref_flash_fwd(q, k, v, *pargs),
                             launches=2, rounds=3)),
        "flash_dq": dict(
            ms=cuda_ms(torch, lambda: fa.flash_dq(q, k, v, do, lse, delta,
                                                  **kw)),
            plain_ms=cuda_ms(torch, lambda: fa.ref_flash_dq(*bargs),
                             launches=2, rounds=3)),
        "flash_dkv": dict(
            ms=cuda_ms(torch, lambda: fa.flash_dkv(q, k, v, do, lse, delta,
                                                   **kw)),
            plain_ms=cuda_ms(torch, lambda: fa.ref_flash_dkv(*bargs),
                             launches=2, rounds=3)),
    }
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2)
    causal = kw["causal"]
    fwd_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal))
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        oh, (qh, kh, vh), doh, retain_graph=True))
    out["flash_fwd"].update(library_ms=fwd_ms, library_of="forward")
    for kname in ("flash_dq", "flash_dkv"):
        out[kname].update(library_ms=bwd_ms,
                          library_of="backward, dQ+dK+dV in one call")
    return out


# ───────────────────────────── fused AdamW ─────────────────────────────

# (atol, rtol) on w', m', v' (the JAX package's tolerance between its
# kernel and its XLA form) and rtol on the update w - w': the kernel runs
# the plain version's f32 operations in its order, each rounded once, so
# the two agree to the bit; a wrong constant or formula moves the update
# of every element with a small v by far more than 1e-5 of itself.
ADAMW_TOL = (1e-7, 1e-6)
ADAMW_UPDATE_RTOL = 1e-5
ADAMW_FLOPS = 16  # per element: m' 3, v' 4, the Adam term 5, w' 4


def adamw_held(torch, w, got, want):
    """``(ok, max abs err over w', m', v', max relative err of the
    update)`` of ``got`` against ``want`` on inputs with weights ``w``."""
    atol, rtol = ADAMW_TOL
    ok, max_err = True, 0.0
    for a, b in zip(got, want):
        err = (a - b).abs()
        max_err = max(max_err, float(err.max()))
        ok &= bool((err <= atol + rtol * b.abs()).all())
    du_got, du_want = w - got[0], w - want[0]
    du_err = (du_got - du_want).abs()
    ok &= bool((du_err <= ADAMW_UPDATE_RTOL * du_want.abs()).all())
    rel = float((du_err / du_want.abs().clamp_min(1e-30)).max())
    return ok, max_err, rel


def phase_adamw_kernels(torch):
    """K5 against its plain version on the same inputs (w normal, g 1e-3
    x normal, moments zero or warm), a control that must be rejected, and
    at the bench's size the kernel, plain and library times."""
    from paddle_tpu_torch.ops import fused_adamw as k5
    from paddle_tpu_torch.tools.bench_adamw import N_TIMED, library_adamw

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [
        # name, N, step, lr, warm moments, offset (1: not 16-byte aligned)
        ("n10000_step5", 10_000, 5, 1e-3, False, 0),
        ("n2m_step10", 2_000_000, 10, 1e-4, True, 0),
        ("odd_unaligned_step1", 1_000_003, 1, 1e-3, False, 1),
        ("n355m_step10", N_TIMED, 10, 1e-4, True, 0),
    ]
    results = {}
    for name, n, step, lr, warm, off in cases:
        def vec(scale):
            return (torch.randn(n + off, generator=gen, device="cuda")
                    * scale)[off:]
        w, g = vec(1.0), vec(1e-3)
        m, v = ((vec(1e-4), vec(1e-3).square()) if warm
                else (torch.zeros_like(w), torch.zeros_like(w)))
        got = k5.fused_adamw_flat(w, m, v, g, lr, step)
        torch.cuda.synchronize()
        want = k5.ref_adamw_flat(w, m, v, g, lr, step)
        ok, max_err, du_rel = adamw_held(torch, w, got, want)
        bc2 = 1.0 - 0.999 ** step
        paddle_eps = k5.ref_adamw_flat(w, m, v, g, lr, step,
                                       eps=1e-8 / math.sqrt(bc2))
        c_ok, _c_err, c_rel = adamw_held(torch, w, got, paddle_eps)
        line = (f"adamw {name}: N={n} step={step} lr={lr:g} max_abs_err "
                f"{max_err:.2e}, update max rel err {du_rel:.2e} (atol "
                f"{ADAMW_TOL[0]:g}, rtol {ADAMW_TOL[1]:g}; update rtol "
                f"{ADAMW_UPDATE_RTOL:g}) {'ok' if ok else 'MISMATCH'}; "
                f"control paddle_eps {'passes' if c_ok else 'rejected'} "
                f"(update rel {c_rel:.2e})")
        log(line)
        if not ok:
            fail(f"adamw case {name}: the kernel disagrees with its plain "
                 "version")
        if c_ok:
            fail(f"adamw case {name}: Paddle's epsilon passes the check")
        rec = {"max_abs_err": max_err, "update_rel_err": du_rel,
               "control_update_rel_err": c_rel}
        del got, want, paddle_eps
        if name == "n355m_step10":
            rec["ms"] = cuda_ms(torch, lambda: k5.fused_adamw_flat(
                w, m, v, g, lr, step))
            rec["plain_ms"] = cuda_ms(torch, lambda: k5.ref_adamw_flat(
                w, m, v, g, lr, step), launches=2, rounds=3)
            opt, _p = library_adamw(w.clone(), m.clone(), v.clone(), g, lr,
                                    step)
            rec["library_ms"] = cuda_ms(torch, opt.step)
            del opt, _p
            t_bytes = 28 * n / HBM_BYTES_PER_S
            t_ops = ADAMW_FLOPS * n / PEAK_OPS["f32"]
            rec["bound_ms"] = 1e3 * max(t_bytes, t_ops)
            rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            log(f"  fused_adamw: kernel {rec['ms']:.4f} ms, plain "
                f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}), {rec['bound_ms'] / rec['ms']:.1%} of "
                f"bound; torch fused AdamW {rec['library_ms']:.4f} ms")
        results[name] = rec
        del w, m, v, g
        torch.cuda.empty_cache()
    return results


def llama_076b():
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=12,
                       num_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048)


def serve_traffic(torch, engine, requests, first_alone=None):
    """Serve ``requests`` (``(prompt, temperature, seed, max_new)``) to
    completion through ``engine.step``, with K4's counts zeroed just
    before and read just after and the peak memory reset. With
    ``first_alone`` (a callable) the first request is served alone to
    completion (its prompt's full pages are then in the prefix cache),
    ``first_alone(prompt, output)`` is called, and then the rest are
    submitted. Returns the outputs in request order and the run's
    record."""
    from paddle_tpu_torch.ops import paged_attention as pa

    first_token, rids, steps = {}, [], []

    def stream_cb(rid, token, finished):
        if token is not None and rid not in first_token:
            first_token[rid] = time.perf_counter()

    def submit(prompt, temp, seed, max_new):
        rids.append(engine.add_request(prompt, max_new_tokens=max_new,
                                       temperature=temp, eos_token_id=2,
                                       seed=seed, stream_cb=stream_cb))

    def step():
        ts = time.perf_counter()
        engine.step()
        steps.append((engine.stats["step_decode_tokens"],
                      engine.stats["step_prefill_tokens"],
                      time.perf_counter() - ts))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    steps_before = engine.stats["steps"]
    pa.reset_counters()
    t_start = time.perf_counter()
    later, outs = requests, {}
    if first_alone is not None:
        submit(*requests[0])
        later = requests[1:]
        while engine.has_work:
            step()
        outs.update(engine.take_outputs())
        first_alone(requests[0][0], outs[rids[0]])
    for r in later:
        submit(*r)
    while engine.has_work:
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = {"kernel_launches": pa.kernel_launches,
              "captured_launches": pa.captured_launches,
              "replayed_launches": pa.replayed_launches,
              "plain_calls": pa.plain_calls}
    outs.update(engine.take_outputs())
    if set(outs) != set(rids):
        fail(f"served {len(outs)} of {len(rids)} requests")
    decode_ms = [1e3 * s for d, p, s in steps if p == 0 and d > 0]
    ttft = sorted(first_token[r] - t_start for r in rids)
    generated = sum(outs[r].n_gen for r in rids)
    record = {
        "step": "cuda_graph" if engine._graphed else "eager",
        "steps": engine.stats["steps"] - steps_before,
        "generated_tokens": generated,
        "prompt_tokens": int(sum(len(r[0]) for r in requests)),
        "wall_s": wall, "tokens_per_s": generated / wall,
        "decode_step_ms_p50": (statistics.median(decode_ms) if decode_ms
                               else None),
        "decode_steps": len(decode_ms),
        "ttft_s_p50": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "compile_counts": engine.compile_counts(),
        "capture_s_by_bucket": engine.capture_seconds(),
        # the peak, and what was allocated when the run began (weights,
        # pools, earlier engines still alive)
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "memory_before_gib": held_before / 2**30,
        **counts,
    }
    vocab = engine.model.config.vocab_size
    for (_p, _t, _s, new), r in zip(requests, rids):
        o = outs[r]
        if not (o.n_gen == new or (o.finish_reason == "stop"
                                   and o.token_ids[-1] == 2)):
            fail(f"request {r}: {o.n_gen} tokens, {o.finish_reason}")
        if not all(0 <= t < vocab for t in o.token_ids):
            fail(f"request {r}: token outside the vocabulary")
    return [outs[r] for r in rids], record


def check_k4_counts(name, engine, record):
    """K4 went through the run's every step and its plain version never:
    eagerly one launch a layer a step; graphed one replayed launch a
    layer a step, and per bucket captured one call a layer after a
    warm-up of one launch a layer."""
    layers, steps = engine.n_layers, record["steps"]
    buckets = record["compile_counts"]["step"]
    if record["compile_counts"]["step"] != \
            record["compile_counts"]["step_buckets"]:
        fail(f"{name}: compile_counts {record['compile_counts']}: "
             "step != step_buckets")
    if engine._graphed:
        want = {"kernel_launches": layers * buckets,
                "captured_launches": layers * buckets,
                "replayed_launches": layers * steps, "plain_calls": 0}
    else:
        want = {"kernel_launches": layers * steps, "captured_launches": 0,
                "replayed_launches": 0, "plain_calls": 0}
    got = {k: record[k] for k in want}
    if got != want:
        fail(f"{name}: K4 counts {got} != {want} ({layers} layers, "
             f"{steps} steps, {buckets} buckets)")


def phase_serve(torch, card):
    """Llama-0.76B served twice on the same requests, through the graphed
    step (the default) and the eager one: the streams must be equal (both
    runs take the same buckets, so the same GEMM shapes)."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_076b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 1025, 8)
    requests = [(rng.integers(0, cfg.vocab_size, int(n)),
                 0.8 if i in (2, 5) else 0.0, 1000 + i, 64)
                for i, n in enumerate(lengths)]
    runs = {}
    for graphed in (True, False):
        engine = ServingEngine(model, page_size=16, max_batch_slots=8,
                               max_model_len=2048, token_budget=1024,
                               kv_dtype=torch.bfloat16, cuda_graph=graphed,
                               device="cuda")
        if graphed:
            log(f"serve: Llama-0.76B {n_params / 1e9:.3f} B params "
                f"({', '.join(dtypes)}: O2's rule, norms f32), intermediate "
                f"{cfg.intermediate_size}, pool {engine.pool.num_pages} "
                f"pages, set up in {time.perf_counter() - t0:.1f} s")
        outs, rec = serve_traffic(torch, engine, requests)
        rec["card"] = card
        log(f"serve ({rec['step']}): " + json.dumps(rec))
        check_k4_counts(f"serve ({rec['step']})", engine, rec)
        if engine.pool.used_pages != 0:
            fail(f"{engine.pool.used_pages} pages still in use after the run")
        runs[graphed] = (engine, [o.token_ids for o in outs], rec)
    (engine, graphed_streams, rec), (eager, eager_streams, _r) = (
        runs[True], runs[False])
    same = graphed_streams == eager_streams
    log(f"serve: graphed and eager streams {'identical' if same else 'DIFFER'}"
        f" over {len(requests)} requests")
    if not same:
        fail("serve: the graphed step's streams differ from the eager one's")
    del eager
    return engine, rec


def mixed_step(torch, engine, layer_tol):
    """Bring ``engine`` (idle) to one mixed step, 3 decode rows + a
    256-token chunk, and run that step twice on the same inputs. The first
    run's attention is the kernel, checked at every layer against the
    plain version called on the very same tensors; the second run's
    attention is the plain version throughout. Returns the largest
    per-layer error and the two runs' sample logits (live slots)."""
    import numpy as np

    from paddle_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(1)
    for n in (600, 90, 300):
        engine.add_request(rng.integers(0, 32000, n), max_new_tokens=4)
    engine.step()          # admits the three and prefills all 990 tokens
    engine.add_request(rng.integers(0, 32000, 256), max_new_tokens=2)
    for req in engine.scheduler.admit(1, engine.pool):
        engine._admit(req)
    batch = engine._plan()
    if batch.n_decode != 3 or batch.total != 259:
        fail(f"mixed step has {batch.n_decode} decode rows, "
             f"{batch.total} rows")
    layer_errs = []

    def checked(q, kp, vp, bt, lens, **kw):
        out = pa.ragged_paged_attention(q, kp, vp, bt, lens, **kw)
        ref = pa.ref_paged_attention(q, kp, vp, bt, lens, **kw).float()
        err = (out.float() - ref).abs()
        layer_errs.append(float(err.max()))
        if not bool((err <= layer_tol + layer_tol * ref.abs()).all()):
            fail(f"mixed step layer {len(layer_errs) - 1}: kernel and plain "
                 f"version disagree on the same inputs "
                 f"(max_abs_err {layer_errs[-1]:.3e})")
        return out

    live = [i for i, st in enumerate(engine.slots) if st is not None]
    logits = engine._forward(batch, attention=checked)
    plain = engine._forward(batch, attention=pa.ref_paged_attention)
    torch.cuda.synchronize()
    engine._land(batch, torch.argmax(logits, -1).cpu().numpy())
    engine.run()
    if engine.pool.used_pages != 0:
        fail("pages leaked after the mixed step")
    return max(layer_errs), logits[live], plain[live]


def phase_mixed_steps(torch, engine):
    """The mixed step on the served model (bf16 weights and pages, f32
    activations: the attention is f32 q over bf16 pages, computed in f32
    by both versions, so it is held per layer at the f32 tolerance), then
    on the same model in f32 (weights and pages). In the served model the
    two runs' logits may still part where a k or v sits at a bf16
    rounding midpoint as it is written to the pages, so its logit gap is
    reported; the f32 run, free of that rounding, holds the end-to-end
    logits too."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    layer_err, k_logits, p_logits = mixed_step(torch, engine, 5e-5)
    log(f"mixed step bf16 pages: 3 decode rows + 256 chunk rows; attention "
        f"kernel vs plain on the same inputs, max over 12 layers "
        f"{layer_err:.3e} (atol=rtol=5e-5) ok; sample logits gap "
        f"{float((k_logits - p_logits).abs().max()):.3e}")
    model = LlamaForCausalLM(llama_076b(), device="cuda", dtype=torch.float32,
                             seed=0)
    engine32 = ServingEngine(model, page_size=16, max_batch_slots=4,
                             max_model_len=2048, token_budget=1024,
                             kv_dtype=torch.float32, device="cuda")
    layer_err, k_logits, p_logits = mixed_step(torch, engine32, 5e-5)
    err = (k_logits - p_logits).abs()
    tol = 1e-3
    ok = bool((err <= tol + tol * p_logits.abs()).all())
    log(f"mixed step f32: attention per layer {layer_err:.3e} "
        f"(atol=rtol=5e-5) ok; sample logits kernel vs plain max_abs_err "
        f"{float(err.max()):.3e} (atol=rtol={tol:g}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("mixed-step f32 logits: kernel and plain version disagree")


def features_step(torch, engine, prefix, rng, layer_tol):
    """Bring the features engine (idle, its prefix cached) to one step of
    three decoding slots on the cached prefix pages, each with a burst of
    four drafts, over int8 pages the quantizing write filled, and run
    that step eagerly with K4 checked at every layer against its plain
    version on the same inputs; at the first layer the same K4 call is
    also captured in a CUDA graph and replayed, and held the same way.
    Then land the step's samples, fork one slot and make the fork's last
    written page its own (copy-on-write on the card: the page's codes
    and scale rows must arrive equal), and drain. Returns the largest
    per-layer error and the replay's."""
    import numpy as np

    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import sampling

    class Repeat:  # proposes the stream's last token k times
        def propose(self, ids, k):
            return np.full(k, ids[-1], np.int32)

    vocab = engine.model.config.vocab_size
    for n in (40, 100, 70):
        engine.add_request(np.concatenate([prefix, rng.integers(0, vocab, n)]),
                           max_new_tokens=12)
    while engine.scheduler.waiting or any(
            s is not None and s.prefilling for s in engine.slots):
        engine.step()
    drafter, engine.drafter = engine.drafter, Repeat()
    batch = engine._plan()
    engine.drafter = drafter
    live = [i for i, st in enumerate(engine.slots) if st is not None]
    shared = [engine.pool._ref[engine.pool.block_table(engine.slots[i].req
                                                       .req_id)[0]]
              for i in live]
    if batch.n_draft != 4 * len(live) or batch.total != 5 * len(live) \
            or min(shared) < 2:
        fail(f"features step: {batch.n_draft} drafts over {len(live)} slots, "
             f"{batch.total} rows, first-page refcounts {shared}")
    errs, replay = [], []

    def checked(q, kp, vp, bt, lens, **kw):
        out = pa.ragged_paged_attention(q, kp, vp, bt, lens, **kw)
        ref = pa.ref_paged_attention(q, kp, vp, bt, lens, **kw).float()
        err = (out.float() - ref).abs()
        errs.append(float(err.max()))
        if not bool((err <= layer_tol + layer_tol * ref.abs()).all()):
            fail(f"features step layer {len(errs) - 1}: kernel and plain "
                 f"version disagree (max_abs_err {errs[-1]:.3e})")
        if not replay:
            T, nh, hd = q.shape
            n = pa.workspace_numel(T, nh, kp.shape[2], hd, kp.shape[1],
                                   bt.shape[1])
            ws = torch.empty(max(n, 1), device=q.device)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                pa.ragged_paged_attention(q, kp, vp, bt, lens, workspace=ws,
                                          **kw)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = pa.ragged_paged_attention(q, kp, vp, bt, lens,
                                                workspace=ws, **kw)
            graph.replay()
            torch.cuda.synchronize()
            e = (got.float() - ref).abs()
            replay.append(float(e.max()))
            if not bool((e <= layer_tol + layer_tol * ref.abs()).all()):
                fail(f"features step: the replayed K4 call disagrees with "
                     f"its plain version (max_abs_err {replay[0]:.3e})")
        return out

    logits = engine._forward(batch, attention=checked)
    S = engine._spec_rows
    nxt = sampling.sample(
        logits, torch.from_numpy(np.repeat(batch.temps, S)).cuda(),
        torch.from_numpy(np.repeat(batch.seeds, S)).cuda(),
        torch.from_numpy(batch.sample_pos.reshape(-1)).cuda())
    engine._land(batch, nxt.cpu().numpy())
    pool = engine.pool
    rid = engine.slots[live[0]].req.req_id
    n = pool.seq_len(rid)
    pool.fork(rid, "cow-probe")
    pi = (n - 1) // pool.page_size
    pool.extend_write("cow-probe", n - 1, n)
    old, fresh = pool.block_table(rid)[pi], pool.block_table("cow-probe")[pi]
    every = pool.k_pools + pool.v_pools + pool.k_scales + pool.v_scales
    if old == fresh or not all(torch.equal(t[fresh], t[old]) for t in every):
        fail(f"features step: copy-on-write of page {old} into {fresh} did "
             "not copy its codes and scales")
    pool.free("cow-probe")
    log(f"features step: copy-on-write on the card copied page {old} into "
        f"{fresh} (codes and scale rows of {pool.num_layers} layers, equal)")
    engine.run()
    return max(errs), replay[0]


def phase_serve_features(torch, card):
    """Llama-0.76B on int8 pages with the prefix cache and 4-token drafts,
    on ``tools.serve_features``' traffic (8 requests sharing a 512-token
    prefix, two retrying request 0) and drafter (``RetrievalDrafter``,
    its store filled with request 0's stream once request 0 was served
    alone), graphed (the default) and eager: the streams must be equal,
    the cache must have covered prompt tokens, drafts must have been
    accepted, and every page must come back."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine, page_bytes
    from paddle_tpu_torch.tools.serve_features import (RetrievalDrafter,
                                                       features_traffic)

    cfg = llama_076b()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    prefix, requests = features_traffic(np.random.default_rng(3),
                                        cfg.vocab_size)
    runs = {}
    for graphed in (True, False):
        drafter = RetrievalDrafter(k=4)
        engine = ServingEngine(model, page_size=16, max_batch_slots=8,
                               max_model_len=2048, token_budget=1024,
                               kv_dtype="int8", prefix_cache=True, spec_k=4,
                               drafter=drafter, cuda_graph=graphed,
                               device="cuda")
        outs, rec = serve_traffic(
            torch, engine, requests, first_alone=lambda p, o: drafter.add(
                np.concatenate([p, o.token_ids])))
        pool = engine.pool
        bf16_bytes = pool.num_pages * page_bytes(
            pool.page_size, pool.n_kv_heads, pool.head_dim, pool.num_layers,
            "bf16")
        rec.update(
            prefix_hit_tokens=engine.stats["prefix_hit_tokens"],
            spec_drafted=engine.stats["spec_drafted"],
            spec_accepted=engine.stats["spec_accepted"],
            cow_copies=pool.cow_copies, pool_bytes=pool.device_bytes(),
            bf16_pool_bytes=bf16_bytes, card=card)
        log(f"serve features ({rec['step']}, int8 pages, prefix cache, "
            f"spec_k 4): " + json.dumps(rec))
        check_k4_counts(f"serve features ({rec['step']})", engine, rec)
        if rec["prefix_hit_tokens"] <= 0 or rec["spec_accepted"] <= 0:
            fail(f"serve features: prefix hits {rec['prefix_hit_tokens']}, "
                 f"accepted drafts {rec['spec_accepted']} (both must be > 0)")
        if pool.used_pages != 0:
            fail(f"serve features: {pool.used_pages} pages in use after the "
                 "run")
        runs[graphed] = (engine, [o.token_ids for o in outs], rec)
    (engine, graphed_streams, rec), (eager, eager_streams, _r) = (
        runs[True], runs[False])
    del eager
    same = graphed_streams == eager_streams
    log(f"serve features: graphed and eager streams "
        f"{'identical' if same else 'DIFFER'} over {len(requests)} requests")
    if not same:
        fail("serve features: the graphed step's streams differ from the "
             "eager one's")
    layer_err, replay_err = features_step(
        torch, engine, prefix, np.random.default_rng(4), 5e-5)
    log(f"serve features step: 3 decode rows x (1 + 4 drafts) on shared "
        f"prefix pages over int8 pages; attention kernel vs plain on the "
        f"same inputs, max over 12 layers {layer_err:.3e}, graph-replayed "
        f"call {replay_err:.3e} (atol=rtol=5e-5) ok")
    pool = engine.pool
    cleared = engine.prefix_cache.clear()
    if pool.used_pages != 0 or len(pool._free) != pool.usable_pages:
        fail(f"serve features: {pool.usable_pages - len(pool._free)} pages "
             f"held after the cache's {cleared} nodes were cleared")
    log(f"serve features: drained, {cleared} cache nodes cleared, all "
        f"{pool.usable_pages} pages free")
    return rec


def lora_products_ms(torch, engine, T):
    """Device ms of one step's LoRA products at ``T`` grid rows: every
    site group of every layer (``AdapterRows.apply_group``, as the trunk
    calls it: q/k/v and gate/up each one A product), rows spread over
    the store's slots, replayed from a CUDA graph."""
    from paddle_tpu_torch.serving import AdapterRows

    store = engine.adapters
    dims = {site: (d_in, d_out) for site, d_in, d_out in store.sites}
    gen = torch.Generator(device="cuda").manual_seed(0)
    slots = torch.arange(T, device="cuda") % store.capacity
    groups = [(g, torch.randn(T, dims[g[0]][0], device="cuda", generator=gen),
               [torch.randn(T, dims[s][1], device="cuda", generator=gen)
                for s in g]) for g in store.group_a]

    def fn():
        rows = AdapterRows(store, slots)
        for layer in range(store.num_layers):
            for g, x, bases in groups:
                rows.apply_group(g, layer, x, bases)

    return graph_ms(torch, fn, launches=5)


def tenancy_checks(torch, engine, rng):
    """On the tenancy engine (idle, its adapters registered): one mixed
    step (decode rows and a prompt chunk, every row on slot 0) computed
    twice, over the registered store and over an empty one, must give
    equal hidden states (slot 0 adds exact zeros); then one live stream
    parked and unparked explicitly must read back every layer's k/v pages
    bit for bit through its new block table, twice (the first pays for
    the pinned host buffers, the second reuses them). Returns the second
    park's and unpark's ms per page, the first's, and the pages moved."""
    from paddle_tpu_torch.serving import AdapterRows, AdapterStore

    vocab = engine.model.config.vocab_size
    for n in (300, 90, 200):
        engine.add_request(rng.integers(0, vocab, n), max_new_tokens=4)
    engine.step()
    engine.add_request(rng.integers(0, vocab, 256), max_new_tokens=2)
    for req in engine.scheduler.admit(1, engine.pool):
        engine._admit(req)
    batch = engine._plan()
    if batch.n_decode != 3 or int(batch.tok_adp.max()) != 0:
        fail(f"tenancy mixed step: {batch.n_decode} decode rows, adapter "
             f"slots {sorted(set(batch.tok_adp.tolist()))}")
    empty = AdapterStore.from_model(engine.model)
    hidden = []
    for store in (engine.adapters, empty):
        def put(a):
            return torch.from_numpy(a).cuda()
        with torch.no_grad():
            hidden.append(engine.trunk.forward_paged(
                put(batch.tok), put(batch.tok_pos), put(batch.tok_bt),
                engine.pool.layer_caches(),
                adapters=AdapterRows(store, put(batch.tok_adp))))
    if len(engine.adapters.names()) != 3 or not torch.equal(*hidden):
        fail("tenancy mixed step: slot-0 rows over a store holding "
             f"{engine.adapters.names()} differ from the empty store's "
             f"(max {float((hidden[0] - hidden[1]).abs().max()):.3e})")
    log(f"tenancy mixed step: {batch.total} rows ({batch.n_decode} decode + "
        f"a 256-token chunk) on slot 0 with adapters "
        f"{list(engine.adapters.names())} registered: hidden states equal "
        "to the empty store's (torch.equal)")
    logits = engine.model.logits(hidden[0][torch.from_numpy(
        batch.sample_rows.reshape(-1)).cuda().long()]).float()
    engine._land(batch, torch.argmax(logits, -1).cpu().numpy())
    engine.run()

    rid = engine.add_request(rng.integers(0, vocab, 333), max_new_tokens=16,
                             prefix_cache=False)
    engine.step()
    _, live = engine._find_slot(rid)
    while live.prefilling or len(live.gen) < 4:
        engine.step()
    pool = engine.pool
    table = pool.block_table(rid)
    n_written = pool.pages_needed(pool.seq_len(rid))
    every = [t for _n, ts in pool._page_tensors() for t in ts]
    before = [t[table[:n_written]].clone() for t in every]
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = engine.park_request(rid)
        t1 = time.perf_counter()
        if moved != n_written or pool.offloaded_pages(rid) != moved:
            fail(f"explicit park moved {moved} of {n_written} written pages")
        back = engine.unpark_request(rid)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        table2 = pool.block_table(rid)
        after = [t[table2[:n_written]] for t in every]
        if back != moved or not all(torch.equal(a, b)
                                    for a, b in zip(after, before)):
            fail("explicit park/unpark did not give back the k/v bytes")
        times.append((1e3 * (t1 - t0) / moved, 1e3 * (t2 - t1) / moved))
        log(f"tenancy park/unpark: {moved} pages of {pool.num_layers} "
            f"layers' k/v moved to pinned host memory in "
            f"{times[-1][0]:.4f} ms/page and back in {times[-1][1]:.4f} "
            f"ms/page (table {table[:3]}... -> {table2[:3]}...), every "
            f"byte equal")
        table = table2
    engine.run()
    return times[1] + times[0] + (moved,)


def phase_serve_tenancy(torch, card):
    """Llama-0.76B with three LoRA adapters, a JSON-schema grammar and the
    host page tier on ``tools.serve_tenancy``'s traffic (12 requests,
    6 at priority 2 then 6 at priority 0 four steps later, the pool
    holding the worst case of 5 streams), graphed and eagerly, with
    adapter ``a2`` hot-swapped at a fixed step: equal streams, one
    captured program per bucket and none recaptured across the swap,
    ``a2``'s streams unlike those of a run without the swap, every
    constrained stream valid, parks and unparks with no late prefetch,
    K4's counts as in the serve phase; then ``tenancy_checks`` and the
    pool empty once the cache is cleared."""
    import gc

    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.tools import serve_tenancy as st

    # earlier phases' engines hold their graphs in reference cycles
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_076b()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    requests, fsm = st.tenancy_traffic(np.random.default_rng(7),
                                       cfg.vocab_size)
    runs = {}
    for graphed in (True, False):
        engine = st.tenancy_engine(model, cuda_graph=graphed, device="cuda")
        weights = st.register_tenants(engine)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
        graphs = {}

        def at_swap():
            graphs.update({T: p.graph for T, p in engine._programs.items()})

        pa.reset_counters()
        outs, rec = st.serve_tenancy(
            engine, requests, swap=weights["a2'"], at_swap=at_swap,
            sync=torch.cuda.synchronize)
        rec.update(kernel_launches=pa.kernel_launches,
                   captured_launches=pa.captured_launches,
                   replayed_launches=pa.replayed_launches,
                   plain_calls=pa.plain_calls,
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                   memory_before_gib=held_before / 2**30, card=card)
        log(f"serve tenancy ({rec['step']}, bf16 pages, 3 adapters, grammar, "
            f"host tier, spec_k 4): " + json.dumps(rec))
        check_k4_counts(f"serve tenancy ({rec['step']})", engine,
                        dict(rec, steps=rec["model_steps"]))
        if graphed and (len(engine.capture_seconds())
                        != rec["compile_counts"]["step"]):
            fail(f"serve tenancy: {len(engine.capture_seconds())} captures "
                 f"for {rec['compile_counts']}")
        bad = [i for i, (o, r) in enumerate(zip(outs, requests))
               if r["grammar"] is not None and not (
                   fsm.validates(o.token_ids) and o.finish_reason == "stop")]
        if bad:
            fail(f"serve tenancy: constrained requests {bad} do not validate")
        if rec["parks"] < 1 or rec["unparks"] < 1 \
                or rec["kv_prefetch_late_pages"] != 0 \
                or rec["swapped_at_step"] is None:
            fail(f"serve tenancy: parks {rec['parks']}, unparks "
                 f"{rec['unparks']}, late prefetches "
                 f"{rec['kv_prefetch_late_pages']}, swap at "
                 f"{rec['swapped_at_step']}")
        runs[graphed] = (engine, [o.token_ids for o in outs], rec, graphs,
                         weights)
    engine, streams, rec, graphs, weights = runs[True]
    eager_rec = runs[False][2]
    same = streams == runs[False][1]
    del runs
    log(f"serve tenancy: graphed and eager streams "
        f"{'identical' if same else 'DIFFER'} over {len(requests)} requests")
    if not same:
        fail("serve tenancy: the graphed step's streams differ from the "
             "eager one's")
    # the graphs captured before the swap are the ones replayed after it
    if not graphs or any(engine._programs[T].graph is not g
                         for T, g in graphs.items()):
        fail(f"serve tenancy: a step program was recaptured across the "
             f"swap, or none was captured before it ({sorted(graphs)})")
    log(f"serve tenancy: the {len(graphs)} graphs captured before the swap "
        f"(buckets {sorted(graphs)}) replayed after it; "
        f"{rec['compile_counts']}")
    # a2 without the swap: its requests alone on a cold cache, a2 holding
    # its first weights throughout (streams do not depend on batch-mates)
    engine.prefix_cache.clear()
    engine.register_adapter("a2", weights["a2"])
    a2 = [i for i, r in enumerate(requests) if r["adapter_id"] == "a2"]
    rids = [engine.add_request(requests[i]["prompt"], max_new_tokens=64,
                               temperature=requests[i]["temperature"],
                               eos_token_id=st.EOS,
                               seed=requests[i]["seed"], adapter_id="a2",
                               grammar=requests[i]["grammar"]) for i in a2]
    outs = engine.run()
    unswapped = [outs[r].token_ids for r in rids]
    differ = [streams[i] != u for i, u in zip(a2, unswapped)]
    log(f"serve tenancy: a2's {len(a2)} streams against a run without the "
        f"swap: {['differ' if d else 'equal' for d in differ]}")
    if not any(differ):
        fail("serve tenancy: the hot-swapped adapter changed no stream")
    lora8 = lora_products_ms(torch, engine, 8)
    lora64 = lora_products_ms(torch, engine, 64)
    log(f"tenancy LoRA products ({len(engine.adapters.sites)} sites x "
        f"{engine.n_layers} layers, capacity {engine.adapters.capacity}, rank "
        f"{engine.adapters.rank}), graph-replayed: T 8 {lora8:.4f} ms, T 64 "
        f"{lora64:.4f} ms a step")
    park_ms, unpark_ms, park0_ms, unpark0_ms, moved = tenancy_checks(
        torch, engine, np.random.default_rng(8))
    pool = engine.pool
    cleared = engine.prefix_cache.clear()
    if pool.used_pages != 0 or pool.offloaded_pages() != 0 \
            or len(pool._free) != pool.usable_pages:
        fail(f"serve tenancy: {pool.used_pages} pages used, "
             f"{pool.offloaded_pages()} offloaded after the cache's "
             f"{cleared} nodes were cleared")
    summary = {
        "card": card,
        "decode_step_ms_p50": {"graphed": rec["decode_step_ms_p50"],
                               "eager": eager_rec["decode_step_ms_p50"]},
        "auto_offload_ms_per_page": rec["offload_ms_per_page"],
        "auto_prefetch_ms_per_page": rec["prefetch_ms_per_page"],
        "explicit_park_ms_per_page": park_ms,
        "explicit_unpark_ms_per_page": unpark_ms,
        "explicit_first_park_ms_per_page": park0_ms,
        "explicit_first_unpark_ms_per_page": unpark0_ms,
        "explicit_pages": moved,
        "prefix_hit_tokens_cross_adapter":
            rec["prefix_hit_tokens_cross_adapter"],
        "grammar_filtered_drafts": rec["grammar_filtered_drafts"],
        "lora_products_ms": {"T8": lora8, "T64": lora64},
        "peak_memory_gib": rec["peak_memory_gib"],
    }
    log("serve tenancy summary: " + json.dumps(summary))
    return rec


def phase_reference(torch):
    """A small f32 Llama (GQA) served on the card, graphed, with the
    prefix cache and 2-token drafts, and on the CPU through the plain
    version with both off: the same token streams. The fifth request
    shares the first one's two full pages; the sixth runs on a LoRA
    adapter (the same seeded weights on both) and the seventh under a
    grammar, whose stream must validate."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import (GrammarFSM, ServingEngine,
                                          random_adapter, toy_tokenizer)

    cfg = llama_tiny(vocab_size=256, hidden_size=256, num_layers=2,
                     num_heads=4, num_key_value_heads=2,
                     max_position_embeddings=256)
    rng = np.random.default_rng(2)
    work = [(rng.integers(0, 256, int(n)), t, s) for n, t, s in
            ((40, 0.0, 0), (7, 0.8, 1), (130, 0.0, 2), (64, 0.8, 3))]
    work.append((np.concatenate([work[0][0][:35], rng.integers(0, 256, 20)]),
                 0.0, 4))
    fsm = GrammarFSM.compile({"enum": ["red", "green", "blue"]},
                             toy_tokenizer(256))
    tenancy = [dict(adapter_id="t1"), dict(grammar=fsm)]
    work += [(rng.integers(0, 256, 50), 0.8, 5), (rng.integers(0, 256, 20),
                                                  0.0, 6)]
    streams, stats = {}, {}
    for dev, kw in (("cuda", dict(spec_k=2)),
                    ("cpu", dict(prefix_cache=False))):
        model = LlamaForCausalLM(cfg, device="cpu", seed=5).to(dev)
        eng = ServingEngine(model, page_size=16, max_batch_slots=3,
                            token_budget=48, device=dev, **kw)
        eng.register_adapter("t1", random_adapter(eng.adapters, seed=9,
                                                  scale=0.2))
        rids = [eng.add_request(p, max_new_tokens=12, temperature=t, seed=s,
                                **(tenancy[i - 5] if i >= 5 else {}))
                for i, (p, t, s) in enumerate(work)]
        outs = eng.run()
        streams[dev] = [outs[r].token_ids for r in rids]
        stats[dev] = {k: eng.stats[k] for k in (
            "prefix_hit_tokens", "spec_drafted", "spec_accepted",
            "grammar_tokens")}
        stats[dev]["compile_counts"] = eng.compile_counts()
    same = streams["cuda"] == streams["cpu"]
    card = stats["cuda"]
    log(f"reference: small f32 Llama, card (graphed, prefix cache, spec_k 2: "
        f"{json.dumps(card)}) vs CPU (plain, both off) streams "
        f"{'identical' if same else 'DIFFER'} over {len(work)} requests, one "
        f"on a LoRA adapter, one under a grammar")
    if not same or not fsm.validates(streams["cuda"][6]):
        fail(f"streams differ, or the constrained one is invalid: {streams}")
    cc = card["compile_counts"]
    if card["prefix_hit_tokens"] <= 0 or card["spec_drafted"] <= 0 \
            or cc["step"] != cc["step_buckets"]:
        fail(f"reference: the card run took no prefix hit or no draft, or "
             f"its compile counts differ: {card}")


# ───────────────────────────── training ─────────────────────────────


def phase_train(torch, card, model):
    """``model``'s bench through its entry point, full width and depth,
    8 steps. The flash counts are zeroed just before and read just after:
    each kernel launched as often a step as the model's layers run it
    (``per_layer``: K1 twice under recompute), the plain versions never."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = bench.SETUPS[model](False)[0]
    rc = bool(getattr(cfg, "recompute", False))
    per_layer = {"flash_fwd": 2 if rc else 1, "flash_dq": 1, "flash_dkv": 1}
    fa.reset_counters()
    t0 = time.perf_counter()
    rec = bench.bench_model(model, small=False, device="cuda", steps=5,
                            reps=1)
    wall = time.perf_counter() - t0
    launches, plain = dict(fa.kernel_launches), dict(fa.plain_calls)
    losses = rec.pop("losses")
    steps = rec.pop("steps_run")
    summary = dict(rec, steps_run=steps, wall_s=wall, losses=losses,
                   kernel_launches=launches, plain_calls=plain, card=card)
    log(f"train {model}: " + json.dumps(summary))
    if not all(math.isfinite(x) for x in losses):
        fail(f"train {model}: a loss is not finite: {losses}")
    want = {n: k * cfg.num_layers * steps for n, k in per_layer.items()}
    if launches != want or any(plain.values()):
        fail(f"train {model}: flash launches {launches} != {want} "
             f"({cfg.num_layers} layers x {steps} steps), or plain calls "
             f"{plain} != 0")
    return launches


def phase_train_reference(torch, model):
    """A small f32 model takes three AdamW steps on the card (the flash
    kernels) and on the CPU (their plain versions) from the same weights
    and tokens: GPT (2 layers, hidden 256, 2 heads of 128) or Llama (2
    layers, hidden 256, 4 heads of 64 over 2 KV heads, recompute on), S
    512. Tolerance atol = rtol = 1e-4 on the losses and on every
    parameter: both run the same f32 math with summation orders of their
    own (TF32 is off), and ``epsilon=1e-6`` keeps Adam from turning the
    sign of a near-zero grad into a full step."""
    import copy

    import numpy as np

    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.ops import flash_attention as fa

    if model == "gpt":
        cfg = gpt_tiny(vocab_size=2048, hidden_size=256, num_layers=2,
                       num_heads=2, max_position_embeddings=512,
                       fused_loss=True)
        base = GPTForCausalLM(cfg, device="cpu", seed=11)
        per_step = dict.fromkeys(fa.KERNELS, 2)
    else:
        cfg = llama_tiny(vocab_size=2048, hidden_size=256, num_layers=2,
                         num_heads=4, num_key_value_heads=2,
                         max_position_embeddings=512, recompute=True,
                         fused_loss=True)
        base = LlamaForCausalLM(cfg, device="cpu", seed=11)
        per_step = {"flash_fwd": 4, "flash_dq": 2, "flash_dkv": 2}
    ids_np = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 512))
    runs = {}
    for dev in ("cuda", "cpu"):
        net = copy.deepcopy(base).to(dev)
        opt = AdamW(learning_rate=1e-3, epsilon=1e-6,
                    parameters=net.named_parameters())
        ids = torch.from_numpy(ids_np).to(dev)
        labels = torch.from_numpy(np.roll(ids_np, -1, axis=1)).to(dev)
        fa.reset_counters()
        losses = []
        for _ in range(3):
            _, loss = net(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        used = dict(fa.kernel_launches if dev == "cuda" else fa.plain_calls)
        runs[dev] = (losses, {n: p.detach().cpu() for n, p in
                              net.named_parameters()}, used)
    (l_gpu, p_gpu, used_gpu), (l_cpu, p_cpu, used_cpu) = (runs["cuda"],
                                                          runs["cpu"])
    tol = 1e-4
    loss_err = max(abs(a - b) for a, b in zip(l_gpu, l_cpu))
    ok = all(abs(a - b) <= tol + tol * abs(b) for a, b in zip(l_gpu, l_cpu))
    param_err = 0.0
    for n, want in p_cpu.items():
        err = (p_gpu[n] - want).abs()
        param_err = max(param_err, float(err.max()))
        ok &= bool((err <= tol + tol * want.abs()).all())
    log(f"train reference: small f32 {model}, 3 AdamW steps, card (kernels "
        f"{used_gpu}) vs CPU (plain {used_cpu}): losses {l_gpu} vs {l_cpu}, "
        f"max loss err {loss_err:.2e}, max param err {param_err:.2e} "
        f"(atol=rtol={tol:g}) {'ok' if ok else 'MISMATCH'}")
    want_used = {n: 3 * k for n, k in per_step.items()}
    if not ok or used_gpu != want_used or used_cpu != want_used:
        fail(f"train reference {model}: card and CPU runs disagree, or a "
             "run did not take its path")


def phase_adamw_path(torch):
    """K5's path, ``tools.bench_adamw``, with K5's counts zeroed just
    before and read just after."""
    from paddle_tpu_torch.ops import fused_adamw as k5
    from paddle_tpu_torch.tools import bench_adamw

    k5.reset_counters()
    rec = bench_adamw.bench_adamw(device="cuda")
    launches, plain = k5.kernel_launches, k5.plain_calls
    log("adamw path: " + json.dumps(dict(rec, kernel_launches=launches,
                                         plain_calls=plain)))
    if launches == 0 or plain != 0:
        fail(f"adamw path: K5 launched {launches} times, plain version "
             f"{plain} times")
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        fail("paddle_tpu_torch/ not found beside chip_smoke.py: run it from "
             "a checkout of the repository")
    sys.path.insert(0, HERE)
    name, card = phase_device(torch)
    phase_build()
    paged = phase_paged_kernels(torch)
    flash = phase_flash_kernels(torch)
    adamw = phase_adamw_kernels(torch)
    engine, serve = phase_serve(torch, card)
    phase_mixed_steps(torch, engine)
    del engine
    torch.cuda.empty_cache()
    features = phase_serve_features(torch, card)
    torch.cuda.empty_cache()
    tenancy = phase_serve_tenancy(torch, card)
    torch.cuda.empty_cache()
    phase_reference(torch)
    torch.cuda.empty_cache()
    flash_launches = phase_train(torch, card, "gpt13")
    phase_train_reference(torch, "gpt")
    adamw_launches = phase_adamw_path(torch)
    phase_train(torch, card, "llama")
    phase_train_reference(torch, "llama")
    head = paged["a_decode_f32q_bf16kv"]
    chunk = paged["b_chunk_bf16"]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:124",
        # the graphed serve phase's launches: one warm-up a layer per
        # bucket, then one a layer per replayed step
        "launches": serve["kernel_launches"] + serve["replayed_launches"],
        "replayed_launches": serve["replayed_launches"],
        # each serving path's graphed run, counted the same way
        "launches_by_path": {
            name: rec["kernel_launches"] + rec["replayed_launches"]
            for name, rec in (("serve", serve),
                              ("serve_features", features),
                              ("serve_tenancy", tenancy))},
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "chunk_case": {"name": "b_chunk_bf16", **chunk},
    }]
    gpt13 = flash["gpt13_bf16"]
    for kname, line in (("flash_fwd", 128), ("flash_dq", 290),
                        ("flash_dkv", 351)):
        r = gpt13[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": flash_launches[kname],
            "max_abs_err": gpt13["max_abs_err"][kname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    k5 = adamw["n355m_step10"]
    kernels.append({
        "name": "fused_adamw", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_adamw.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_adamw.py:62",
        "launches": adamw_launches,
        "max_abs_err": k5["max_abs_err"],
        "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
