#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure exits non-zero before the result line:

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: every CUDA source under paddle_tpu_torch/csrc/, one nvcc each,
   all started together, into build/paddle_tpu_torch/.
3. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes (Llama-0.76B attention: 16 heads of 128, pages
   of 16, rows up to 2048 tokens), with timings and the card's bound.
4. Serve: Llama-0.76B (vocab 32000, hidden 2048, 12 layers, 16 heads,
   intermediate 5632) with seeded random bf16 weights, bf16 KV pages,
   8 requests of 64-1024 prompt tokens and 64 new tokens through
   ServingEngine. The kernel launch counts are zeroed just before and
   read just after; every layer of every step must have launched the
   kernel, and the plain version never.
5. Checks: one mixed step (3 decode rows + a 256-token chunk) run with
   the kernel and with the plain version on the same inputs, in bf16
   (held per layer) and in f32 (held per layer and at the logits); a
   small f32 model served on the card and on the CPU (plain path) gives
   the same token streams.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
import json
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
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas[{n}]: {line.strip()}")


def _pool(torch, gen, shape, dtype, dev):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def make_case(torch, dev, *, q_lens, starts, nh, nkv, q_dtype, kv_dtype,
              hd=128, page=16, pages_per_seq=128, seed=0):
    """Inputs of one ragged call: slot i contributes q_lens[i] rows at
    positions starts[i].. over its own pages, as the engine lays them
    out."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_slots = len(q_lens)
    num_pages = n_slots * pages_per_seq + 1
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    slot_bt = perm.view(n_slots, pages_per_seq).to(torch.int32)
    reps = torch.tensor(q_lens, device=dev)
    bt = slot_bt.repeat_interleave(reps, dim=0).contiguous()
    lens = torch.cat([torch.arange(s, s + n, device=dev) + 1
                      for s, n in zip(starts, q_lens)]).to(torch.int32)
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


def phase_kernels(torch):
    from paddle_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    decode_lens = [2048, 1, 731, 1500, 64, 1999, 17, 1024]
    decode = dict(q_lens=[1] * 8, starts=[n - 1 for n in decode_lens])
    chunk = dict(q_lens=[1, 1, 1, 256], starts=[900, 2047, 33, 1500])
    cases = [
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
    ]
    results = {}
    for name, kw, tol, timed in cases:
        q, k, v, bt, lens, ks, vs = make_case(torch, dev, **kw)
        got = pa.paged_attention(q, k, v, bt, lens, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        want = pa.ref_paged_attention(q, k, v, bt, lens, k_scale=ks,
                                      v_scale=vs)
        err = (got.float() - want.float()).abs()
        max_err = float(err.max())
        ok = bool((err <= tol + tol * want.float().abs()).all())
        line = (f"kernel {name}: T={q.shape[0]} nh={q.shape[1]} "
                f"nkv={k.shape[2]} max_abs_err={max_err:.3e} "
                f"(atol=rtol={tol:g}) {'ok' if ok else 'MISMATCH'}")
        rec = {"max_abs_err": max_err}
        if timed:
            ms = cuda_ms(torch, lambda: pa.paged_attention(
                q, k, v, bt, lens, k_scale=ks, v_scale=vs))
            plain_ms = cuda_ms(torch, lambda: pa.ref_paged_attention(
                q, k, v, bt, lens, k_scale=ks, v_scale=vs),
                launches=2, rounds=3)
            bound_ms, bound_by = paged_bound(torch, q, k, bt, lens,
                                             ks is not None)
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
            line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                     f"bound {bound_ms:.4f} ms ({bound_by}), "
                     f"{bound_ms / ms:.1%} of bound")
        log(line)
        if not ok:
            fail(f"kernel case {name} disagrees with its plain version")
        results[name] = rec
    return results


def llama_076b():
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=12,
                       num_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048)


def phase_serve(torch, card):
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_076b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServingEngine(model, page_size=16, max_batch_slots=8,
                           max_model_len=2048, token_budget=1024,
                           kv_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: Llama-0.76B {n_params / 1e9:.3f} B params bf16, intermediate "
        f"{cfg.intermediate_size}, pool {engine.pool.num_pages} pages, "
        f"set up in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 1025, 8)
    new_tokens, eos = 64, 2
    first_token = {}

    def stream_cb(rid, token, finished):
        if token is not None and rid not in first_token:
            first_token[rid] = time.perf_counter()

    pa.reset_counters()
    t_start = time.perf_counter()
    rids = []
    for i, n in enumerate(lengths):
        temp = 0.8 if i in (2, 5) else 0.0
        rids.append(engine.add_request(
            rng.integers(0, cfg.vocab_size, int(n)), max_new_tokens=new_tokens,
            temperature=temp, eos_token_id=eos, seed=1000 + i,
            stream_cb=stream_cb))
    steps = []
    while engine.has_work:
        ts = time.perf_counter()
        engine.step()
        steps.append((engine.stats["step_decode_tokens"],
                      engine.stats["step_prefill_tokens"],
                      time.perf_counter() - ts))
    wall = time.perf_counter() - t_start
    launches, plain = pa.kernel_launches, pa.plain_calls
    outs = engine.take_outputs()

    n_steps = engine.stats["steps"]
    generated = engine.stats["generated_tokens"]
    decode_ms = [1e3 * s for d, p, s in steps if p == 0 and d > 0]
    ttft = sorted(first_token[r] - t_start for r in rids)
    summary = {
        "steps": n_steps, "generated_tokens": generated,
        "prompt_tokens": int(lengths.sum()), "wall_s": wall,
        "tokens_per_s": generated / wall,
        "decode_step_ms_p50": statistics.median(decode_ms),
        "decode_steps": len(decode_ms),
        "mixed_steps": sum(1 for _d, p, _s in steps if p > 0),
        "ttft_s_p50": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "kernel_launches": launches, "plain_calls": plain,
        "card": card,
    }
    log("serve: " + json.dumps(summary))
    if set(outs) != set(rids):
        fail(f"served {len(outs)} of {len(rids)} requests")
    for r in rids:
        o = outs[r]
        if not (o.n_gen == new_tokens or (o.finish_reason == "stop"
                                          and o.token_ids[-1] == eos)):
            fail(f"request {r}: {o.n_gen} tokens, {o.finish_reason}")
        if not all(0 <= t < cfg.vocab_size for t in o.token_ids):
            fail(f"request {r}: token outside the vocabulary")
    if engine.pool.used_pages != 0:
        fail(f"{engine.pool.used_pages} pages still in use after the run")
    if launches != cfg.num_layers * n_steps or plain != 0:
        fail(f"kernel launches {launches} != {cfg.num_layers} x {n_steps} "
             f"steps, or plain calls {plain} != 0")
    return engine, launches


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
    """The mixed step on the served bf16 model, then on the same model in
    f32 (weights and pages). In bf16 the two runs' logits differ by bf16
    rounding that 12 layers amplify (the runs part ways at the first
    attention output that rounds differently), so the bf16 run is held
    per layer on identical inputs and its logit gap is reported; the f32
    run, free of that rounding, holds the end-to-end logits too."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    layer_err, k_logits, p_logits = mixed_step(torch, engine, 2e-2)
    log(f"mixed step bf16: 3 decode rows + 256 chunk rows; attention kernel "
        f"vs plain on the same inputs, max over 12 layers "
        f"{layer_err:.3e} (atol=rtol=2e-2) ok; sample logits gap "
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


def phase_reference(torch):
    """A small f32 Llama (GQA) served on the card through the kernel and
    on the CPU through the plain version: the same token streams."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_tiny(vocab_size=256, hidden_size=256, num_layers=2,
                     num_heads=4, num_key_value_heads=2,
                     max_position_embeddings=256)
    rng = np.random.default_rng(2)
    work = [(rng.integers(0, 256, int(n)), t, s) for n, t, s in
            ((40, 0.0, 0), (7, 0.8, 1), (130, 0.0, 2), (64, 0.8, 3))]
    streams = {}
    for dev in ("cuda", "cpu"):
        model = LlamaForCausalLM(cfg, device="cpu", seed=5).to(dev)
        eng = ServingEngine(model, page_size=16, max_batch_slots=3,
                            token_budget=48, device=dev)
        rids = [eng.add_request(p, max_new_tokens=12, temperature=t, seed=s)
                for p, t, s in work]
        outs = eng.run()
        streams[dev] = [outs[r].token_ids for r in rids]
    same = streams["cuda"] == streams["cpu"]
    log(f"reference: small f32 Llama, card (kernel) vs CPU (plain) streams "
        f"{'identical' if same else 'DIFFER'} over {len(work)} requests")
    if not same:
        fail(f"streams differ: {streams}")


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
    kernels = phase_kernels(torch)
    engine, launches = phase_serve(torch, card)
    phase_mixed_steps(torch, engine)
    phase_reference(torch)
    head = kernels["a_decode_bf16"]
    record = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:124",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
