"""Multi-tenant traffic on the card: LoRA adapters, a JSON-schema grammar
and the host page tier, riding the captured serving step.

    python -m paddle_tpu_torch.tools.serve_tenancy [--eager]

Builds Llama-0.76B (seeded random weights in bf16 by
``amp.decorate(level="O2")``'s rule) on bf16 KV pages of 16 with the
prefix cache, ``spec_k`` 4 and ``host_offload=True``, its pool sized for
the worst case of only 5 of the 8 slots' streams (prompts of 256-512
tokens plus 64 new ones: 5 x 36 + 1 pages), registers three rank-4
adapters (``a1``-``a3``, capacity 4), and serves
:func:`tenancy_traffic` through :func:`serve_tenancy`: six requests at
priority 2, then six at priority 0 four steps later, so page pressure
parks the coldest priority-2 streams on the host and restores them when
their pages fit again; ``a2`` is re-registered with new weights at step
:data:`SWAP_STEP`. Prints one JSON line: decode-step p50, parks and
unparks with their milliseconds per page, prefix tokens matched (and
those written under another adapter), drafts cut by the grammar, the
compile counts and the card. ``chip_smoke.py``'s serve-tenancy phase
serves the same traffic, graphed and eagerly.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .. import bench
from ..models import LlamaConfig, LlamaForCausalLM
from ..serving import GrammarFSM, ServingEngine, random_adapter, toy_tokenizer

__all__ = ["SCHEMA", "EOS", "ADAPTERS", "SWAP_STEP", "tenancy_pages",
           "tenancy_engine", "register_tenants", "tenancy_traffic",
           "serve_tenancy"]

# a bounded JSON object (at most 41 characters), so a constrained stream
# finishes its structure well inside 64 new tokens
SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 6},
    "age": {"type": "integer"},
    "ok": {"type": "boolean"}}}
EOS = 2
ADAPTERS = ("a1", "a2", "a3")
ARRIVAL_STEP = 4   # the priority-0 wave is submitted after this many steps
SWAP_STEP = 10     # a2 is re-registered before this step
NEW_TOKENS = 64

# (wave, priority, adapter, constrained, temperature) of the 12 requests:
# 4 on the base model, 5 on an adapter, 3 constrained (one on an adapter)
_PLAN = [(0, 2, None, False, 0.0), (0, 2, "a1", False, 0.0),
         (0, 2, "a2", False, 0.8), (0, 2, None, True, 0.0),
         (0, 2, "a3", False, 0.0), (0, 2, None, False, 0.0),
         (1, 0, "a1", False, 0.0), (1, 0, "a2", True, 0.0),
         (1, 0, None, True, 0.8), (1, 0, None, False, 0.0),
         (1, 0, "a3", False, 0.0), (1, 0, None, False, 0.0)]


def tenancy_pages(page_size: int = 16, streams: int = 5,
                  max_prompt: int = 512, new_tokens: int = NEW_TOKENS) -> int:
    """Pages for the worst case of ``streams`` requests, plus the null
    page."""
    return streams * -(-(max_prompt + new_tokens) // page_size) + 1


def tenancy_engine(model, **kw) -> ServingEngine:
    """The tenancy engine: 8 slots, bf16 pages of 16, budget 1024, the
    prefix cache, ``spec_k`` 4, the host tier, a 4-slot rank-4 adapter
    store; ``kw`` adds to or overrides these."""
    args = dict(page_size=16, num_pages=tenancy_pages(), max_batch_slots=8,
                max_model_len=2048, token_budget=1024,
                kv_dtype=torch.bfloat16, prefix_cache=True, spec_k=4,
                host_offload=True, adapter_capacity=4, adapter_rank=4)
    args.update(kw)
    return ServingEngine(model, **args)


def register_tenants(engine, seed: int = 11) -> dict:
    """Register ``a1``-``a3`` (``random_adapter`` with seeds ``seed``,
    ``seed + 1``, ...); returns the weights by name and, under ``"a2'"``,
    the weights ``a2`` is swapped to."""
    weights = {name: random_adapter(engine.adapters, seed=seed + i)
               for i, name in enumerate(ADAPTERS)}
    for name in ADAPTERS:
        engine.register_adapter(name, weights[name])
    weights["a2'"] = random_adapter(engine.adapters, seed=seed + 100)
    return weights


def tenancy_traffic(rng, vocab: int):
    """``(requests, fsm)``: 12 requests, dicts of ``prompt``,
    ``temperature``, ``seed``, ``priority``, ``adapter_id``, ``grammar``
    (the compiled :data:`SCHEMA` or None) and ``wave``, with prompts of
    256-512 tokens; request 9 (base model) starts with request 1's (on
    ``a1``) first 256 tokens, so it adopts pages written under another
    adapter, as the prefix cache allows in both packages."""
    fsm = GrammarFSM.compile(SCHEMA, toy_tokenizer(vocab, eos_token_id=EOS))
    lengths = rng.integers(256, 513, len(_PLAN))
    requests = []
    for i, ((wave, prio, adapter, constrained, temp), n) in enumerate(
            zip(_PLAN, lengths)):
        prompt = rng.integers(0, vocab, int(n))
        if i == 9:
            prompt[:256] = requests[1]["prompt"][:256]
        requests.append(dict(prompt=prompt, temperature=temp, seed=3000 + i,
                             priority=prio, adapter_id=adapter,
                             grammar=fsm if constrained else None,
                             wave=wave))
    return requests, fsm


def serve_tenancy(engine, requests, swap=None, at_swap=None, sync=None):
    """Serve ``requests`` to completion through ``engine.step``: wave 0
    first, wave 1 after :data:`ARRIVAL_STEP` steps; with ``swap`` (the
    new weights of ``a2``) ``a2`` is re-registered before step
    :data:`SWAP_STEP`, just after ``at_swap()`` is called when given.
    ``sync`` (e.g. ``torch.cuda.synchronize``) is called before the clock
    is read.
    Returns the outputs in request order and a record of the run:
    per-step token mix and seconds, the steps that ran the model, and
    the engine's tenancy counts."""
    rids, steps = [None] * len(requests), []
    n_step, t0 = 0, time.perf_counter()

    def submit(wave):
        for i, r in enumerate(requests):
            if r["wave"] == wave:
                rids[i] = engine.add_request(
                    r["prompt"], max_new_tokens=NEW_TOKENS,
                    temperature=r["temperature"], eos_token_id=EOS,
                    seed=r["seed"], priority=r["priority"],
                    adapter_id=r["adapter_id"], grammar=r["grammar"])

    stats0 = dict(engine.stats)
    pool = engine.pool
    pool0 = (pool.offload_seconds, pool.prefetch_seconds)
    submit(0)
    swapped_at = None
    while engine.has_work or n_step < ARRIVAL_STEP:
        if n_step == ARRIVAL_STEP:
            submit(1)
        if swap is not None and n_step == SWAP_STEP:
            if at_swap is not None:
                at_swap()
            engine.register_adapter("a2", swap)
            swapped_at = n_step
        ts = time.perf_counter()
        engine.step()
        if sync is not None:
            sync()
        st = engine.stats
        rows = (st["step_decode_tokens"] + st["step_draft_tokens"]
                + st["step_prefill_tokens"])
        steps.append((st["step_decode_tokens"], st["step_prefill_tokens"],
                      rows, time.perf_counter() - ts))
        n_step += 1
    wall = time.perf_counter() - t0
    outs = engine.take_outputs()
    delta = {k: engine.stats[k] - stats0[k] for k in (
        "generated_tokens", "prefix_hit_tokens",
        "prefix_hit_tokens_cross_adapter", "spec_drafted", "spec_accepted",
        "grammar_tokens", "grammar_filtered_drafts", "parks", "unparks",
        "kv_offloaded_pages", "kv_prefetched_pages",
        "kv_prefetch_late_pages")}
    decode_ms = [1e3 * s for d, p, _r, s in steps if p == 0 and d > 0]
    off_s = pool.offload_seconds - pool0[0]
    pre_s = pool.prefetch_seconds - pool0[1]
    record = {
        "step": "cuda_graph" if engine._graphed else "eager",
        "steps": len(steps), "model_steps": sum(1 for s in steps if s[2]),
        "wall_s": wall,
        "tokens_per_s": delta["generated_tokens"] / wall,
        "decode_step_ms_p50": (statistics.median(decode_ms) if decode_ms
                               else None),
        "decode_steps": len(decode_ms),
        "swapped_at_step": swapped_at,
        **delta,
        "offload_ms_per_page": (1e3 * off_s / delta["kv_offloaded_pages"]
                                if delta["kv_offloaded_pages"] else None),
        "prefetch_ms_per_page": (1e3 * pre_s / delta["kv_prefetched_pages"]
                                 if delta["kv_prefetched_pages"] else None),
        "compile_counts": engine.compile_counts(),
        "capture_s_by_bucket": engine.capture_seconds(),
    }
    return [outs[r] for r in rids], record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eager", action="store_true")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=12,
                      num_heads=16, num_key_value_heads=16,
                      max_position_embeddings=2048)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    engine = tenancy_engine(model, cuda_graph=not args.eager, device="cuda")
    weights = register_tenants(engine)
    requests, fsm = tenancy_traffic(np.random.default_rng(7), cfg.vocab_size)
    outs, rec = serve_tenancy(engine, requests, swap=weights["a2'"],
                              sync=torch.cuda.synchronize)
    rec["constrained_valid"] = all(
        fsm.validates(o.token_ids) for o, r in zip(outs, requests)
        if r["grammar"] is not None)
    rec["device"] = bench.card_label(torch.device("cuda"))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
