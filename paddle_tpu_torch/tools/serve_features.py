"""Shared-prefix traffic on the card: int8 pages, the prefix cache, drafts.

    python -m paddle_tpu_torch.tools.serve_features [--drafter ngram]
        [--new-tokens 64] [--no-retries] [--eager]

Builds Llama-0.76B (seeded random weights in bf16 by
``amp.decorate(level="O2")``'s rule) on int8 KV pages with the prefix
cache and ``spec_k`` 4, and serves :func:`features_traffic`: 8 requests
sharing a 512-token prefix, request 0 alone first (its prompt then sits
in the prefix cache), the rest together. Drafts come from
:class:`RetrievalDrafter` (the default) or the engine's own
``NGramDrafter`` (``--drafter ngram``). Prints one JSON line: drafts
scored and accepted, prompt tokens the prefix cache matched, steps,
decode-step p50 and the card. ``chip_smoke.py``'s serve-features phase
serves the same traffic.
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
from ..serving import NGramDrafter, ServingEngine

__all__ = ["features_traffic", "RetrievalDrafter"]


def features_traffic(rng, vocab: int, new_tokens: int = 64,
                     retries: bool = True):
    """``(prefix, requests)``: 8 requests ``(prompt, temperature, seed,
    max_new)`` sharing a 512-token prefix, with suffixes of 64-512
    tokens; two suffixes end in a 3-token n-gram said eight times (the
    n-gram drafter finds it at once); with ``retries`` requests 5 and 7
    repeat request 0 (prompt, seed and temperature); two at t = 0.8, the
    rest greedy."""
    prefix = rng.integers(0, vocab, 512)
    requests = []
    for i, n in enumerate(rng.integers(64, 513, 8)):
        suffix = rng.integers(0, vocab, int(n))
        if i in (1, 4):
            suffix[-24:] = np.tile(rng.integers(0, vocab, 3), 8)
        requests.append((np.concatenate([prefix, suffix]),
                         0.8 if i in (3, 6) else 0.0, 2000 + i, new_tokens))
    if retries:
        requests[5] = requests[7] = requests[0]
    return prefix, requests


class RetrievalDrafter:
    """Drafts the continuation of the stream's last ``n`` tokens in a
    store of finished requests' token streams (:meth:`add`), as
    retrieval drafting (REST) does, else what ``NGramDrafter`` finds in
    the stream itself. Random-weight models' greedy streams do not
    repeat themselves, so on them only a retried request's drafts are
    accepted (``--drafter ngram --no-retries`` measures the n-gram
    drafter alone)."""

    def __init__(self, k: int, n: int = 3):
        self.n, self.store = n, []
        self.own = NGramDrafter(k=k, max_ngram=n)

    def add(self, ids) -> None:
        self.store.append(np.asarray(ids, np.int32))

    def propose(self, ids, k):
        if len(ids) > self.n:
            tail = np.asarray(ids[-self.n:], np.int32)
            for seq in reversed(self.store):
                win = np.lib.stride_tricks.sliding_window_view(seq[:-1],
                                                               self.n)
                hits = np.flatnonzero((win == tail).all(axis=1))
                if hits.size:
                    start = int(hits[-1]) + self.n
                    return seq[start:start + k].copy()
        return self.own.propose(ids, k)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--drafter", choices=("retrieval", "ngram"),
                    default="retrieval")
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--no-retries", action="store_true")
    ap.add_argument("--eager", action="store_true")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=12,
                      num_heads=16, num_key_value_heads=16,
                      max_position_embeddings=2048)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    _prefix, requests = features_traffic(
        np.random.default_rng(3), cfg.vocab_size, args.new_tokens,
        retries=not args.no_retries)
    drafter = RetrievalDrafter(k=4) if args.drafter == "retrieval" else None
    engine = ServingEngine(model, page_size=16, max_batch_slots=8,
                           max_model_len=2048, token_budget=1024,
                           kv_dtype="int8", spec_k=4, drafter=drafter,
                           cuda_graph=not args.eager, device="cuda")
    decode_ms = []

    def drain():
        while engine.has_work:
            t0 = time.perf_counter()
            engine.step()
            if (engine.stats["step_prefill_tokens"] == 0
                    and engine.stats["step_decode_tokens"] > 0):
                decode_ms.append(1e3 * (time.perf_counter() - t0))

    first = engine.add_request(requests[0][0], max_new_tokens=args.new_tokens,
                               temperature=requests[0][1],
                               seed=requests[0][2])
    drain()
    out = engine.take_outputs()[first]
    if drafter is not None:
        drafter.add(np.concatenate([requests[0][0], out.token_ids]))
    for p, t, s, n in requests[1:]:
        engine.add_request(p, max_new_tokens=n, temperature=t, seed=s)
    drain()
    engine.take_outputs()
    print(json.dumps({
        "device": bench.card_label(torch.device("cuda")),
        "drafter": args.drafter, "retries": not args.no_retries,
        "new_tokens": args.new_tokens,
        "step": "cuda_graph" if engine._graphed else "eager",
        "steps": engine.stats["steps"],
        "generated_tokens": engine.stats["generated_tokens"],
        "prefix_hit_tokens": engine.stats["prefix_hit_tokens"],
        "spec_drafted": engine.stats["spec_drafted"],
        "spec_accepted": engine.stats["spec_accepted"],
        "decode_step_ms_p50": statistics.median(decode_ms),
    }))


if __name__ == "__main__":
    main()
