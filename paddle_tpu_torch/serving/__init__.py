"""paddle_tpu_torch.serving: the continuous-batching engine on the card.

The paged KV pool with its refcounted pages, int8 pages, radix prefix
cache and host page tier (kv_cache.py), the chunked-prefill scheduler
(scheduler.py), the n-gram drafter of speculative decoding (spec.py),
the multi-LoRA adapter store (adapters.py), the grammars of constrained
decoding (grammar.py), the per-request sampling keys (sampling.py) and
the engine's unified ragged step, captured per token-grid bucket as a
CUDA graph (engine.py), whose attention is the CUDA kernel of
``ops/paged_attention.py``; the request tracer (tracing.py) and the
drain estimate behind backpressure (overload.py). The engine's deadlines,
cancel, NaN quarantine, watchdog and metrics ride the same step.

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import ServingEngine

    model = LlamaForCausalLM(llama_tiny(), dtype=torch.bfloat16)
    engine = ServingEngine(model, page_size=16, kv_dtype=torch.bfloat16)
    rid = engine.add_request(prompt_ids, max_new_tokens=32)
    out = engine.run()[rid].token_ids
"""
from .adapters import (AdapterRows, AdapterStore, grouped_lora_delta,
                       lora_delta, random_adapter)
from .engine import ServingEngine
from .grammar import GrammarFSM, ToyTokenizer, schema_to_regex, toy_tokenizer
from .kv_cache import (HostPageStore, PagedKVCachePool, PrefixCache,
                       normalize_kv_dtype, page_bytes)
from .overload import DrainEstimator
from .scheduler import (BackpressureError, FCFSScheduler, Request,
                        RequestOutput)
from .spec import NGramDrafter
from .tracing import (TTFT_BUCKETS, RequestTracer, attribute_ttft,
                      get_tracer, set_tracer, validate_events)

__all__ = ["ServingEngine", "PagedKVCachePool", "PrefixCache",
           "HostPageStore", "FCFSScheduler", "Request", "RequestOutput",
           "NGramDrafter", "AdapterStore", "AdapterRows", "random_adapter",
           "lora_delta", "grouped_lora_delta", "GrammarFSM", "ToyTokenizer",
           "toy_tokenizer", "schema_to_regex", "page_bytes",
           "normalize_kv_dtype", "BackpressureError", "DrainEstimator",
           "RequestTracer", "TTFT_BUCKETS", "attribute_ttft", "get_tracer",
           "set_tracer", "validate_events"]
