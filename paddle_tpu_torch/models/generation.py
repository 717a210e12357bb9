"""Autoregressive generation with KV caches (``paddle_tpu/models/
generation.py``), mixed into the port's ``LlamaForCausalLM`` and
``GPTForCausalLM``.

``generate(input_ids, max_new_tokens, temperature, top_k, eos_token_id,
seed, device_loop, return_stats)`` has the JAX package's signature,
checks and returns. Per signature ``(B, prompt, total, temperature,
top_k)`` it keeps one prefill and one decode program, each a
``jit.StaticFunction`` over the same step: on the card the first call of
each runs eagerly, the second captures it as a CUDA graph and every later
call replays it; on the CPU every call runs eagerly. The write position
``cur_len`` is a 0-d device tensor, so one decode program serves every
position. The KV caches ``[B, total, cached heads, D]`` are f32, as the
JAX package allocates them, one pair a layer per ``(B, total)``: state
the step writes in place (``index_copy_``), zeroed at the start of each
call, never copied into a program's static inputs.

Sampling is the JAX package's ``_sample`` bit for bit: argmax at
temperature 0, else the f32 logits divided by ``float32(max(t, 1e-6))``
(a true division by a device tensor), everything below the k-th largest
set to -1e30 under ``top_k``, and ``jax.random.categorical``'s Gumbel
draw over ``[B, V]`` from one threefry key (``serving/sampling.py``).
The two loops draw their keys as the JAX loops do, so each reproduces
its own JAX loop's stream, and sampled streams differ between them
(greedy ones do not): from ``PRNGKey(seed)`` both take ``k0, key =
split(key)`` for the prefill; then the host loop samples step ``s`` with
``k`` of ``k, key = split(key)``, while the device loop splits once on
the host, ``k, key = split(key)``, and its body samples with ``sub`` of
``k, sub = split(k)``. A greedy call reads no key, so neither loop
splits one at temperature 0 (a split is ~190 small int64 kernels).

The host loop (``device_loop=False``; the default on the CPU) reads each
step's tokens on the host, as the JAX host loop does. The device loop
(the default on the card, as the JAX package turns it on for its
accelerator) keeps the token buffer, the count, the key, the rows' done
flags and eos (-1 = none) on the device, and replays one captured step
up to ``max_new_tokens - 1`` times without a host sync a token. Its body
is the JAX ``while_loop``'s body under the loop's condition: a replay
past the stop (every row done, or the buffer full) writes and counts
nothing, so the result equals the JAX loop's token for token however
often the host looks. The host reads the stop flag through a
non-blocking copy every ``CHECK_EVERY`` replays, and stops early once a
read that has landed says so; the result is trimmed to the device-side
count. A row that emits ``eos_token_id`` is frozen (it emits eos from
then on) and both loops stop once every row is done; ``stop_reason``
says which way the call stopped.

The step takes the logits of the last position only (the JAX step takes
all and slices the last): the same products for that row.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..metrics import get_registry
from ..serving.sampling import gumbel, prng_key, split
from ..tensor import to_tensor, unwrap

__all__ = ["GenerationMixin", "sample_tokens", "CHECK_EVERY"]

# device loop: replays between two non-blocking reads of the stop flag
CHECK_EVERY = 8


def sample_tokens(logits: torch.Tensor, temperature: float, top_k: int,
                  key: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``GenerationMixin._sample``: ``[B, V]`` f32
    logits -> ``[B]`` int64 ids, drawn with one key ``[2]``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    t = torch.full((1,), float(np.float32(max(temperature, 1e-6))),
                   dtype=torch.float32, device=logits.device)
    logits = logits / t
    if top_k:
        kth = torch.topk(logits, int(top_k), dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    B, V = logits.shape
    return torch.argmax(gumbel(key, B * V).view(B, V) + logits, dim=-1)


class _Signature:
    """One ``generate`` signature's programs and the device loop's state
    (made when the loop first runs)."""

    def __init__(self, temperature, prefill, decode):
        self.temperature = temperature
        self.prefill = prefill
        self.decode = decode
        self.loop = None
        self.state = None


class GenerationMixin:
    """Requires on the host class: ``_decode_trunk()`` (a trunk whose
    forward takes ``(ids, caches=..., cur_len=...)`` and returns
    ``(hidden, caches)``, writing the caches in place), ``logits(hidden)``,
    ``_cache_spec()`` -> ``(layers, cached heads, head dim)``, ``device``
    and ``config.max_position_embeddings``."""

    def _kv_caches(self, B: int, total: int, device: torch.device):
        """The f32 caches of ``(B, total)``, zeroed: one ``(k, v)`` pair a
        layer, kept on the model so the captured programs keep reading and
        writing the same storage."""
        n_layers, nh_c, hd = self._cache_spec()
        store = self.__dict__.setdefault("_generation_caches", {})
        caches = store.get((B, total, device))
        if caches is None:
            caches = store[(B, total, device)] = [
                tuple(torch.zeros((B, total, nh_c, hd), dtype=torch.float32,
                                  device=device) for _ in range(2))
                for _ in range(n_layers)]
        else:
            for k, v in caches:
                k.zero_()
                v.zero_()
        return caches

    def _step_fn(self, caches, temperature: float, top_k: int):
        trunk = self._decode_trunk()

        def step_fn(tok, cur, key):
            hidden, _ = trunk(tok, caches=caches, cur_len=cur)
            last = self.logits(hidden[:, -1:])[:, -1, :].to(torch.float32)
            return sample_tokens(last, temperature, top_k, key)

        step_fn.__name__ = "generate_step"  # jit_compiles_total{fn=...}
        return step_fn

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 device_loop: Optional[bool] = None,
                 return_stats: bool = False):
        """Returns the ``[B, prompt + generated]`` int64 ids as a Paddle
        Tensor on the model's device (generation stops early once every
        row emitted ``eos_token_id``); with ``return_stats``, ``(ids,
        {"n_gen", "stop_reason"})``, ``stop_reason`` ``"eos"`` when every
        row finished on eos before the budget ran out, else ``"length"``.
        ``device_loop``: None runs the device loop on the card and the host
        loop on the CPU (module docstring)."""
        from .. import jit

        t_start = time.perf_counter()
        cfg = self.config
        dev = self.device
        ids = torch.as_tensor(unwrap(input_ids), device=dev).to(torch.int64)
        B, S0 = ids.shape
        total = S0 + max_new_tokens
        if total > cfg.max_position_embeddings:
            raise ValueError(
                f"prompt {S0} + max_new_tokens {max_new_tokens} exceeds "
                f"max_position_embeddings {cfg.max_position_embeddings}")
        was_training = self.training
        self.eval()
        if device_loop is None:
            device_loop = dev.type == "cuda"
        caches = self._kv_caches(B, total, dev)
        gen_key = (B, S0, total, float(temperature), int(top_k))
        programs = self.__dict__.setdefault("_generation_programs", {})
        sig = programs.get(gen_key)
        if sig is None:
            step_fn = self._step_fn(caches, float(temperature), int(top_k))
            sig = programs[gen_key] = _Signature(float(temperature), *(
                jit.StaticFunction(step_fn, observe=[self], warmup=False,
                                   dy2static=False) for _ in range(2)))
        eos = eos_token_id
        with torch.no_grad():
            rng = prng_key(torch.tensor(seed, device=dev))
            k0, rng = split(rng)
            nxt = sig.prefill(ids, torch.zeros((), dtype=torch.int64,
                                               device=dev), k0)
            if device_loop and max_new_tokens > 1:
                gen, stopped_on_eos = self._device_loop(
                    sig, caches, B, S0, max_new_tokens, float(temperature),
                    int(top_k), nxt, split(rng)[0], eos)
            else:
                gen, stopped_on_eos = self._host_loop(
                    sig, B, S0, max_new_tokens, nxt, rng, eos)
        if was_training:
            self.train()
        out = np.concatenate([ids.cpu().numpy(), gen], axis=1)
        reg = get_registry()
        reg.histogram(
            "paddle_tpu_generate_seconds",
            "Whole dense generate() call (prefill + all decode steps, "
            "compile included on the first signature)",
        ).observe(time.perf_counter() - t_start)
        reg.counter(
            "paddle_tpu_generate_tokens_total",
            "Tokens emitted by dense generate() across all rows",
        ).inc(B * gen.shape[1])
        ids_out = to_tensor(out, place=dev)
        if not return_stats:
            return ids_out
        return ids_out, {"n_gen": int(gen.shape[1]),
                         "stop_reason": "eos" if stopped_on_eos
                         else "length"}

    def _host_loop(self, sig, B, S0, max_new_tokens, nxt, rng, eos):
        """One decode replay a token, its tokens read on the host (the JAX
        host loop). Returns the ``[B, n]`` generated ids and whether every
        row ended on eos."""
        dev = nxt.device
        tokens = nxt.cpu().numpy().reshape(B, 1)
        out = [tokens]
        done = (tokens[:, 0] == eos) if eos is not None \
            else np.zeros(B, bool)
        sampling = sig.temperature != 0.0
        for step in range(1, max_new_tokens):
            if eos is not None and done.all():
                break
            k, rng = split(rng) if sampling else (rng, rng)
            nxt = sig.decode(torch.from_numpy(tokens).to(dev),
                             torch.full((), S0 + step - 1, dtype=torch.int64,
                                        device=dev), k)
            tokens = nxt.cpu().numpy().reshape(B, 1)
            if eos is not None:
                # frozen rows keep emitting eos (HF/PaddleNLP padding)
                tokens = np.where(done[:, None], eos, tokens)
                done = done | (tokens[:, 0] == eos)
            out.append(tokens)
        return (np.concatenate(out, axis=1),
                bool(eos is not None and done.all()))

    def _device_loop(self, sig, caches, B, S0, max_new_tokens, temperature,
                     top_k, nxt, key, eos):
        """The JAX ``while_loop`` as one captured body replayed from the
        host (module docstring). Returns the ``[B, n]`` generated ids and
        whether every row ended on eos."""
        from .. import jit

        dev = nxt.device
        if sig.state is None:
            st = sig.state = {
                "buf": torch.zeros((B, max_new_tokens), dtype=torch.int64,
                                   device=dev),
                "i": torch.zeros((), dtype=torch.int64, device=dev),
                "key": torch.zeros(2, dtype=torch.int64, device=dev),
                "done": torch.zeros(B, dtype=torch.bool, device=dev),
                "eos": torch.zeros((), dtype=torch.int64, device=dev),
                "stop": torch.zeros((), dtype=torch.bool, device=dev)}
            sig.loop = jit.StaticFunction(
                self._loop_body(st, caches, B, S0, max_new_tokens,
                                temperature, top_k),
                observe=[self], warmup=False, dy2static=False)
        st = sig.state
        st["buf"].zero_()
        st["buf"][:, 0].copy_(nxt)
        st["i"].fill_(1)
        st["key"].copy_(key)
        st["eos"].fill_(-1 if eos is None else int(eos))
        has_eos = st["eos"] >= 0
        st["done"].copy_(has_eos & (nxt == st["eos"]))
        st["stop"].copy_(has_eos & st["done"].all())
        flag = event = None
        if eos is not None and dev.type == "cuda":
            flag = torch.zeros((), dtype=torch.bool, pin_memory=True)
            event = torch.cuda.Event()
        for r in range(1, max_new_tokens):
            sig.loop()
            if eos is None or r % CHECK_EVERY:
                continue
            if event is None:
                if bool(st["stop"]):
                    break
                continue
            if event.query() and bool(flag) and r > CHECK_EVERY:
                break
            flag.copy_(st["stop"], non_blocking=True)
            event.record()
        n = int(st["i"])
        return (st["buf"][:, :n].cpu().numpy(),
                bool((has_eos & st["done"].all()).item()))

    def _loop_body(self, st, caches, B, S0, max_new_tokens, temperature,
                   top_k):
        step_fn = self._step_fn(caches, temperature, top_k)

        def generate_device_loop():
            i, eos = st["i"], st["eos"]
            col = i.clamp(max=max_new_tokens - 1).expand(B, 1)
            tok = st["buf"].gather(1, (i - 1).expand(B, 1))
            key, sub = (split(st["key"]) if temperature != 0.0
                        else (st["key"], st["key"]))
            nxt = step_fn(tok, i + (S0 - 1), sub)
            has_eos = eos >= 0
            # the while_loop's condition, before this body
            active = (i < max_new_tokens) & ~(has_eos & st["done"].all())
            # frozen rows keep emitting eos (HF/PaddleNLP padding)
            nxt = torch.where(has_eos & st["done"], eos, nxt)
            done = st["done"] | (has_eos & (nxt == eos))
            st["buf"].scatter_(1, col, torch.where(
                active, nxt.view(B, 1), st["buf"].gather(1, col)))
            st["done"].copy_(torch.where(active, done, st["done"]))
            st["key"].copy_(torch.where(active, key, st["key"]))
            i.add_(active.to(torch.int64))
            st["stop"].copy_(~((i < max_new_tokens)
                               & ~(has_eos & st["done"].all())))

        return generate_device_loop
