"""Shared pieces of the router parity tests (``test_torch_router*.py``):
one package's serving stack as a :class:`Side`, both sides over the same
weights, and the drill helpers."""
import importlib
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny,
                                     load_reference_state_dict)

LLAMA = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)
GPT = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_dropout_prob=0.0)
_RNG = np.random.RandomState(7)
P5, P9, P3, P4 = (_RNG.randint(0, 128, (n,)) for n in (5, 9, 3, 4))


@dataclass
class Side:
    """One package's serving stack and its models (same weights)."""
    name: str
    serving: object
    faults: object
    metrics: object
    models: dict
    kw: dict = field(default_factory=dict)

    def router(self, **kw):
        return self.serving.Router(**kw)

    def add(self, router, model_id, which="llama", **kw):
        return router.add_model(model_id, self.models[which],
                                **kw, **self.kw)

    def engine(self, which="llama", **kw):
        return self.serving.ServingEngine(self.models[which], **kw,
                                          **self.kw)

    def counter(self, name, **labels):
        fam = self.metrics.get_registry().get(name)
        if fam is None:
            return 0.0
        if labels and set(labels) != set(fam.label_names):
            return fam.sum_labels(**labels)
        return (fam.labels(**labels) if labels else fam).value


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Autouse where imported: the port's many small steps run on one
    intra-op thread (tiny tensors gain nothing from more, and beside
    other test processes the threads' contention costs more than the
    work), and so do the child processes a drill spawns."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(n)


def _carry(jm, tm):
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return tm


def make_sides():
    """Both packages' stacks over the same tiny Llama and GPT weights."""
    paddle.seed(0)
    jl = JaxLlama(jax_llama_tiny(**LLAMA))
    paddle.seed(1)
    jg = JaxGPT(jax_gpt_tiny(**GPT))
    tl = _carry(jl, LlamaForCausalLM(llama_tiny(**LLAMA), device="cpu"))
    tg = _carry(jg, GPTForCausalLM(gpt_tiny(**GPT), device="cpu"))
    mods = {p: [importlib.import_module(f"{p}.{m}")
                for m in ("serving", "faults", "metrics")]
            for p in ("paddle_tpu", "paddle_tpu_torch")}
    return (Side("paddle_tpu", *mods["paddle_tpu"],
                 {"llama": jl, "gpt": jg}),
            Side("paddle_tpu_torch", *mods["paddle_tpu_torch"],
                 {"llama": tl, "gpt": tg}, {"device": "cpu"}))


def no_leaked_faults():
    """Generator body of the test files' autouse fixture: no armed fault
    survives a test, in either package."""
    mods = [importlib.import_module(f"{p}.faults")
            for p in ("paddle_tpu", "paddle_tpu_torch")]
    for m in mods:
        m.reset()
    yield
    for m in mods:
        assert m.active_faults() == []
        m.reset()


def _both(sides, drill, **kw):
    want = drill(sides[0], **kw)
    got = drill(sides[1], **kw)
    assert got == want
    return got


def _trip(engine):
    engine.watchdog.end_step(engine.watchdog.stall_threshold_s + 1.0)


def _chunk_cb(store, i):
    return lambda rid, tok, fin, seq: store[i].append((seq, tok, fin))


def _streams(outs, rids):
    return [(outs[r].finish_reason, list(outs[r].token_ids)) for r in rids]


