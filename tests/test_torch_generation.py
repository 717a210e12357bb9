"""paddle_tpu_torch.models.generation against the JAX package's
``GenerationMixin.generate`` (``tests/test_generation.py`` and
``tests/test_generate_device_loop.py`` of the JAX package).

Tiny f32 GPT and Llama (GQA) are built from the JAX package's seed and
carried across with ``load_reference_state_dict``; the same numpy
prompts go through both packages' ``generate``. Token streams are
compared exactly: greedy, and sampled at t 0.8 with top_k 0 and 5, in
each loop (the two loops draw different keys, so each is held to its
own JAX loop). ``split`` is held to ``jax.random.split`` bit for bit.
Logits are compared at f32 atol = rtol = 1e-5 (summation orders of
XLA's CPU products against torch's).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.metrics import get_registry
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     generation, gpt_tiny, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.serving.sampling import prng_key, split

TOL = 1e-5
PROMPT = np.random.RandomState(0).randint(0, 128, (2, 8))
WIDTHS = {
    "gpt": dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_dropout_prob=0.0),
    "llama": dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                  num_key_value_heads=2, max_position_embeddings=64),
}
BUILD = {"gpt": (JaxGPT, jax_gpt_tiny, GPTForCausalLM, gpt_tiny),
         "llama": (JaxLlama, jax_llama_tiny, LlamaForCausalLM, llama_tiny)}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(name):
    jcls, jcfg, tcls, tcfg = BUILD[name]
    pt.seed(0)
    jm = jcls(jcfg(**WIDTHS[name]))
    tm = tcls(tcfg(**WIDTHS[name]), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return {name: _pair(name) for name in BUILD}


def _jax(jm, prompt, **kw):
    return np.asarray(jm.generate(pt.to_tensor(prompt), **kw).numpy())


def _port(tm, prompt, **kw):
    return tm.generate(prompt, **kw).numpy()


@pytest.mark.parametrize("seed", [0, 3, 77, 2**31 - 1])
def test_split_equals_jax_random_split(seed):
    key = jax.random.PRNGKey(seed)
    ours = prng_key(torch.tensor(seed))
    for _ in range(4):
        want = np.asarray(jax.random.split(key)).astype(np.int64)
        got = split(ours)
        np.testing.assert_array_equal(got.numpy(), want)
        key, ours = jax.random.split(key)[1], got[1]


@pytest.mark.parametrize("device_loop", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 0), (0.8, 5)],
                         ids=["greedy", "t0.8", "t0.8_top5"])
@pytest.mark.parametrize("name", sorted(BUILD))
def test_streams_equal_the_jax_package(models, name, temperature, top_k,
                                       device_loop):
    jm, tm = models[name]
    kw = dict(max_new_tokens=6, temperature=temperature, top_k=top_k,
              seed=3, device_loop=device_loop)
    want = _jax(jm, PROMPT, **kw)
    got = _port(tm, PROMPT, **kw)
    assert got.dtype == np.int64 and got.shape == (2, 14)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(BUILD))
def test_loops_equal_when_greedy_and_differ_when_sampled(models, name):
    """The JAX loops split their keys differently: sampled streams differ
    between the loops (in both packages), greedy ones do not."""
    _jm, tm = models[name]
    ids = np.random.default_rng(3).integers(0, 128, (2, 8))
    kw = dict(max_new_tokens=12, temperature=0.0)
    np.testing.assert_array_equal(_port(tm, ids, device_loop=False, **kw),
                                  _port(tm, ids, device_loop=True, **kw))
    kw = dict(max_new_tokens=12, temperature=0.8, seed=1)
    host = _port(tm, ids, device_loop=False, **kw)
    dev = _port(tm, ids, device_loop=True, **kw)
    assert not np.array_equal(host, dev)
    np.testing.assert_array_equal(host, _port(tm, ids, device_loop=False,
                                              **kw))
    assert not np.array_equal(host, _port(tm, ids, device_loop=False,
                                          **dict(kw, seed=2)))


def _full_forward_greedy(tm, prompt, n):
    cur = prompt.copy()
    for _ in range(n):
        with torch.no_grad():
            logits = tm(torch.from_numpy(cur))
        nxt = logits[:, -1].argmax(-1).numpy()
        cur = np.concatenate([cur, nxt[:, None]], axis=1)
    return cur


@pytest.mark.parametrize("name", sorted(BUILD))
def test_greedy_cache_decode_matches_full_forward(models, name):
    _jm, tm = models[name]
    out = _port(tm, PROMPT, max_new_tokens=6, temperature=0.0)
    np.testing.assert_array_equal(out, _full_forward_greedy(tm, PROMPT, 6))


@pytest.mark.parametrize("name", sorted(BUILD))
def test_cached_logits_equal_the_full_forward(models, name):
    """The KV-cache trunk, prefill then one token at a time at a device
    ``cur_len``, gives the full forward's logits at every position."""
    _jm, tm = models[name]
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 12)))
    with torch.no_grad():
        full = tm(ids)
        caches = tm._kv_caches(2, 12, torch.device("cpu"))
        trunk = tm._decode_trunk()
        h, _ = trunk(ids[:, :8], caches=caches, cur_len=torch.tensor(0))
        steps = [tm.logits(h)]
        for p in range(8, 12):
            h, _ = trunk(ids[:, p:p + 1], caches=caches,
                         cur_len=torch.tensor(p))
            steps.append(tm.logits(h))
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=TOL, atol=TOL)


def test_eos_early_exit_in_both_loops(models):
    """B = 1, so the first eos ends the call: both loops stop at the same
    shortened length, as the JAX package's do, with ``stop_reason``."""
    jm, tm = models["gpt"]
    ids = np.random.default_rng(5).integers(0, 128, (1, 8))
    full = _port(tm, ids, max_new_tokens=10, temperature=0.0)
    eos = int(full[0, 8 + 3])
    want = _jax(jm, ids, max_new_tokens=10, temperature=0.0,
                eos_token_id=eos, device_loop=False)
    assert want.shape[1] < full.shape[1]
    for dl in (False, True):
        out, stats = tm.generate(ids, max_new_tokens=10, temperature=0.0,
                                 eos_token_id=eos, device_loop=dl,
                                 return_stats=True)
        np.testing.assert_array_equal(out.numpy(), want)
        assert stats == {"n_gen": want.shape[1] - 8, "stop_reason": "eos"}
    _out, stats = tm.generate(ids, max_new_tokens=10, temperature=0.0,
                              return_stats=True)
    assert stats == {"n_gen": 10, "stop_reason": "length"}


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_per_row_eos_freeze(models, check_every, monkeypatch):
    """A row that emits eos pads with it while the other keeps going;
    equal in both loops and to the JAX package, however often the device
    loop reads its stop flag."""
    monkeypatch.setattr(generation, "CHECK_EVERY", check_every)
    jm, tm = models["gpt"]
    ids = np.random.default_rng(3).integers(0, 128, (2, 8))
    full = _port(tm, ids, max_new_tokens=10, temperature=0.0)
    gen = full[:, 8:]
    eos = next(int(t) for t in gen[0] if t not in gen[1])
    want = _jax(jm, ids, max_new_tokens=10, temperature=0.0,
                eos_token_id=eos, device_loop=True)
    for dl in (False, True):
        got = _port(tm, ids, max_new_tokens=10, temperature=0.0,
                    eos_token_id=eos, device_loop=dl)
        np.testing.assert_array_equal(got, want)
    row0 = want[0, 8:]
    first = int(np.argmax(row0 == eos))
    assert (row0[first:] == eos).all()
    np.testing.assert_array_equal(want[1], full[1, :want.shape[1]])


def test_every_row_done_at_the_prefill(models):
    """eos equal to every row's first token: both loops return the one
    prefill token."""
    jm, tm = models["llama"]
    ids = np.tile(PROMPT[:1], (2, 1))
    first = int(_port(tm, ids, max_new_tokens=1, temperature=0.0)[0, -1])
    want = _jax(jm, ids, max_new_tokens=5, temperature=0.0,
                eos_token_id=first, device_loop=True)
    assert want.shape == (2, 9)
    for dl in (False, True):
        np.testing.assert_array_equal(
            _port(tm, ids, max_new_tokens=5, temperature=0.0,
                  eos_token_id=first, device_loop=dl), want)


def test_context_overflow_raises(models):
    _jm, tm = models["gpt"]
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.generate(PROMPT, max_new_tokens=100)


def test_programs_are_kept_per_signature():
    """One prefill and one decode program a signature, reused by later
    calls; a new prompt length is a new signature. Mode and metrics as
    the JAX package's."""
    tm = GPTForCausalLM(gpt_tiny(**WIDTHS["gpt"]), device="cpu", seed=0)
    reg = get_registry()
    tokens = reg.counter("paddle_tpu_generate_tokens_total")
    before = tokens.value
    tm.train()
    for _ in range(3):
        tm.generate(PROMPT, max_new_tokens=4, temperature=0.0,
                    device_loop=False)
    assert tm.training
    tm.generate(PROMPT[:, :5], max_new_tokens=3, temperature=0.0)
    progs = tm._generation_programs
    assert sorted(progs) == [(2, 5, 8, 0.0, 0), (2, 8, 12, 0.0, 0)]
    sig = progs[(2, 8, 12, 0.0, 0)]
    assert sig.prefill.compile_counts() == {"signatures": 1, "captured": 1,
                                            "calls": 3}
    assert sig.decode.compile_counts() == {"signatures": 1, "captured": 1,
                                           "calls": 9}
    assert tokens.value - before == 2 * (3 * 4 + 3)
    assert reg.get("paddle_tpu_generate_seconds") is not None


def test_device_loop_state_stays_on_the_model_device(models):
    _jm, tm = models["llama"]
    tm.generate(PROMPT, max_new_tokens=4, temperature=0.8, device_loop=True)
    sig = tm._generation_programs[(2, 8, 12, 0.8, 0)]
    assert {t.device.type for t in sig.state.values()} == {"cpu"}
    assert sig.loop.compile_counts()["calls"] == 3
    caches = tm._generation_caches[(2, 12, torch.device("cpu"))]
    assert caches[0][0].shape == (2, 12, 2, 16)  # kv heads, pre-repeat
    assert caches[0][0].dtype == torch.float32
