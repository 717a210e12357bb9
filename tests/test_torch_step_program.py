"""The port's step program per token-grid bucket against the JAX engine.

The JAX engine compiles one program per token-grid bucket; the port
builds one ``_StepProgram`` per bucket (a CUDA graph on a card, the same
program run eagerly here). ``compile_counts()`` must equal the JAX
engine's over the same churning workload, with and without
``min_step_tokens``, and the streams must stay token-identical. The
fixed-shape sampler must equal the per-row draw the port used before it
bit for bit. A capture that fails raises, and nothing runs eagerly in
its place.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving import sampling as S
from torch_suite import one_torch_thread  # noqa: F401

WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
ENGINE = dict(page_size=4, max_batch_slots=3, token_budget=24)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _churn(engine):
    """Requests of 3-30 prompt tokens joining mid-decode and retiring at
    different times, so steps take the slot grid, 16 and 32 rows."""
    rng = np.random.RandomState(11)
    lens = [5, 20, 3, 30, 9, 14, 2]
    rids, streams = [], {}
    for i, n in enumerate(lens):
        rids.append(engine.add_request(rng.randint(0, 128, n),
                                       max_new_tokens=4 + i % 3,
                                       temperature=0.8 if i % 2 else 0.0,
                                       seed=i))
        if i % 2:
            engine.step()
            streams.update(engine.take_outputs())
    streams.update(engine.run())
    return [streams[r].token_ids for r in rids]


@pytest.mark.parametrize("min_step_tokens", [None, 16, 24])
def test_compile_counts_match_jax(models, min_step_tokens):
    jm, tm = models
    jeng = JaxEngine(jm, min_step_tokens=min_step_tokens, **ENGINE)
    teng = ServingEngine(tm, min_step_tokens=min_step_tokens, device="cpu",
                         **ENGINE)
    want = _churn(jeng)
    assert _churn(teng) == want
    assert teng.compile_counts() == jeng.compile_counts()
    assert teng._grid_buckets_seen == jeng._grid_buckets_seen
    counts = teng.compile_counts()
    assert counts["step"] == counts["step_buckets"]
    if min_step_tokens is None:
        assert teng._grid_buckets_seen == {3, 16, 32}
    else:  # the floor freezes every step that fits it to one shape
        assert min(teng._grid_buckets_seen) == min_step_tokens
    assert teng.pool.used_pages == 0


def test_step_program_buffers_are_static(models):
    """A bucket's program keeps its buffers (their addresses) across
    steps, and each step's host arrays land in them."""
    _jm, tm = models
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    eng.add_request(np.arange(1, 8), max_new_tokens=6)
    eng.step()  # the prompt: bucket 16
    eng.step()  # a decode row: the slot grid, 3
    progs = dict(eng._programs)
    ptrs = {T: p._buf.data_ptr() for T, p in progs.items()}
    batch = eng._plan()
    prog = eng._programs[batch.tok.size]
    prog.stage(batch)
    np.testing.assert_array_equal(prog.dev["tok"].numpy(), batch.tok)
    np.testing.assert_array_equal(
        prog.dev["tok_bt"].numpy().reshape(batch.tok_bt.shape), batch.tok_bt)
    np.testing.assert_array_equal(prog.dev["temps"].numpy(), batch.temps)
    eng.run()
    assert {T: p._buf.data_ptr() for T, p in eng._programs.items()
            if T in ptrs} == ptrs
    assert all(eng._programs[T] is p for T, p in progs.items())


def _per_row_sample(logits, temps, seeds, positions):
    """The draw the port used before the step was captured: greedy, then
    categorical noise for the rows with t > 0 only, chosen on the host."""
    out = torch.argmax(logits, dim=-1)
    rows = [i for i, t in enumerate(temps) if t > 0]
    if not rows:
        return out
    idx = torch.tensor(rows, dtype=torch.int64)
    t = torch.tensor([max(float(temps[i]), 1e-6) for i in rows],
                     dtype=torch.float32)
    keys = S.fold_in(S.prng_key(torch.tensor([int(seeds[i]) for i in rows])),
                     torch.tensor([int(positions[i]) for i in rows]))
    out[idx] = S.categorical(keys, logits[idx] / t[:, None])
    return out


_TEMPS = st.one_of(st.just(0.0), st.just(1e-9),
                   st.floats(0.125, 4.0, width=32),
                   st.floats(1e-7, 1e-3))


@settings(max_examples=40, deadline=None)
@given(temps=st.lists(_TEMPS, min_size=1, max_size=10),
       seed=st.integers(0, 2**31 - 1))
def test_fixed_shape_sampler_matches_per_row_draw(temps, seed):
    rng = np.random.default_rng(seed)
    n = len(temps)
    logits = torch.from_numpy(
        (rng.standard_normal((n, 96)) * 3).astype(np.float32))
    t = np.asarray(temps, np.float32)
    seeds = rng.integers(-2**31, 2**31, n).astype(np.int32)
    pos = rng.integers(0, 4096, n).astype(np.int32)
    want = _per_row_sample(logits, t, seeds, pos)
    got = S.sample(logits, torch.from_numpy(t), torch.from_numpy(seeds),
                   torch.from_numpy(pos))
    assert torch.equal(got, want)


def test_capture_failure_raises(models, monkeypatch):
    """The capture path, driven here with the CUDA calls faked and the
    capture itself failing: the step raises, no program is counted and
    no token lands (nothing ran in its place)."""
    _jm, tm = models
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    eng._graphed = True

    class _Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

    class _Ctx:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def failing_graph(*a, **k):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", _Ctx)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Ctx)
    monkeypatch.setattr(torch.cuda, "graph", failing_graph)
    eng.add_request(np.arange(1, 6), max_new_tokens=3)
    with pytest.raises(RuntimeError, match="capture of the serving step"):
        eng.step()
    assert eng.compile_counts() == {"step": 0, "step_buckets": 1}
    assert eng.stats["generated_tokens"] == 0
    assert eng.slots[0].gen == []


def test_k4_takes_a_callers_workspace(monkeypatch):
    """K4's wrapper on meta tensors, launch stubbed: with a workspace of
    at least ``workspace_numel`` elements it allocates none; a smaller
    one is refused before any launch."""
    T, nh, nkv, hd, page, pps = 8, 16, 16, 128, 16, 128
    meta = torch.device("meta")
    q = torch.empty((T, nh, hd), device=meta)
    kp = torch.empty((100, page, nkv, hd), dtype=torch.bfloat16, device=meta)
    bt = torch.empty((T, pps), dtype=torch.int32, device=meta)
    lens = torch.empty((T,), dtype=torch.int32, device=meta)
    need = tpa.workspace_numel(T, nh, nkv, hd, page, pps)
    plan = tpa.launch_plan(T, nh, nkv, page, pps)
    assert need == plan.n_split * T * nh * (hd + 2) > 0
    assert tpa.workspace_numel(1024, nh, nkv, hd, page, pps) == 0  # no split
    launched = []
    monkeypatch.setattr(tpa, "_launch",
                        lambda device, *args: launched.append(args) or 0)
    ws = torch.empty(need, dtype=torch.float32, device=meta)
    real_empty = torch.empty
    sizes = []
    monkeypatch.setattr(torch, "empty",
                        lambda *s, **k: sizes.append(s) or real_empty(*s, **k))
    tpa._paged_attention_cuda(q, kp, torch.empty_like(kp), bt, lens,
                              hd ** -0.5, None, None, workspace=ws)
    assert len(launched) == 1 and (need,) not in sizes
    with pytest.raises(ValueError, match="workspace"):
        tpa._paged_attention_cuda(q, kp, torch.empty_like(kp), bt, lens,
                                  hd ** -0.5, None, None,
                                  workspace=ws[:need - 1])
    assert len(launched) == 1


def test_replay_counts():
    tpa.reset_counters()
    tpa.count_replays(12)
    tpa.count_replays(12)
    assert (tpa.kernel_launches, tpa.captured_launches,
            tpa.replayed_launches, tpa.plain_calls) == (0, 0, 24, 0)
    tpa.reset_counters()
    assert tpa.replayed_launches == 0


def test_engine_module_imports_no_cuda_state():
    """Building an engine off the card creates no graph pool."""
    assert engine_mod.ServingEngine is ServingEngine
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    assert eng._graphed is False and eng._graph_pool is None
    assert eng.capture_seconds() == {}
