"""paddle_tpu_torch.serving.wal and the router's durability against the
JAX package.

The disk format is shared: a log written by either package's
``RequestWAL`` replays in the other to an equal ``WalState`` (compared
field by field), the same records frame to the same bytes, and a torn or
bit-flipped tail truncates to the same last good frame in both, each
counting the damage in its own registry. A JAX router killed mid-stream
(its log left unsealed) is recovered by the port's router over port
engines (and the reverse): every stream completes bit-identical to the
uninterrupted JAX run, its seqs exactly-once across the death. The
models are ``tests/test_wal.py``'s tiny Llama, the JAX weights carried
into the port with ``load_reference_state_dict``.
"""
import importlib
import os
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from torch_router_common import one_thread  # noqa: F401 (autouse)

PACKAGES = ("paddle_tpu", "paddle_tpu_torch")
DIRECTIONS = [("paddle_tpu", "paddle_tpu_torch"),
              ("paddle_tpu_torch", "paddle_tpu")]
WIDTHS = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=1,
              num_key_value_heads=1, max_position_embeddings=64)
ENGINE_KW = dict(page_size=4, max_batch_slots=2, watchdog_stall_s=None)
_RNG = np.random.RandomState(20)
P5, P6, P7 = (_RNG.randint(1, 32, (n,)) for n in (5, 6, 7))


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _wal_cls(pkg):
    return _mod(pkg, "serving.wal").RequestWAL


def _counter(pkg, name, **labels):
    fam = _mod(pkg, "metrics").get_registry().get(name)
    if fam is None:
        return 0.0
    return (fam.labels(**labels) if labels else fam).value


def _state_sig(state):
    return (state.next_wal_id, state.sealed, sorted(
        (r.wal_id, r.model, tuple(r.prompt), r.max_new_tokens,
         r.temperature, r.eos_token_id, r.seed, r.priority, r.deadline_s,
         r.admit_walltime, r.adapter_id, r.grammar_key, r.prefix_cache,
         r.resume_from, tuple(r.tokens), r.fsm_state, r.outcome,
         r.superseded_by)
        for r in state.requests.values()))


def _admit(wal, wid, prompt=(3, 4, 5), max_new=6, **over):
    rec = dict(id=wid, model="m", prompt=list(prompt),
               max_new_tokens=max_new, temperature=0.0, eos=None,
               seed=7, priority=0, deadline_s=None, t=1700000000.25,
               adapter_id=None, grammar=None, prefix_cache=True,
               resume_from=None, tokens=[], fsm=None)
    rec.update(over)
    wal.append("admit", **rec)


def _fill(wal, n=6):
    """Records of every kind over ``n`` requests, committed in three
    groups (the corpus of the cross-replay tests)."""
    ids = [wal.new_id() for _ in range(n)]
    for i, wid in enumerate(ids):
        _admit(wal, wid, prompt=(3 + i, 4, 5 + i), max_new=6, seed=i,
               priority=i % 3, deadline_s=None if i % 2 else 4.5,
               adapter_id="acme" if i == 2 else None,
               grammar=["[ab]{1,4}", 32, 2] if i == 3 else None)
    wal.commit()
    for i, wid in enumerate(ids):
        wal.append("progress", id=wid, at=0, tokens=[1 + i, 2], seq=1,
                   fsm=None if i != 3 else 1)
    wal.append("progress", id=ids[0], at=2, tokens=[9], seq=2, fsm=None)
    wal.commit()
    wal.append("retire", id=ids[1], reason="stop")
    new = wal.new_id()
    wal.append("recover", old=ids[4], new=new)
    _admit(wal, new, prompt=(7, 8, 9), max_new=6, seed=4, resume_from=ids[4],
           tokens=[5, 2])
    wal.commit()
    return ids


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_log_replays_in_the_other_package(tmp_path, writer, reader):
    """Several segments (rotation at 256 bytes), every record kind: the
    reader's replay equals the writer's, and the reader appends on."""
    wal = _wal_cls(writer)(str(tmp_path), segment_bytes=256)
    _fill(wal)
    want = _state_sig(wal.replay())
    wal.close()
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".log")]) > 1
    other = _wal_cls(reader)(str(tmp_path), segment_bytes=256)
    assert _state_sig(other.replay()) == want
    other.append("retire", id=0, reason="length")
    other.seal()
    other.close()
    back = _wal_cls(writer)(str(tmp_path)).replay()
    assert back.sealed and back.requests[0].outcome == "length"


def test_same_records_frame_to_the_same_bytes(tmp_path):
    for pkg in PACKAGES:
        wal = _wal_cls(pkg)(str(tmp_path / pkg))
        _fill(wal)
        wal.seal()
        wal.close()
    a, b = (sorted(os.listdir(tmp_path / p)) for p in PACKAGES)
    assert a == b
    for name in a:
        assert (tmp_path / PACKAGES[0] / name).read_bytes() == \
            (tmp_path / PACKAGES[1] / name).read_bytes()


@pytest.mark.parametrize("damage", ["torn", "flip"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_damaged_tail_replays_alike(tmp_path, writer, reader, damage):
    """A partial last frame, or a flipped byte in the last record: the
    reader truncates to the same last good frame as the writer's own
    package would, and counts one corrupt record in its registry."""
    wal = _wal_cls(writer)(str(tmp_path / "log"))
    _fill(wal)
    whole = _state_sig(wal.replay())
    wal.close()
    seg = sorted(os.listdir(tmp_path / "log"))[-1]
    path = tmp_path / "log" / seg
    blob = bytearray(path.read_bytes())
    if damage == "torn":
        blob = blob[:-7]
    else:
        blob[-3] ^= 0x40
    states = {}
    for pkg in (writer, reader):
        d = tmp_path / pkg
        d.mkdir()
        (d / seg).write_bytes(bytes(blob))
        before = _counter(pkg, "paddle_tpu_wal_corrupt_records_total")
        w = _wal_cls(pkg)(str(d))
        states[pkg] = _state_sig(w.replay())
        w.close()
        assert _counter(pkg, "paddle_tpu_wal_corrupt_records_total") \
            - before == 1
    assert states[reader] == states[writer]
    # the last record (the recovered incarnation's admit) is gone
    assert states[reader] != whole
    assert len(states[reader][2]) == len(whole[2]) - 1


# ───────────────────── routers across a process death ─────────────────────


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return {"paddle_tpu": jm, "paddle_tpu_torch": tm}


def _router(pkg, models, replicas, wal_dir=None):
    r = _mod(pkg, "serving").Router(wal_dir=wal_dir)
    kw = dict(ENGINE_KW, **({"device": "cpu"} if pkg != "paddle_tpu"
                            else {}))
    r.add_model("m", models[pkg], replicas=replicas, **kw)
    return r


def _collect(store, key):
    def cb(rid, tok, fin, seq):
        store.setdefault(key, []).append((int(seq), tok, fin))
    return cb


def _tokens(chunks):
    return [t for _s, t, _f in chunks if t is not None]


def _drain(router, limit=300):
    steps = 0
    while router.has_work:
        router.step()
        steps += 1
        assert steps < limit
    return steps


SPECS = (("a", P5, 0.8, 20), ("b", P6, 0.0, 21), ("c", P7, 1.1, 22))


def _submit_all(r, chunks):
    wids = {}
    for key, p, temp, seed in SPECS:
        rid = r.submit(p, "m", max_new_tokens=8, temperature=temp,
                       seed=seed, stream_cb=_collect(chunks, key))
        wids[key] = r.wal_id_of(rid)
    return wids


@pytest.fixture(scope="module")
def reference(models):
    """The uninterrupted WAL-off JAX run."""
    r = _router("paddle_tpu", models, replicas=1)
    chunks = {}
    _submit_all(r, chunks)
    _drain(r)
    assert any(len(set(_tokens(c))) > 1 for c in chunks.values())
    return chunks


@pytest.mark.parametrize("crashed_pkg,survivor_pkg", DIRECTIONS)
def test_router_recovers_the_other_packages_log(tmp_path, models,
                                                reference, crashed_pkg,
                                                survivor_pkg):
    """A two-engine router of one package dies after three steps (no
    shutdown, no seal); a one-engine router of the other package
    recovers its log. Every stream: pre-death chunks + post-recovery
    chunks are seqs 0..n-1 with one terminal chunk, and its tokens equal
    the uninterrupted JAX run's."""
    crashed = _router(crashed_pkg, models, 2, wal_dir=str(tmp_path))
    pre = {}
    wids = _submit_all(crashed, pre)
    for _ in range(3):
        crashed.step()
    assert crashed.has_work
    crashed._wal.close()           # the process dies: unsealed, no drain
    del crashed

    survivor = _router(survivor_pkg, models, 1, wal_dir=str(tmp_path))
    out = survivor.recover()
    assert {o["outcome"] for o in out.values()} == {"resumed"}
    assert len(out) == len(SPECS)
    post = {}
    for key, *_rest in SPECS:
        last = max((s for s, _t, _f in pre.get(key, ())), default=-1)
        survivor.attach_stream(wids[key], _collect(post, key),
                               after_seq=last)
    _drain(survivor)
    survivor.shutdown()
    for key, *_rest in SPECS:
        merged = pre.get(key, []) + post[key]
        assert [s for s, _t, _f in merged] == list(range(len(merged)))
        assert [f for _s, _t, f in merged if f] == [merged[-1][2]]
        assert _tokens(merged) == _tokens(reference[key])
    wal = _wal_cls(crashed_pkg)(str(tmp_path))
    state = wal.replay()
    wal.close()
    assert state.sealed and not state.pending()


def test_port_wal_on_streams_and_one_fsync_per_step(tmp_path, models,
                                                    reference):
    r = _router("paddle_tpu_torch", models, 1, wal_dir=str(tmp_path))
    chunks = {}
    _submit_all(r, chunks)
    fam = _mod("paddle_tpu_torch", "metrics").get_registry().get(
        "paddle_tpu_wal_fsync_seconds")
    before = fam.count
    steps = _drain(r)
    assert 0 < fam.count - before <= steps
    r.shutdown()
    assert chunks == reference
    wal = _wal_cls("paddle_tpu")(str(tmp_path))
    assert wal.replay().sealed
    wal.close()


@pytest.mark.parametrize("case", ["completed", "expired", "failed"])
def test_engine_free_recover_outcomes_match(tmp_path, models, case):
    """The recovery dispositions that need no decode, through both
    routers on the same hand-written journal: the same outcome, the same
    redelivered chunks and the same retire record."""
    results = {}
    for pkg in PACKAGES:
        d = str(tmp_path / pkg)
        wal = _wal_cls(pkg)(d)
        wid = wal.new_id()
        if case == "completed":
            _admit(wal, wid, prompt=(3, 4), max_new=3, tokens=[7, 8, 9])
        elif case == "expired":
            _admit(wal, wid, deadline_s=0.5, t=time.time() - 10.0)
        else:
            _admit(wal, wid, model="ghost")
        wal.commit()
        wal.close()
        r = _router(pkg, models, 1, wal_dir=d)
        out = r.recover()[wid]
        got = {}
        r.attach_stream(wid, _collect(got, "x"))
        r.shutdown()
        w = _wal_cls(pkg)(d)
        outcome = w.replay().requests[wid].outcome
        w.close()
        results[pkg] = (out["outcome"], out.get("finish_reason"),
                        got.get("x"), outcome)
    assert results["paddle_tpu_torch"] == results["paddle_tpu"]
    assert results["paddle_tpu"][0] == case


@pytest.mark.parametrize("crashed_pkg", ["paddle_tpu", "paddle_tpu_torch"])
def test_recover_replays_a_retired_streams_unseen_tail(tmp_path, models,
                                                       reference,
                                                       crashed_pkg):
    """The restart drill's lost chunks (ROADMAP Queue 3 item 1): a router
    commits a stream's last tokens and its retire record to the WAL
    before it emits them (commit-then-emit), and its process dies in
    between, so the client saw seqs 0-1 only. A port router recovering
    that log (either package's) finds nothing pending, and a client
    re-attaching after seq 1 must get the rest from the journal: seqs
    2..n with one terminal chunk, the tokens of the uninterrupted run."""
    crashed = _router(crashed_pkg, models, 2, wal_dir=str(tmp_path))
    seen = {}

    def emitted(key):
        cb = _collect(seen, key)
        return lambda rid, tok, fin, seq: (cb(rid, tok, fin, seq)
                                           if seq <= 1 else None)

    wids = {}
    for key, p, temp, seed in SPECS:
        rid = crashed.submit(p, "m", max_new_tokens=8, temperature=temp,
                             seed=seed, stream_cb=emitted(key))
        wids[key] = crashed.wal_id_of(rid)
    _drain(crashed)
    crashed._wal.close()           # dies before the emits reach the client
    del crashed

    survivor = _router("paddle_tpu_torch", models, 1, wal_dir=str(tmp_path))
    assert survivor.recover() == {}
    post = {}
    for key, *_rest in SPECS:
        survivor.attach_stream(wids[key], _collect(post, key), after_seq=1)
    assert not survivor.has_work
    survivor.shutdown()
    for key, *_rest in SPECS:
        merged = seen[key] + post.get(key, [])
        assert [s for s, _t, _f in merged] == list(range(len(merged)))
        assert [f for _s, _t, f in merged if f] == [merged[-1][2]]
        assert _tokens(merged) == _tokens(reference[key])
