"""The port's constrained decoding against the JAX package's.

``paddle_tpu_torch/serving/grammar.py`` is the JAX module's numpy code,
copied: for every pattern and schema of the JAX grammar tests its masks
and transition tables must be array-equal to ``GrammarFSM.compile``'s,
and it must refuse the same bad patterns. In the engines the grammar
rides the step as data (one interned table; each sample row masks its
logits at its DFA state), so constrained streams, with and without
speculative drafts, must equal the JAX engine's token for token, with
the same count of drafts cut at the grammar and of tokens landed under
it. Interning shares and releases table rows as the JAX engine does,
and the port writes them into one device table whose storage never
moves.
"""
import json

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import GrammarFSM as JaxFSM
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import schema_to_regex as jax_schema_to_regex
from paddle_tpu.serving import toy_tokenizer as jax_toy_tokenizer
from paddle_tpu.serving.grammar import _dfa as jax_dfa
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.serving import (GrammarFSM, ServingEngine,
                                      schema_to_regex, toy_tokenizer)
from paddle_tpu_torch.serving.grammar import _dfa

WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
PROMPTS = [np.random.RandomState(17).randint(0, 128, (n,)) for n in (5, 9, 3)]

# the patterns and schemas of tests/test_grammar.py
PATTERNS = ["abc", "a|bc", "ab*", "ab+c", "ab?c", "a{3}", "a{2,4}", "a{2,}",
            "[a-c]{2}", "[^a-y]", "(ab|cd)+", "x.z", "\\d{1,2}", "\\w+",
            "\\[\\d\\]", "", "ab|a\\nc", "[ab]{1,4}", "[ab]{1,12}"]
SCHEMAS = [
    {"type": "boolean"}, {"type": "null"}, {"type": "integer"},
    {"type": "number"}, {"const": {"ok": 1}}, {"enum": ["red", "green"]},
    {"type": "string", "maxLength": 5},
    {"type": "object", "properties": {"a": {"type": "integer"},
                                      "b": {"type": "boolean"}}},
    {"type": "array", "items": {"type": "integer"}, "minItems": 1,
     "maxItems": 3},
    {"type": "object", "properties": {"n": {"type": "integer"},
                                      "t": {"type": "boolean"}}},
]
BAD = ["(ab", "ab)", "[ab", "*a", "a{4,2}", "[z-a]", "a\\", "a\\nb"]


def _equal_fsms(got, want):
    assert got.pattern == want.pattern and got.key == want.key
    np.testing.assert_array_equal(got.mask_table, want.mask_table)
    np.testing.assert_array_equal(got.token_next, want.token_next)
    assert all(got.is_accepting(s) == want.is_accepting(s)
               and got.is_complete(s) == want.is_complete(s)
               for s in range(want.n_states))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regex_tables_equal_jax(pattern):
    tok, jtok = toy_tokenizer(96, eos_token_id=95), jax_toy_tokenizer(96, 95)
    _equal_fsms(GrammarFSM.compile(pattern, tok),
                JaxFSM.compile(pattern, jtok))


@pytest.mark.parametrize("schema", SCHEMAS, ids=lambda s: json.dumps(s))
def test_schema_tables_equal_jax(schema):
    assert schema_to_regex(schema) == jax_schema_to_regex(schema)
    tok, jtok = toy_tokenizer(96, eos_token_id=95), jax_toy_tokenizer(96, 95)
    got = GrammarFSM.compile(schema, tok)
    _equal_fsms(got, JaxFSM.compile(schema, jtok))
    rng = np.random.default_rng(1)
    walk = [int(rng.choice(got.allowed(0)[got.allowed(0) != 95]))]
    assert got.advance(0, walk) == got.next_state(0, walk[0])
    assert got.validates(walk) == JaxFSM.compile(schema, jtok).validates(walk)


@pytest.mark.parametrize("pattern", BAD)
def test_bad_patterns_refused_as_jax(pattern):
    with pytest.raises(ValueError) as want:
        jax_dfa(pattern)
    with pytest.raises(ValueError) as got:
        _dfa(pattern)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


class _Mixed:
    """Drafts 'a', 'b', then a space (never in ``[ab]``): the grammar
    cuts every burst of three after its second token."""

    def propose(self, ids, k):
        return np.array([65, 66, 0][:k], np.int32)


def _constrained(engine, pattern_tok, temperature):
    fsm_cls, tok = pattern_tok
    fsms = [fsm_cls.compile("[ab]{1,12}", tok),
            fsm_cls.compile({"type": "object", "properties": {
                "n": {"type": "integer"}, "t": {"type": "boolean"}}}, tok)]
    rids = []
    for i, p in enumerate(PROMPTS + PROMPTS[:1]):
        rids.append(engine.add_request(
            p, max_new_tokens=24, temperature=temperature, seed=30 + i,
            grammar=None if i == 2 else fsms[i % 2]))
        if i == 1:
            engine.step()
    out = engine.run()
    return [out[r] for r in rids], fsms


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("drafts", ["none", "ngram", "cut"])
def test_constrained_streams_match_jax(models, temperature, drafts):
    jm, tm = models
    kw = dict(page_size=4, max_batch_slots=3, token_budget=16)
    if drafts == "ngram":
        kw["spec_k"] = 2
    elif drafts == "cut":
        kw["drafter"] = _Mixed()
        kw["spec_k"] = 3
    jeng = JaxEngine(jm, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    want, _ = _constrained(jeng, (JaxFSM, jax_toy_tokenizer(128)),
                           temperature)
    got, fsms = _constrained(teng, (GrammarFSM, toy_tokenizer(128)),
                             temperature)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert [o.finish_reason for o in got] == [o.finish_reason for o in want]
    for o, f in zip(got, fsms + [None, fsms[1]]):
        if f is not None:
            assert f.validates(o.token_ids)
    assert teng.stats["grammar_filtered_drafts"] == \
        jeng._m_grammar_filtered.value
    assert teng.stats["grammar_tokens"] == jeng._m_grammar_tokens.value
    assert (teng.stats["spec_drafted"], teng.stats["spec_accepted"]) == (
        jeng._m_spec_drafted.value, jeng._m_spec_accepted.value)
    assert teng.compile_counts() == jeng.compile_counts()
    if drafts == "cut":
        assert teng.stats["grammar_filtered_drafts"] > 0
        assert teng.stats["spec_accepted"] > 0
    assert teng._grammar_segments == {} and teng.pool.used_pages == 0


def _segments(eng):
    return {k: s[:3] for k, s in eng._grammar_segments.items()}


def test_interning_shared_and_released_as_jax(models):
    jm, tm = models
    snaps = {}
    for pkg, eng, fsm_cls, tok in (
            ("jax", JaxEngine(jm, page_size=4, max_batch_slots=4),
             JaxFSM, jax_toy_tokenizer(128)),
            ("torch", ServingEngine(tm, page_size=4, max_batch_slots=4,
                                    device="cpu"),
             GrammarFSM, toy_tokenizer(128))):
        ptr = None if pkg == "jax" else eng._grammar_dev.data_ptr()
        short = fsm_cls.compile("[ab]{1,4}", tok)
        long_ = fsm_cls.compile("[ab]{1,9}", tok)
        seen = []
        for p in PROMPTS:  # one pattern, one segment, three references
            eng.add_request(p, max_new_tokens=4, grammar=short)
        eng.step()
        seen.append(_segments(eng))
        rid = eng.add_request(PROMPTS[0], max_new_tokens=12, grammar=long_)
        eng.step()
        seen.append(_segments(eng))
        seen.append(np.asarray(eng._grammar_table).copy())
        outs = eng.run()
        seen.append(_segments(eng))
        seen.append(np.asarray(eng._grammar_table).copy())
        seen.append(outs[rid].token_ids)
        if ptr is not None:
            assert eng._grammar_dev.data_ptr() == ptr
            np.testing.assert_array_equal(eng._grammar_dev.numpy(),
                                          eng._grammar_table)
        snaps[pkg] = seen
    got, want = snaps["torch"], snaps["jax"]
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    assert list(got[0].values())[0] == [1, 5, 3]  # first fit after row 0
    assert got[3] == {} and got[4][1:].sum() == 0 and got[4][0].all()


def test_enqueue_refuses_unservable_grammars(models):
    _jm, tm = models
    eng = ServingEngine(tm, page_size=4, max_batch_slots=2,
                        grammar_states=8, device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        eng.add_request(PROMPTS[0], grammar=GrammarFSM.compile(
            "[AB]", toy_tokenizer(64)))
    with pytest.raises(ValueError, match="grammar needs"):
        eng.add_request(PROMPTS[0], grammar=GrammarFSM.compile(
            "[ab]{9}", toy_tokenizer(128)))
    with pytest.raises(ValueError, match="compiled serving.grammar"):
        eng.add_request(PROMPTS[0], grammar="[ab]")
    with pytest.raises(ValueError, match="grammar_states must be"):
        ServingEngine(tm, grammar_states=1, device="cpu")
