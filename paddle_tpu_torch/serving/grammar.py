"""Constrained decoding: regex / JSON-schema grammars compiled to a
token-level DFA.

Counterpart of ``paddle_tpu/serving/grammar.py``, copied: it is numpy
only, and the port keeps its own copy so that it imports nothing of the
JAX package. A :class:`GrammarFSM` turns a regex (or a small JSON-schema
subset, lowered to a regex first) into a dense ``[n_states, vocab]``
boolean allow-mask plus a ``[n_states, vocab]`` transition table. The
mask is what the serving step reads as data (the engine interns it into
one device table, and each sample row gathers its state's row and masks
the logits), while the transition table is what the host uses to advance
each slot's integer state on every landed token. Nothing in here touches
the device: states are ints, masks are arrays, and the identity row
(all ``True``) that unconstrained slots point at lives in the engine.

The DFA is built the classic way: Thompson construction to an
epsilon-NFA, subset construction to a DFA, dead-state pruning, over the
printable-ASCII alphabet. A token is allowed in state ``s`` iff walking
its (non-empty) decoded string from ``s`` never leaves the live DFA; the
eos column is allowed exactly in accepting states, so a constrained
stream can only terminate on a complete structure.

``compile`` is a pure function of ``(pattern, tokenizer)``: both
packages build bit-equal tables for the same grammar and tokenizer.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["GrammarFSM", "ToyTokenizer", "toy_tokenizer",
           "schema_to_regex"]

# the grammar alphabet: printable ASCII. Tokens whose decoded strings
# step outside it simply never match a literal/class and are masked.
_ALPHABET = frozenset(chr(c) for c in range(32, 127))
_DIGITS = frozenset("0123456789")
_WORD = frozenset("abcdefghijklmnopqrstuvwxyz"
                  "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t")
_META = set("\\.[](){}|*+?")


# --------------------------------------------------------------- tokenizer
class ToyTokenizer:
    """The simplest tokenizer that exercises the whole constrained
    path: token id ``i`` decodes to the single printable character
    ``chr(32 + i % 95)`` (ids past one alphabet cycle repeat it), and an
    optional ``eos_token_id`` decodes to the empty string so it can
    never satisfy a character transition — only the accepting-state eos
    column admits it. Tests, loadgen, and the bench drill all constrain
    tiny random-token models through this mapping."""

    def __init__(self, vocab_size: int, eos_token_id: Optional[int] = None):
        self.vocab_size = int(vocab_size)
        self.eos_token_id = eos_token_id

    def decode_token(self, token_id: int) -> str:
        if self.eos_token_id is not None and token_id == self.eos_token_id:
            return ""
        return chr(32 + (int(token_id) % 95))

    def encode(self, text: str) -> List[int]:
        """Inverse of :meth:`decode_token` (first alphabet cycle)."""
        return [ord(ch) - 32 for ch in text]


def toy_tokenizer(vocab_size: int,
                  eos_token_id: Optional[int] = None) -> ToyTokenizer:
    """One printable character per token id — see :class:`ToyTokenizer`."""
    return ToyTokenizer(vocab_size, eos_token_id)


# ------------------------------------------------------- schema lowering
def _lit(text: str) -> str:
    """Regex-escape a literal string against THIS module's parser."""
    return "".join("\\" + ch if ch in _META else ch for ch in text)


def schema_to_regex(schema: dict) -> str:
    """Lower a small JSON-schema subset to a regex this module parses.

    Supported: ``type`` string / integer / number / boolean / null,
    ``enum`` / ``const`` (JSON-dumped alternation), ``object`` with
    ``properties`` emitted in declaration order (all treated required —
    constrained decoding needs ONE canonical serialization), bounded
    ``array`` (``maxItems`` required, default 3). The emitted language
    is real JSON: every accepted string round-trips through
    ``json.loads``."""
    if "const" in schema:
        return _lit(json.dumps(schema["const"], separators=(",", ":")))
    if "enum" in schema:
        alts = "|".join(_lit(json.dumps(v, separators=(",", ":")))
                        for v in schema["enum"])
        return "(" + alts + ")"
    t = schema.get("type")
    if t == "string":
        # quote-and-backslash-free body keeps the DFA tiny and the
        # output trivially valid JSON
        n = int(schema.get("maxLength", 8))
        return '"[a-z]{0,%d}"' % n
    if t == "integer":
        return "-?(0|[1-9][0-9]{0,3})"
    if t == "number":
        return "-?(0|[1-9][0-9]{0,3})(\\.[0-9]{1,3})?"
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "object":
        props = schema.get("properties", {})
        parts = [_lit(json.dumps(k)) + ":" + schema_to_regex(v)
                 for k, v in props.items()]
        return "\\{" + _lit(",").join(parts) + "\\}"
    if t == "array":
        item = schema_to_regex(schema.get("items", {"type": "integer"}))
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", 3))
        if hi < 1 or hi < lo:
            raise ValueError("array bounds must satisfy 0 <= minItems "
                             f"<= maxItems >= 1, got [{lo}, {hi}]")
        body = "(%s)(,(%s)){%d,%d}" % (item, item, max(lo - 1, 0), hi - 1)
        if lo == 0:
            body = "(" + body + ")?"
        return "\\[" + body + "\\]"
    raise ValueError(f"unsupported schema: {schema!r} — supported types: "
                     "string/integer/number/boolean/null/object/array, "
                     "enum, const")


# ----------------------------------------------------------- regex parser
class _Parser:
    """Recursive-descent regex parser over the printable-ASCII
    alphabet. Supported syntax: literals, ``.``, classes ``[a-z0-9]``
    (with ``^`` negation and escapes), escapes (``\\d \\w \\s`` and
    ``\\<meta>``), groups, ``|``, ``* + ?``, ``{m}`` / ``{m,n}``. AST
    nodes are plain tuples."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _err(self, msg: str):
        raise ValueError(f"regex error at index {self.i} in "
                         f"{self.p!r}: {msg}")

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            self._err("unconsumed input (unbalanced ')'?)")
        return node

    def _alt(self):
        branches = [self._concat()]
        while self.i < len(self.p) and self.p[self.i] == "|":
            self.i += 1
            branches.append(self._concat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _concat(self):
        items = []
        while self.i < len(self.p) and self.p[self.i] not in "|)":
            items.append(self._repeat())
        if not items:
            return ("eps",)
        return items[0] if len(items) == 1 else ("cat", items)

    def _repeat(self):
        node = self._atom()
        while self.i < len(self.p) and self.p[self.i] in "*+?{":
            ch = self.p[self.i]
            if ch == "*":
                node, self.i = ("star", node), self.i + 1
            elif ch == "+":
                node, self.i = ("cat", [node, ("star", node)]), self.i + 1
            elif ch == "?":
                node, self.i = ("alt", [node, ("eps",)]), self.i + 1
            else:
                node = self._bounded(node)
        return node

    def _bounded(self, node):
        j = self.p.index("}", self.i)
        body = self.p[self.i + 1:j]
        self.i = j + 1
        lo_s, _, hi_s = body.partition(",")
        lo = int(lo_s)
        hi = lo if not _ else (int(hi_s) if hi_s else None)
        if hi is not None and hi < lo:
            self._err(f"bad bounds {{{body}}}")
        items = [node] * lo
        if hi is None:
            items.append(("star", node))
        else:
            items.extend([("alt", [node, ("eps",)])] * (hi - lo))
        if not items:
            return ("eps",)
        return items[0] if len(items) == 1 else ("cat", items)

    def _atom(self):
        ch = self.p[self.i]
        if ch == "(":
            self.i += 1
            node = self._alt()
            if self.i >= len(self.p) or self.p[self.i] != ")":
                self._err("unbalanced '('")
            self.i += 1
            return node
        if ch == "[":
            return ("set", self._charclass())
        if ch == ".":
            self.i += 1
            return ("set", _ALPHABET)
        if ch == "\\":
            return ("set", self._escape())
        if ch in "*+?{":
            self._err(f"dangling quantifier {ch!r}")
        self.i += 1
        return ("set", frozenset(ch))

    def _escape(self) -> frozenset:
        self.i += 1
        if self.i >= len(self.p):
            self._err("dangling backslash")
        ch = self.p[self.i]
        self.i += 1
        table = {"d": _DIGITS, "w": _WORD, "s": _SPACE,
                 "t": frozenset("\t"), "n": frozenset()}
        if ch in table:
            return table[ch]
        return frozenset(ch)

    def _charclass(self) -> frozenset:
        self.i += 1  # consume '['
        negate = self.i < len(self.p) and self.p[self.i] == "^"
        if negate:
            self.i += 1
        chars: set = set()
        while self.i < len(self.p) and self.p[self.i] != "]":
            if self.p[self.i] == "\\":
                chars |= self._escape()
                continue
            ch = self.p[self.i]
            if (self.i + 2 < len(self.p) and self.p[self.i + 1] == "-"
                    and self.p[self.i + 2] != "]"):
                lo, hi = ord(ch), ord(self.p[self.i + 2])
                if hi < lo:
                    self._err(f"bad range {ch}-{self.p[self.i + 2]}")
                chars |= {chr(c) for c in range(lo, hi + 1)}
                self.i += 3
            else:
                chars.add(ch)
                self.i += 1
        if self.i >= len(self.p):
            self._err("unbalanced '['")
        self.i += 1  # consume ']'
        out = frozenset(chars)
        return frozenset(_ALPHABET - out) if negate else out


# ---------------------------------------------------------- NFA/DFA build
def _nfa(node, trans: List[Dict[str, set]], eps: List[set]) -> Tuple[int, int]:
    """Thompson construction: returns (start, accept) state ids,
    appending fresh states to ``trans``/``eps``."""
    def new() -> int:
        trans.append({})
        eps.append(set())
        return len(trans) - 1

    kind = node[0]
    if kind == "eps":
        s = new()
        return s, s
    if kind == "set":
        s, e = new(), new()
        for ch in node[1]:
            trans[s].setdefault(ch, set()).add(e)
        return s, e
    if kind == "cat":
        s, e = _nfa(node[1][0], trans, eps)
        for child in node[1][1:]:
            cs, ce = _nfa(child, trans, eps)
            eps[e].add(cs)
            e = ce
        return s, e
    if kind == "alt":
        s, e = new(), new()
        for child in node[1]:
            cs, ce = _nfa(child, trans, eps)
            eps[s].add(cs)
            eps[ce].add(e)
        return s, e
    if kind == "star":
        cs, ce = _nfa(node[1], trans, eps)
        s, e = new(), new()
        eps[s] |= {cs, e}
        eps[ce] |= {cs, e}
        return s, e
    raise AssertionError(f"unknown node {kind!r}")


def _closure(states: frozenset, eps: List[set]) -> frozenset:
    stack, seen = list(states), set(states)
    while stack:
        for nxt in eps[stack.pop()]:
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return frozenset(seen)


def _dfa(pattern: str) -> Tuple[List[Dict[str, int]], set]:
    """regex → (dfa transitions, accepting set); start state is 0, dead
    (can't-reach-accepting) states pruned so "has a transition" means
    "can still complete"."""
    ast = _Parser(pattern).parse()
    trans: List[Dict[str, set]] = []
    eps: List[set] = []
    ns, ne = _nfa(ast, trans, eps)

    start = _closure(frozenset([ns]), eps)
    ids: Dict[frozenset, int] = {start: 0}
    dtrans: List[Dict[str, int]] = [{}]
    work = [start]
    while work:
        cur = work.pop()
        ci = ids[cur]
        by_char: Dict[str, set] = {}
        for st in cur:
            for ch, dsts in trans[st].items():
                by_char.setdefault(ch, set()).update(dsts)
        for ch, dsts in by_char.items():
            nxt = _closure(frozenset(dsts), eps)
            if nxt not in ids:
                ids[nxt] = len(dtrans)
                dtrans.append({})
                work.append(nxt)
            dtrans[ci][ch] = ids[nxt]
    accepting = {i for s, i in ids.items() if ne in s}

    # prune states that cannot reach an accepting state: transitions
    # into them become dead edges, so a token leading there is masked
    # instead of stranding the stream in an uncompletable corner
    live = set(accepting)
    changed = True
    while changed:
        changed = False
        for i, row in enumerate(dtrans):
            if i not in live and any(d in live for d in row.values()):
                live.add(i)
                changed = True
    if 0 not in live:
        raise ValueError(f"regex {pattern!r} matches nothing")
    remap = {old: new for new, old in
             enumerate(sorted(live, key=lambda s: (s != 0, s)))}
    pruned = [{ch: remap[d] for ch, d in dtrans[old].items() if d in live}
              for old in sorted(live, key=lambda s: (s != 0, s))]
    return pruned, {remap[a] for a in accepting if a in live}


# ---------------------------------------------------------------- the FSM
class GrammarFSM:
    """A compiled token-level grammar: dense allow-mask + transition
    table over a fixed tokenizer. Build with :meth:`compile`; the
    engine interns ``mask_table`` into its device-resident grammar
    table and keeps per-slot LOCAL states that this class advances."""

    def __init__(self, pattern: str, tokenizer, dtrans, accepting):
        self.pattern = pattern
        self.vocab_size = int(tokenizer.vocab_size)
        self.eos_token_id = getattr(tokenizer, "eos_token_id", None)
        self._accepting = frozenset(accepting)
        n, v = len(dtrans), self.vocab_size
        # token_next[s, t]: DFA state after token t's decoded string, or
        # -1 if any step dies. Empty strings never transition: only the
        # eos column (accepting states) admits the eos id.
        self.token_next = np.full((n, v), -1, np.int32)
        self.mask_table = np.zeros((n, v), bool)
        strings = [tokenizer.decode_token(t) for t in range(v)]
        for s in range(n):
            for t, w in enumerate(strings):
                if not w:
                    continue
                cur = s
                for ch in w:
                    cur = dtrans[cur].get(ch, -1)
                    if cur < 0:
                        break
                if cur >= 0:
                    self.token_next[s, t] = cur
                    self.mask_table[s, t] = True
        if self.eos_token_id is not None:
            for s in self._accepting:
                self.mask_table[s, self.eos_token_id] = True
        # fail FAST on tokenizer/grammar mismatch: a live non-accepting
        # state with no allowed token would force sampling over a fully
        # masked row — uniform garbage instead of a constraint
        for s in range(n):
            if not self.mask_table[s].any() and s not in self._accepting:
                raise ValueError(
                    f"grammar {pattern!r} state {s} allows no token under "
                    "this tokenizer — the tokenizer does not cover the "
                    "grammar's alphabet")

    # the interning key: two requests carrying equal-pattern grammars
    # over the same vocab share ONE table segment in the engine
    @property
    def key(self) -> Tuple[str, int, Optional[int]]:
        return (self.pattern, self.vocab_size, self.eos_token_id)

    @property
    def n_states(self) -> int:
        return int(self.mask_table.shape[0])

    @property
    def start_state(self) -> int:
        return 0

    @classmethod
    def compile(cls, pattern, tokenizer) -> "GrammarFSM":
        """``pattern`` is a regex string or a JSON-schema dict (lowered
        via :func:`schema_to_regex`); ``tokenizer`` needs
        ``vocab_size``, ``decode_token(id) -> str`` and optionally
        ``eos_token_id`` (:func:`toy_tokenizer` for tests/bench)."""
        if isinstance(pattern, dict):
            pattern = schema_to_regex(pattern)
        dtrans, accepting = _dfa(pattern)
        return cls(pattern, tokenizer, dtrans, accepting)

    # ------------------------------------------------------- host walking
    def next_state(self, state: int, token: int) -> int:
        """State after ``token`` lands, -1 if the token is disallowed
        (never happens for in-step-masked samples)."""
        return int(self.token_next[int(state), int(token)])

    def advance(self, state: int, tokens: Sequence[int]) -> int:
        """Fold :meth:`next_state` over ``tokens`` — how an adoptive
        engine replays a migrated request's journal into its FSM
        state. Raises on a disallowed token: a journal that does not
        walk the grammar is corrupt, not resumable."""
        cur = int(state)
        for t in tokens:
            nxt = self.next_state(cur, t)
            if nxt < 0:
                raise ValueError(
                    f"token {int(t)} disallowed in state {cur} of "
                    f"grammar {self.pattern!r}")
            cur = nxt
        return cur

    def is_accepting(self, state: int) -> bool:
        return int(state) in self._accepting

    def is_complete(self, state: int) -> bool:
        """Accepting with NO continuation token allowed: the structure
        is finished and the host retires the stream with ``"stop"``
        even when the model has no eos token."""
        s = int(state)
        if s not in self._accepting:
            return False
        row = self.mask_table[s].copy()
        if self.eos_token_id is not None:
            row[self.eos_token_id] = False
        return not row.any()

    def allowed(self, state: int) -> np.ndarray:
        """Token ids allowed in ``state`` (eos column included)."""
        return np.nonzero(self.mask_table[int(state)])[0]

    def validates(self, tokens: Sequence[int]) -> bool:
        """True iff ``tokens`` (a finished stream, optional trailing
        eos) walks the grammar start-to-accepting — what chaos/loadgen
        assert on every constrained completion."""
        toks = list(tokens)
        if (self.eos_token_id is not None and toks
                and toks[-1] == self.eos_token_id):
            toks = toks[:-1]
        cur = 0
        for t in toks:
            cur = self.next_state(cur, t)
            if cur < 0:
                return False
        return self.is_accepting(cur)

    def __repr__(self) -> str:
        return (f"GrammarFSM(pattern={self.pattern!r}, "
                f"n_states={self.n_states}, vocab={self.vocab_size})")
