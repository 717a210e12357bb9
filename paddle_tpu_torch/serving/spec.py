"""Host-side draft proposer for speculative decoding on the unified step.

Counterpart of ``paddle_tpu/serving/spec.py`` (``NGramDrafter``). The
engine scores a slot's drafts as extra rows of the same step it runs
anyway, accepts the prefix that equals the tokens the stream samples at
those positions, and rolls the KV length back over the rest, so streams
are the same with speculation on or off. The drafter is plain numpy and
never touches the device.

:class:`NGramDrafter` ("prompt lookup") suffix-matches the last ``n``
tokens of the stream (prompt + generated) against every earlier
occurrence and proposes what followed the latest match. A custom drafter
needs only ``propose(ids, k) -> np.ndarray`` (up to ``k`` int32 tokens,
possibly none).
"""
from __future__ import annotations

import numpy as np

__all__ = ["NGramDrafter"]

_EMPTY = np.empty(0, np.int32)


class NGramDrafter:
    """Draft tokens by n-gram suffix match over the stream itself:
    suffixes of ``max_ngram`` down to ``min_ngram`` tokens, longest first;
    ``k`` is the default proposal cap (the engine passes its own)."""

    def __init__(self, k: int = 4, max_ngram: int = 3, min_ngram: int = 1):
        self.k = int(k)
        self.max_ngram = max(int(max_ngram), 1)
        self.min_ngram = max(int(min_ngram), 1)
        if self.min_ngram > self.max_ngram:
            raise ValueError(
                f"min_ngram {self.min_ngram} > max_ngram {self.max_ngram}")

    def propose(self, ids: np.ndarray, k: int | None = None) -> np.ndarray:
        """Up to ``k`` tokens continuing ``ids``, or none when no suffix
        of at least ``min_ngram`` tokens recurs. A pure function of
        ``ids``."""
        k = self.k if k is None else int(k)
        ids = np.asarray(ids, np.int32).reshape(-1)
        n_total = ids.size
        if k <= 0 or n_total < self.min_ngram + 1:
            return _EMPTY
        for n in range(min(self.max_ngram, n_total - 1),
                       self.min_ngram - 1, -1):
            suffix = ids[n_total - n:]
            # every length-n window that at least one token follows
            windows = np.lib.stride_tricks.sliding_window_view(
                ids[:n_total - 1], n)
            hits = np.flatnonzero((windows == suffix).all(axis=1))
            if hits.size == 0:
                continue
            start = int(hits[-1]) + n  # the latest earlier occurrence
            return ids[start:start + k].copy()
        return _EMPTY
