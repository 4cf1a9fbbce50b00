"""Self-speculative drafting: host-side prompt-lookup n-gram proposer.

The port's own numpy copy of the JAX package's ``serve/spec.py``.

No second model. The drafter treats each slot's token history (prompt +
generated tokens) as its own draft model: if the trailing n-gram of the
history has occurred earlier, the tokens that followed that earlier
occurrence are proposed as the next ``k`` draft tokens (prompt-lookup /
"self-speculative" decoding). Repetitive contexts — code, retrieval
answers, structured output — hit long matches and verify whole runs per
step; non-repetitive contexts simply propose nothing and the engine
falls back to plain decode, so the drafter never costs a device op.

Everything here is plain numpy over host token lists: proposals feed
the engine's batched verify step (``lm.verify_states``) which scores
the panel on the device, where acceptance runs too. This module
touches no tensor, so drafting costs no device transfer.
"""
from __future__ import annotations

import numpy as np

# Longest trailing n-gram tried first; single-token fallback matches
# any earlier occurrence of the last token. Longer anchors make fewer,
# better proposals.
MAX_NGRAM = 3


def propose(history: np.ndarray, k: int, *,
            max_ngram: int = MAX_NGRAM) -> np.ndarray:
    """Propose up to ``k`` draft tokens continuing ``history``.

    Scans for the most recent earlier occurrence of the longest trailing
    n-gram (n = max_ngram down to 1) and returns the tokens that
    followed it, truncated to ``k`` and to the available continuation.
    Returns an empty array when no anchor matches — the caller should
    fall back to plain decode for that slot.
    """
    hist = np.asarray(history, dtype=np.int32).ravel()
    t = hist.size
    if k <= 0 or t < 2:
        return np.zeros((0,), np.int32)
    for n in range(min(max_ngram, t - 1), 0, -1):
        tail = hist[t - n:]
        # candidate start positions for an earlier occurrence; the match
        # must end before the tail itself so the continuation is real
        windows = np.lib.stride_tricks.sliding_window_view(
            hist[:t - 1], n)
        hits = np.flatnonzero((windows == tail[None, :]).all(axis=1))
        if hits.size == 0:
            continue
        start = int(hits[-1]) + n          # most recent match wins
        stop = min(start + k, t)
        if stop > start:
            return hist[start:stop].astype(np.int32, copy=True)
    return np.zeros((0,), np.int32)
