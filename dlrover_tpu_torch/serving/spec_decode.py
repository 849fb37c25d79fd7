"""Host-side n-gram / prompt-lookup draft proposer for speculative
decode (a copy of ``dlrover_tpu/serving/spec_decode.py``: pure Python,
the same in both packages).

No second model, no extra HBM: drafts come from the request's OWN
token stream (prompt + already-emitted tokens). ``NgramProposer``
keeps a per-request suffix index — every n-gram that has occurred maps
to where its continuation starts — and proposes the continuation of
the most recent earlier occurrence of the current suffix, longest
n-gram first. The workload this wins on is repetitive / structured
text (templated output, code, retrieval-stuffed prompts): exactly
where prompt-lookup decoding is known to hit.

Correctness never depends on draft quality: drafts feed
``models.llama.verify_step``, whose greedy acceptance emits bitwise
what plain greedy decode would at every acceptance pattern — a bad
draft only wastes the verify step's extra positions. The proposer is
therefore free to be heuristic and the engine is free to inject a
different one (tests force 0%/100%/alternating patterns through the
``ServeExecutor.spec_proposer`` hook).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

MAX_NGRAM_DEFAULT = 4
MIN_NGRAM_DEFAULT = 1


class NgramProposer:
    """Per-request incremental suffix index + prompt-lookup drafting.

    ``propose(history, k)`` self-syncs from the canonical host history
    (which only ever grows by appends: the prompt is fixed and decode
    appends), so callers never have to hook token-append sites. Index
    update is O(max_ngram) per new token; lookup is O(max_ngram) per
    proposal. For each n-gram key the index keeps the last TWO
    continuation starts: the most recent registration of the current
    suffix is the suffix itself (its "continuation" is the future —
    the thing being predicted), so lookups fall back to the previous
    occurrence.
    """

    def __init__(self, max_ngram: int = MAX_NGRAM_DEFAULT,
                 min_ngram: int = MIN_NGRAM_DEFAULT):
        self.max_ngram = max(1, int(max_ngram))
        self.min_ngram = max(1, min(int(min_ngram), self.max_ngram))
        self._history: List[int] = []
        # n-gram -> (last continuation start, previous one or None)
        self._index: Dict[Tuple[int, ...],
                          Tuple[int, Optional[int]]] = {}

    def _sync(self, history: Sequence[int]) -> None:
        h = self._history
        for i in range(len(h), len(history)):
            h.append(int(history[i]))
            for n in range(1, self.max_ngram + 1):
                if n > i + 1:
                    break
                key = tuple(h[i - n + 1:i + 1])
                prev = self._index.get(key)
                self._index[key] = (i + 1,
                                    prev[0] if prev else None)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing ``history``; [] when no
        earlier occurrence of any suffix n-gram exists."""
        self._sync(history)
        if k <= 0:
            return []
        h = self._history
        length = len(h)
        for n in range(min(self.max_ngram, length),
                       self.min_ngram - 1, -1):
            key = tuple(h[length - n:])
            entry = self._index.get(key)
            if entry is None:
                continue
            last, prev = entry
            start = last if last < length else prev
            if start is None or start >= length:
                continue
            # The match says position ``start`` aligns with position
            # ``length``: the stream looks like it repeats with period
            # d = length - start. Extend the draft by that period when
            # the literal continuation runs off the end of history —
            # without this, a period-d loop near the tail (d < k) can
            # never draft more than d tokens per step.
            d = length - start
            return [h[start + (j % d)] for j in range(k)]
        return []
