"""Host-side Levenshtein rectification of decoded sequences (port of
fudanocr_tpu/eval/levenshtein.py).

stroke-level-decomposition/util.py:44-47, 176-182: a decoded stroke
string that is not a legal decomposition is snapped to the nearest legal
one by edit distance. Runs on the host, after the decode.
"""

from __future__ import annotations

from typing import Sequence

try:
    import Levenshtein as _lev

    def edit_distance(a: str, b: str) -> int:
        return _lev.distance(a, b)
except ImportError:
    def edit_distance(a: str, b: str) -> int:
        """The unit-cost edit distance (insert, delete, substitute)."""
        if len(a) < len(b):
            a, b = b, a
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]


class SequenceRectifier:
    """Snap decoded strings to the nearest member of a legal-sequence set
    (the first in `legal_sequences` order among equally near ones)."""

    def __init__(self, legal_sequences: Sequence[str]):
        self.legal = list(legal_sequences)
        self.legal_set = set(self.legal)

    def __call__(self, s: str) -> str:
        if s in self.legal_set:
            return s
        best, best_d = s, None
        for cand in self.legal:
            d = edit_distance(s, cand)
            if best_d is None or d < best_d:
                best, best_d = cand, d
        return best
