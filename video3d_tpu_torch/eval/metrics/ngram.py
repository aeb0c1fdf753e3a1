"""Shared n-gram counting for caption metrics."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple


def ngram_counts(sentence: str, n: int = 4) -> Dict[tuple, int]:
    """Whitespace-token n-gram counts for n = 1..n (caption_eval precook
    semantics: plain str.split, no lowercasing here)."""
    words = sentence.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts
