"""Corpus BLEU-1..4 with the aggregation conventions of the reference's
vendored scorer (caption_eval/bleu/bleu_scorer.py): clipped n-gram matches
against per-ngram max reference counts, 'closest' effective reference length
(first-wins on ties), corpus-level precision pooling with tiny/small guards,
and exp(1 - 1/ratio) brevity penalty applied only when ratio < 1.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from video3d_tpu_torch.eval.metrics.ngram import ngram_counts

SMALL = 1e-9
TINY = 1e-15


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Dict[str, Sequence[str]],
                      res: Dict[str, Sequence[str]],
                      option: str = "closest") -> Tuple[List[float], List[List[float]]]:
        assert sorted(gts.keys()) == sorted(res.keys())
        keys = list(gts.keys())

        total_guess = [0] * self.n
        total_correct = [0] * self.n
        total_testlen = 0
        total_reflen = 0.0
        per_sentence: List[List[float]] = [[] for _ in range(self.n)]

        for key in keys:
            hyp_words = res[key][0].split()
            testlen = len(hyp_words)
            hyp_counts = ngram_counts(res[key][0], self.n)

            reflens = [len(r.split()) for r in gts[key]]
            max_ref: Dict[tuple, int] = defaultdict(int)
            for r in gts[key]:
                for g, c in ngram_counts(r, self.n).items():
                    max_ref[g] = max(max_ref[g], c)

            if option == "closest":
                best, best_diff = None, None
                for rl in reflens:
                    d = abs(rl - testlen)
                    if best_diff is None or d < best_diff:
                        best, best_diff = rl, d
                reflen = float(best)
            elif option == "average":
                reflen = sum(reflens) / float(len(reflens))
            else:  # shortest
                reflen = float(min(reflens))

            guess = [max(0, testlen - k) for k in range(self.n)]
            correct = [0] * self.n
            for g, c in hyp_counts.items():
                correct[len(g) - 1] += min(c, max_ref[g])

            total_testlen += testlen
            total_reflen += reflen
            for k in range(self.n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]

            bleu = 1.0
            ratio = (testlen + TINY) / (reflen + SMALL)
            for k in range(self.n):
                bleu *= (correct[k] + TINY) / (guess[k] + SMALL)
                val = bleu ** (1.0 / (k + 1))
                if ratio < 1:
                    val *= math.exp(1 - 1 / ratio)
                per_sentence[k].append(val)

        bleus = []
        bleu = 1.0
        ratio = (total_testlen + TINY) / (total_reflen + SMALL)
        for k in range(self.n):
            bleu *= (total_correct[k] + TINY) / (total_guess[k] + SMALL)
            val = bleu ** (1.0 / (k + 1))
            if ratio < 1:
                val *= math.exp(1 - 1 / ratio)
            bleus.append(val)
        return bleus, per_sentence
