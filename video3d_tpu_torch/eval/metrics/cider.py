"""CIDEr (Vedantam et al., CVPR 2015) — consensus-based caption metric.

Implements the algorithm with the exact aggregation conventions of the
reference's vendored scorer (caption_eval/cider/cider_scorer.py): corpus IDF
``log(len(corpus)) - log(max(1, df))``, per-n cosine similarity with
hypothesis-count clipping, Gaussian length penalty exp(-d^2 / (2*6^2)),
mean over n = 1..4, x10, averaged over references.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from video3d_tpu_torch.eval.metrics.ngram import ngram_counts


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: Dict[str, Sequence[str]],
                      res: Dict[str, Sequence[str]]) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        keys = list(gts.keys())
        crefs = [[ngram_counts(r, self.n) for r in gts[k]] for k in keys]
        ctest = [ngram_counts(res[k][0], self.n) for k in keys]

        # document frequency over reference sets
        df: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            for ngram in {g for ref in refs for g in ref}:
                df[ngram] += 1
        ref_len = np.log(float(len(crefs)))

        def tfidf_vec(cnts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ngram, tf in cnts.items():
                idf = ref_len - np.log(max(1.0, df[ngram]))
                k = len(ngram) - 1
                vec[k][ngram] = float(tf) * idf
                norm[k] += vec[k][ngram] ** 2
                if k == 1:
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        scores = []
        for test, refs in zip(ctest, crefs):
            vec, norm, length = tfidf_vec(test)
            score = np.zeros(self.n)
            for ref in refs:
                vec_r, norm_r, length_r = tfidf_vec(ref)
                delta = float(length - length_r)
                val = np.zeros(self.n)
                for k in range(self.n):
                    for ngram in vec[k]:
                        val[k] += min(vec[k][ngram], vec_r[k][ngram]) * vec_r[k][ngram]
                    if norm[k] != 0 and norm_r[k] != 0:
                        val[k] /= norm[k] * norm_r[k]
                    val[k] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
                score += val
            scores.append(float(score.mean() / len(refs) * 10.0))
        arr = np.asarray(scores)
        return float(arr.mean()), arr
