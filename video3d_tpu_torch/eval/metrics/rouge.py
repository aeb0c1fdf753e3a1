"""ROUGE-L (Lin & Hovy 2004) with the reference conventions
(caption_eval/rouge/rouge.py): max precision/recall over references via LCS,
F-beta with beta = 1.2, mean over samples."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def lcs_length(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else max(prev[j], cur[j - 1])
        prev = cur
    return prev[len(b)]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def calc_score(self, candidate: Sequence[str], refs: Sequence[str]) -> float:
        token_c = candidate[0].split(" ")
        prec, rec = [], []
        for reference in refs:
            token_r = reference.split(" ")
            lcs = lcs_length(token_r, token_c)
            prec.append(lcs / float(len(token_c)) if token_c else 0.0)
            rec.append(lcs / float(len(token_r)) if token_r else 0.0)
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            return ((1 + self.beta ** 2) * p * r) / (r + self.beta ** 2 * p)
        return 0.0

    def compute_score(self, gts: Dict[str, Sequence[str]],
                      res: Dict[str, Sequence[str]]) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        scores = [self.calc_score(res[k], gts[k]) for k in gts]
        arr = np.asarray(scores)
        return float(arr.mean()), arr
