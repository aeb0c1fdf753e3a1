"""METEOR, pure-Python.

The reference shells out to the METEOR-1.5 **Java jar**
(caption_eval/meteor/meteor.py:12-25) — a JVM dependency this package
intentionally drops. This module implements the METEOR-1.0
algorithm (Banerjee & Lavie 2005: recall-weighted harmonic mean
F = 10PR/(R+9P), fragmentation penalty 0.5*(chunks/matches)^3) with the
exact + Porter-stem match stages. WordNet synonym and paraphrase-table
stages require external resources and are omitted, so absolute values can
differ from the 1.5 jar; rankings track closely. Scores are averaged over
samples with the best reference taken per sample, as the jar does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

ALPHA, BETA, GAMMA = 0.9, 3.0, 0.5  # METEOR-1.0 parameters


def _porter_stem(word: str) -> str:
    """Compact Porter stemmer (steps 1a/1b/1c + common suffixes) — enough to
    align inflectional variants the way METEOR's stem module does."""
    w = word.lower()
    if len(w) <= 2:
        return w
    for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", "")):
        if w.endswith(suf):
            if suf != "ss" or rep != "ss":
                w = w[: len(w) - len(suf)] + rep
            break
    for suf in ("eed", "ed", "ing"):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if suf == "eed":
                if re.search(r"[aeiou].*[^aeiou]", stem):
                    w = stem + "ee"
            elif re.search(r"[aeiou]", stem):
                w = stem
                if w.endswith(("at", "bl", "iz")):
                    w += "e"
                elif len(w) > 1 and w[-1] == w[-2] and w[-1] not in "lsz":
                    w = w[:-1]
            break
    if w.endswith("y") and re.search(r"[aeiou]", w[:-1]):
        w = w[:-1] + "i"
    return w


def _align(hyp: List[str], ref: List[str]) -> Tuple[int, int]:
    """Greedy two-stage (exact, stem) alignment -> (matches, chunks)."""
    m = len(hyp)
    match_of = [-1] * m
    used = [False] * len(ref)
    # stage 1: exact
    for i, h in enumerate(hyp):
        for j, r in enumerate(ref):
            if not used[j] and h == r:
                match_of[i] = j
                used[j] = True
                break
    # stage 2: stem
    ref_stem = [_porter_stem(r) for r in ref]
    for i, h in enumerate(hyp):
        if match_of[i] >= 0:
            continue
        hs = _porter_stem(h)
        for j in range(len(ref)):
            if not used[j] and hs == ref_stem[j]:
                match_of[i] = j
                used[j] = True
                break
    matches = sum(1 for x in match_of if x >= 0)
    # chunk count: maximal runs of adjacent matches mapping to adjacent refs
    chunks = 0
    prev = None
    for i in range(m):
        if match_of[i] >= 0:
            if prev is None or match_of[i] != prev + 1:
                chunks += 1
            prev = match_of[i]
        else:
            prev = None
    return matches, chunks


def meteor_sentence(hyp: str, refs: Sequence[str]) -> float:
    hyp_toks = hyp.lower().split()
    best = 0.0
    for ref in refs:
        ref_toks = ref.lower().split()
        if not hyp_toks or not ref_toks:
            continue
        matches, chunks = _align(hyp_toks, ref_toks)
        if matches == 0:
            continue
        p = matches / len(hyp_toks)
        r = matches / len(ref_toks)
        f_mean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        frag = chunks / matches
        score = f_mean * (1 - GAMMA * (frag ** BETA))
        best = max(best, score)
    return best


class Meteor:
    def compute_score(self, gts: Dict[str, Sequence[str]],
                      res: Dict[str, Sequence[str]]) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        scores = [meteor_sentence(res[k][0], gts[k]) for k in gts]
        arr = np.asarray(scores)
        return float(arr.mean()), arr
