"""METEOR 1.5, pure-Python (no JVM, no network).

The reference scores captions by shelling out to the METEOR-1.5 Java jar
(``caption_eval/meteor/meteor.py:12-25``, flags ``-l en -norm``) — the jar
itself is NOT vendored in the reference repo and no Java runtime is
assumed, so the jar's exact output is unverifiable offline. This
module re-implements the METEOR 1.5 *algorithm* (Denkowski & Lavie 2014,
"Meteor Universal: Language Specific Translation Evaluation for Any Target
Language"):

  * ``-norm`` text normalization (lowercase + punctuation tokenization);
  * matcher cascade  exact > stem > synonym > paraphrase, each word pair
    labeled with its highest-priority module;
  * one-to-one alignment chosen by beam search maximizing total weighted
    match, then match count, then FEWEST chunks (the official Aligner's
    objective, beam width 40);
  * weighted precision/recall with content/function word discounting
    (delta), fragmentation penalty, and the English-tuned parameters
      alpha=0.85  beta=0.2  gamma=0.6  delta=0.75
      module weights  exact=1.0  stem=0.6  synonym=0.8  paraphrase=0.6
    (op. cit., Table 2):
      P = W(h) / (delta*|h_c| + (1-delta)*|h_f|)     (R likewise over ref)
      F = P*R / (alpha*P + (1-alpha)*R)
      Pen = gamma * (chunks / avg_matches)**beta
      score = (1 - Pen) * F

Resource notes (documented deviations, PARITY.md):
  * stem: nltk's algorithmic SnowballStemmer("english") — the same Snowball
    English stemmer the jar uses, no corpus download needed;
  * synonym: the jar reads WordNet synset files. WordNet data is absent
    here; a compact curated table targeting the scene-caption vocabulary is
    vendored (metrics/meteor_data.py) and used BY DEFAULT. Pass
    ``synonyms={word: {synset_ids}}`` to substitute a real WordNet load, or
    ``synonyms={}`` to disable the module;
  * paraphrase: the jar's ~100 MB PPDB table is likewise absent; a curated
    single-token pair table is vendored and used by default. Pass
    ``paraphrases={(a, b), ...}`` to substitute, ``()`` to disable;
  * function words: the jar ships a corpus-frequency-derived
    ``function.words`` list; a standard English closed-class list +
    punctuation is vendored below.

Because none of the jar's data files are byte-reproducible offline, every
protocol report stamps :meth:`Meteor15.provenance` next to the METEOR
number so it is never silently compared against jar-scored tables.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
MODULE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)   # exact, stem, synonym, paraphrase
BEAM = 40

# Closed-class English function words + punctuation (see module docstring).
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no neither either
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves yourselves themselves who whom whose which what
and or but nor so yet for because although though while if unless until
when whenever where wherever as than whether
in on at by with from to of about against between into through during
before after above below up down out off over under again further
once here there why how
is am are was were be been being do does did doing have has had having
will would shall should may might must can could
not only own same such too very just also then
's 't 'll 've 're 'd 'm n't
""".split()) | frozenset(".,;:!?\"'`()[]{}-")


def normalize(text: str) -> list:
    """Meteor ``-norm``: lowercase, split punctuation into tokens."""
    text = text.lower().strip()
    text = re.sub(r"([.,;:!?\"()\[\]{}])", r" \1 ", text)
    return text.split()


def _default_stemmer():
    try:
        from nltk.stem.snowball import SnowballStemmer

        return SnowballStemmer("english").stem
    except Exception:  # pragma: no cover — nltk is in the base image
        from video3d_tpu_torch.eval.metrics.meteor import _porter_stem

        return _porter_stem


class Meteor15:
    """Sentence/corpus METEOR-1.5 scorer; ``compute_score`` mirrors the
    jar wrapper's (gts, res) -> (mean, per-sample) interface."""

    def __init__(self,
                 synonyms: Optional[Mapping[str, Set]] = None,
                 paraphrases: Optional[Iterable[Tuple[str, str]]] = None):
        # None -> the vendored tables (meteor_data.py); pass {} / () to
        # disable a module outright, or a real WordNet/PPDB load to
        # substitute.
        if synonyms is None:
            from video3d_tpu_torch.eval.metrics.meteor_data import synonym_table

            synonyms = synonym_table()
        if paraphrases is None:
            from video3d_tpu_torch.eval.metrics.meteor_data import PARAPHRASE_PAIRS

            paraphrases = PARAPHRASE_PAIRS
        self._stem = _default_stemmer()
        self._syn = synonyms
        self._par = frozenset(paraphrases)

    def provenance(self) -> dict:
        """Metric-provenance stamp for eval reports: identifies the scorer
        implementation and its knowledge tables so METEOR numbers are never
        silently compared against jar-scored baseline tables."""
        return {"impl": "meteor15-py",
                "algorithm": "METEOR 1.5 (Denkowski & Lavie 2014), en",
                "synonym_words": len(self._syn),
                "paraphrase_pairs": len(self._par),
                "function_words": "vendored closed-class list",
                "jar_compatible": False}

    # ---------------- matching ----------------

    def _match_module(self, h: str, r: str) -> int:
        """Highest-priority module matching (h, r), or -1."""
        if h == r:
            return 0
        if self._stem(h) == self._stem(r):
            return 1
        if self._syn:
            sh = self._syn.get(h)
            if sh and sh & (self._syn.get(r) or set()):
                return 2
        if self._par and ((h, r) in self._par or (r, h) in self._par):
            return 3
        return -1

    def _align(self, hyp: list, ref: list):
        """Beam-search one-to-one alignment.

        Objective (lexicographic, the official Aligner's preference):
        maximize total module weight, then match count, then minimize
        chunks. Returns (w_h, w_r, m_h, m_r, chunks) where w_* are the
        delta-discounted weighted match sums per side and m_* the plain
        matched-word counts.
        """
        cands = []
        for i, h in enumerate(hyp):
            row = []
            for j, r in enumerate(ref):
                mod = self._match_module(h, r)
                if mod >= 0:
                    row.append((j, mod))
            cands.append(row)

        def wordw(tok: str) -> float:
            return (1 - DELTA) if tok in FUNCTION_WORDS else DELTA

        # beam state: (used_ref_mask, prev_ref_j, chunks, weight, matches,
        #              w_h, w_r)
        states = {(0, -2): (0, 0.0, 0, 0.0, 0.0)}
        for i, row in enumerate(cands):
            nxt = {}

            def push(key, val):
                old = nxt.get(key)
                # prefer higher (weight, matches, -chunks)
                if old is None or (val[1], val[2], -val[0]) > (
                        old[1], old[2], -old[0]):
                    nxt[key] = val

            for (mask, prev), (ch, w, m, wh, wr) in states.items():
                # skip hyp word i
                push((mask, -2), (ch, w, m, wh, wr))
                for j, mod in row:
                    if mask & (1 << j):
                        continue
                    mw = MODULE_WEIGHTS[mod]
                    nch = ch + (0 if prev >= 0 and j == prev + 1 else 1)
                    push((mask | (1 << j), j),
                         (nch, w + mw, m + 1,
                          wh + mw * wordw(hyp[i]),
                          wr + mw * wordw(ref[j])))
            # prune to beam
            best = sorted(nxt.items(),
                          key=lambda kv: (kv[1][1], kv[1][2], -kv[1][0]),
                          reverse=True)[:BEAM]
            states = dict(best)

        ch, w, m, wh, wr = max(states.values(),
                               key=lambda v: (v[1], v[2], -v[0]))
        return wh, wr, m, ch

    # ---------------- scoring ----------------

    def sentence_score(self, hyp: str, refs: Sequence[str]) -> float:
        hyp_t = normalize(hyp)
        best = 0.0
        for ref in refs:
            ref_t = normalize(ref)
            if not hyp_t or not ref_t:
                continue
            wh, wr, m, ch = self._align(hyp_t, ref_t)
            if m == 0:
                continue
            hw = sum(DELTA if t not in FUNCTION_WORDS else (1 - DELTA)
                     for t in hyp_t)
            rw = sum(DELTA if t not in FUNCTION_WORDS else (1 - DELTA)
                     for t in ref_t)
            p = wh / hw if hw > 0 else 0.0
            r = wr / rw if rw > 0 else 0.0
            if p + r == 0:
                continue
            f = p * r / (ALPHA * p + (1 - ALPHA) * r)
            frag = ch / m
            score = (1.0 - GAMMA * frag ** BETA) * f
            best = max(best, score)
        return best

    def compute_score(self, gts: Dict[str, Sequence[str]],
                      res: Dict[str, Sequence[str]]
                      ) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        scores = [self.sentence_score(res[k][0], gts[k]) for k in gts]
        arr = np.asarray(scores)
        return float(arr.mean()) if scores else 0.0, arr
