"""The port's LLaVA-Interleave metrics (``video3d_tpu_torch/eval/
interleave.py``) against the JAX package's copy on the same records: the
answer normalization, ROUGE-L, the multi-choice extraction, the category
rollups and the CLI's files, equal. Records are made from a numpy seed,
and the port's multi-image answers are scored the same way."""

import json
import os

import numpy as np
import pytest

from video3d_tpu.eval import interleave as jil
from video3d_tpu_torch.eval import interleave as til

WORDS = ("the brown chair table lamp two one desk window nothing changed "
         "images identical red apple green pear fox dog quick lazy").split()
PUNCT = ("", ".", ",", ";", "!", "?", " (x)", " [y]", '"', "-", "1,000")


def _text(rng, n: int) -> str:
    out = []
    for _ in range(n):
        w = WORDS[rng.integers(len(WORDS))]
        if rng.random() < 0.3:
            w += PUNCT[rng.integers(len(PUNCT))]
        out.append(w)
    return " ".join(out)


def _records(seed: int):
    rng = np.random.default_rng(seed)
    datasets = [d for ds in jil.CATEGORIES.values() for d in ds]
    recs = []
    for i in range(60):
        ds = datasets[rng.integers(len(datasets))]
        if rng.random() < 0.4:
            gt = "abcd"[rng.integers(4)]
            pred = rng.choice([gt, gt.upper(), f"Answer: {gt.upper()}",
                               "the answer is: " + "abcd"[rng.integers(4)],
                               "e"])
            recs.append({"dataset": ds, "sample_id": f"m{i}",
                         "question_type": "multi-choice",
                         "pred_response": str(pred), "gt_response": gt})
        else:
            recs.append({"dataset": ds, "sample_id": f"o{i}",
                         "question_type": "open-ended",
                         "pred_response": _text(rng, rng.integers(0, 30)),
                         "gt_response": _text(rng, rng.integers(0, 20))})
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interleave_metrics_match_jax(seed):
    recs = _records(seed)
    got = til.interleave_metrics([dict(r) for r in recs])
    want = jil.interleave_metrics([dict(r) for r in recs])
    assert got == want
    assert got["categories"]


def _outcome(fn, *args):
    """fn's value, or its exception's type and message."""
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


def test_helpers_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(200):
        a, b = _text(rng, rng.integers(0, 25)), _text(rng, rng.integers(1, 25))
        assert til.process_answer(a) == jil.process_answer(a)
        assert _outcome(til.rouge_l_f, a, b) == _outcome(jil.rouge_l_f, a, b)
    texts = ["." * 40 + " many periods " + "." * 40,
             "a, b, 1,000 dots......", "line\nbreaks\tand tabs"]
    for t in texts:
        assert til.process_answer(t) == jil.process_answer(t)
    assert til.CATEGORIES == jil.CATEGORIES
    assert til.IMAGE_CHOICE_DATASETS == jil.IMAGE_CHOICE_DATASETS


def test_cli_files_match_jax(tmp_path):
    recs = _records(4)
    outs = {}
    for name, mod in (("jax", jil), ("torch", til)):
        d = tmp_path / name
        d.mkdir()
        with open(d / "result.jsonl", "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        mod.main(["--result-dir", str(d)])
        outs[name] = {fn: json.load(open(d / fn))
                      for fn in sorted(os.listdir(d)) if fn.endswith(".json")}
    assert outs["torch"] == outs["jax"]
    assert set(outs["torch"]) == {"eval_dataset.json",
                                  "eval_dataset_details.json",
                                  "eval_cat.json"}
