"""LLaVA-NeXT-Interleave benchmark metrics (evaluate_interleave.py parity),
the PyTorch port's own copy of ``video3d_tpu/eval/interleave.py`` (numpy
only); it scores what ``InferenceEngine.generate_answer_images`` answers.

The reference scores multi-image benchmark outputs
(llava/eval/evaluate_interleave.py) with:
  * open-ended -> summary-level ROUGE-L f (the pltrdy `rouge` package:
    sentence split on '.', union-LCS per reference sentence over a running
    word-set, f = 2pr/(p+r+1e-8)) over punctuation-normalized text,
  * multi-choice -> exact match with an 'x:' answer-letter extraction,
  * category rollups (spot_the_diff, image_edit_instruct, ...).
Its sklearn TF-IDF imports are dead code (never referenced in the body).

This module reimplements all of it natively (no `rouge`/sklearn imports);
the JAX package's copy is golden-tested against the `rouge` package and the
reference's own Eval class (tests/test_interleave.py), and this one is held
to that copy (tests/test_torch_interleave.py). Quirks preserved
deliberately:
  * ``periodStrip.sub("", text, re.UNICODE)`` passes re.UNICODE (=32) as
    the COUNT argument, so only the first 32 periods are stripped
    (evaluate_interleave.py:59);
  * predictions are truncated to 512 chars before ROUGE (:91-92);
  * empty ground truths are skipped, empty predictions score 0 (:85-90).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
          "_", "-", ">", "<", "@", "`", ",", "?", "!"]

CATEGORIES: Dict[str, List[str]] = {
    "spot_the_diff": ["Spot-the-Diff", "Birds-to-Words", "CLEVR-Change"],
    "image_edit_instruct": ["IEdit", "HQ-Edit", "MagicBrush"],
    "visual_story_telling": ["AESOP", "FlintstonesSV", "PororoSV", "VIST"],
    "visual_cloze": ["COMICS_Dialogue", "RecipeQA_VisualCloze"],
    "text_rich_vqa": ["WebQA", "TQA", "OCR-VQA", "DocVQA"],
    "multi_image_vqa": ["MIT-States_StateCoherence",
                        "MIT-States_PropertyCoherence", "VISION",
                        "RecipeQA_ImageCoherence"],
    "puzzle": ["RAVEN"],
    "nlrv2": ["NLVR2_Mantis"],
    "qbench": ["QBench"],
}

IMAGE_CHOICE_DATASETS = ["recipeqa-RecipeQA_VisualCloze",
                         "RecipeQA_ImageCoherence", "COMICS_Panel"]


def process_answer(text: str) -> str:
    """Eval.process (evaluate_interleave.py:52-72): punctuation handling,
    the count-limited period strip, strip quotes/parens, lowercase."""
    out = text.replace("\n", " ").replace("\t", " ").strip()
    for p in _PUNCT:
        if (p + " " in out or " " + p in out) or \
                _COMMA_STRIP.search(out) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    # the reference passes re.UNICODE (== 32) as sub's COUNT argument —
    # only the first 32 matches are replaced; replicated exactly
    out = _PERIOD_STRIP.sub("", out, int(re.UNICODE))
    out = out.strip("'").strip('"').strip(")").strip("(").strip().lower()
    return out


# ---------------------------------------------------------------------------
# Summary-level ROUGE-L (pltrdy `rouge` package semantics, exclusive=True)
# ---------------------------------------------------------------------------

def _sentences(text: str) -> List[str]:
    return [" ".join(s.split()) for s in text.split(".") if len(s) > 0]


def _lcs_word_set(ref: List[str], hyp: List[str]) -> set:
    """Word set of one LCS of ref/hyp (the package's _recon_lcs with
    exclusive=True: the reconstructed subsequence's words as a set),
    iterative to avoid Python recursion limits."""
    n, m = len(ref), len(hyp)
    table = np.zeros((n + 1, m + 1), np.int32)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                table[i, j] = table[i - 1, j - 1] + 1
            else:
                table[i, j] = max(table[i - 1, j], table[i, j - 1])
    words = set()
    i, j = n, m
    while i > 0 and j > 0:
        if ref[i - 1] == hyp[j - 1]:
            words.add(ref[i - 1])
            i -= 1
            j -= 1
        elif table[i - 1, j] > table[i, j - 1]:
            i -= 1
        else:
            j -= 1
    return words


def rouge_l_f(pred: str, gt: str) -> float:
    """`Rouge().get_scores(pred, gt)[0]['rouge-l']['f']` reimplemented:
    summary-level union-LCS over '.'-split sentences, unique-word counts,
    f = 2pr / (p + r + 1e-8)."""
    hyp_sents, ref_sents = _sentences(pred), _sentences(gt)
    if not hyp_sents or not ref_sents:
        raise ValueError("Hypothesis is empty.")
    m = len({w for s in ref_sents for w in s.split(" ")})
    n = len({w for s in hyp_sents for w in s.split(" ")})
    union: set = set()
    llcs = 0
    for ref_s in ref_sents:
        ref_words = ref_s.split(" ")
        for hyp_s in hyp_sents:
            union = union | _lcs_word_set(ref_words, hyp_s.split(" "))
        llcs = len(union)
    r_lcs = llcs / m
    p_lcs = llcs / n
    return 2.0 * ((p_lcs * r_lcs) / (p_lcs + r_lcs + 1e-8))


# ---------------------------------------------------------------------------
# Per-question-type evaluators (evaluate_interleave.py:74-158)
# ---------------------------------------------------------------------------

def evaluate_rouge(preds: Sequence[dict]) -> Tuple[dict, list]:
    scores, detail = [], []
    for res in preds:
        gt = process_answer(res["gt_response"])
        pred = process_answer(res["pred_response"])
        if gt == "":
            continue
        if pred == "":
            s = 0.0
        else:
            s = rouge_l_f(pred[:512], gt)
        scores.append(s)
        detail.append({"id": str(res["sample_id"]),
                       "score": str(round(s, 3))})
    return {"Rouge-L f": float(np.mean(scores)) if scores else 0.0}, detail


def _extract_choice(pred: str) -> str:
    """'x: ...' answer-letter extraction (evaluate_interleave.py:104-110)."""
    if ":" in pred:
        for a in (x.strip() for x in pred.split(":")):
            if len(a) == 1 and a in "abcdefgh":
                return a
    return pred


def evaluate_multichoice(preds: Sequence[dict]) -> Tuple[dict, list]:
    correct, detail = 0, []
    for sample in preds:
        gt = process_answer(sample["gt_response"])
        pred = _extract_choice(process_answer(sample["pred_response"]))
        score = int(pred == gt)
        detail.append({"id": str(sample["sample_id"]), "score": str(score)})
        correct += score
    return {"Accuracy": correct / len(preds)}, detail


# the reference's evaluate_multi_choice_image performs the same
# normalize -> extract -> exact-match sequence (evaluate_interleave.py:
# 134-158); kept as an alias for surface parity
evaluate_multi_choice_image = evaluate_multichoice


def interleave_metrics(records: Sequence[dict]) -> dict:
    """Full evaluate_interleave pipeline over answer records
    ({dataset, sample_id, question_type, pred_response, gt_response}):
    per-dataset scores + category rollups."""
    by_dataset: Dict[str, list] = {}
    for r in records:
        by_dataset.setdefault(r["dataset"], []).append(r)

    per_dataset, per_detail = {}, {}
    for dataset, preds in by_dataset.items():
        qtype = preds[0]["question_type"]
        if qtype == "open-ended":
            result, detail = evaluate_rouge(preds)
        elif qtype == "multi-choice" or dataset == "nlrv2":
            if dataset in IMAGE_CHOICE_DATASETS:
                result, detail = evaluate_multi_choice_image(preds)
            else:
                result, detail = evaluate_multichoice(preds)
        else:
            raise ValueError(f"question_type {qtype!r} not supported")
        per_dataset[dataset] = result
        per_detail[dataset] = detail

    categories = {}
    for cat, members in CATEGORIES.items():
        vals = [list(per_dataset[d].values())[0]
                for d in per_dataset if d in members]
        if vals:
            categories[cat] = float(np.mean(vals))
    return {"datasets": per_dataset, "details": per_detail,
            "categories": categories}


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--result-dir", required=True)
    args = parser.parse_args(argv)
    result_file = os.path.join(args.result_dir, "result.jsonl")
    if not os.path.exists(result_file):
        print("No prediction file found")
        return
    with open(result_file) as f:
        records = [json.loads(line) for line in f]
    out = interleave_metrics(records)
    for dataset, result in out["datasets"].items():
        print(f"{dataset}:  {result}")
    with open(os.path.join(args.result_dir, "eval_dataset.json"), "w") as f:
        json.dump(out["datasets"], f, indent=4)
    with open(os.path.join(args.result_dir,
                           "eval_dataset_details.json"), "w") as f:
        json.dump(out["details"], f, indent=4)
    for cat, score in out["categories"].items():
        print(f"{cat}:  {100 * score:.2f}")
    with open(os.path.join(args.result_dir, "eval_cat.json"), "w") as f:
        json.dump(out["categories"], f, indent=4)


if __name__ == "__main__":
    main()
