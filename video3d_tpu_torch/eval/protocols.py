"""Per-benchmark metric protocols.

Each function consumes the jsonl-style records the inference drivers emit and
reproduces the corresponding reference metric script exactly:
  scanqa       eval_scanqa.py:30-51  (EM + CIDEr/BLEU1-4/METEOR/ROUGE)
  sqa3d        eval_sqa3d.py:7-84    (clean_answer normalization + EM per type)
  scan2cap     eval_scan2cap.py:23-36 ('sos/eos' wrap + punctuation spacing)
  scanrefer    eval_scanrefer.py:11-38 (Acc@IoU 0.25/0.5, unique/multiple)
  multi3drefer eval_multi3drefer.py:13-107 (softmax cumulative-threshold box
               selection + Hungarian-matched F1@IoU)
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from video3d_tpu_torch.eval.metrics import Bleu, Cider, Meteor15, Rouge
from video3d_tpu_torch.ops.box import box3d_iou


# ---------------------------------------------------------------------------
# ScanQA
# ---------------------------------------------------------------------------

def scanqa_metrics(records: Sequence[dict], id2answers: Dict[str, List[str]]) -> dict:
    """records: {sample_id, pred_response}; id2answers: qid -> gold answers.
    sample_id's trailing answer index is remapped to 0 (eval_scanqa.py:33)."""
    res, gts = {}, {}
    n_correct = 0
    for item in records:
        sid = "_".join(item["sample_id"].split("_")[:-1] + ["0"])
        res[sid] = [item["pred_response"].rstrip(".")]
        gts[sid] = list(id2answers[sid])
        if item["pred_response"] in id2answers[sid]:
            n_correct += 1

    cider, _ = Cider().compute_score(gts, res)
    bleu, _ = Bleu().compute_score(gts, res)
    # METEOR-1.5 algorithm (the reference scores with the 1.5 jar;
    # metrics/meteor15.py documents the offline-resource deviations)
    m15 = Meteor15()
    meteor, _ = m15.compute_score(gts, res)
    rouge, _ = Rouge().compute_score(gts, res)
    return {
        "count": len(gts),
        "CIDEr": cider * 100,
        "BLEU-1": bleu[0] * 100, "BLEU-2": bleu[1] * 100,
        "BLEU-3": bleu[2] * 100, "BLEU-4": bleu[3] * 100,
        "METEOR": meteor * 100,
        "ROUGE-L": rouge * 100,
        "EM": n_correct / len(records),
        "meteor_provenance": m15.provenance(),
    }


# ---------------------------------------------------------------------------
# SQA3D
# ---------------------------------------------------------------------------

_NUM_WORDS = {"0": "zero", "1": "one", "2": "two", "3": "three", "4": "four",
              "5": "five", "6": "six", "7": "seven", "8": "eight",
              "9": "nine", "10": "ten", "11": "eleven", "12": "twelve",
              "13": "thirteen", "14": "fourteen", "15": "fifteen",
              "16": "sixteen", "17": "seventeen", "18": "eighteen",
              "19": "nineteen", "20": "twenty", "23": "twenty-three"}

_TYPO_FIXES = (("letf", "left"), ("let", "left"), ("tehre", "there"),
               ("rigth", "right"), ("rght", "right"), ("behine", "behind"),
               ("tv", "TV"), ("chai", "chair"), ("wasing", "washing"),
               ("waslked", "walked"), ("oclock", "o'clock"))


def clean_answer(data: str) -> str:
    """Literal port of eval_sqa3d.py:7-66."""
    data = data.lower()
    data = re.sub(r"[ ]+$", "", data)
    data = re.sub(r"^[ ]+", "", data)
    data = re.sub(r" {2,}", " ", data)
    data = re.sub(r"\.[ ]{2,}", ". ", data)
    data = re.sub(r"[^a-zA-Z0-9,'\s\-:]+", "", data)
    data = re.sub("ç", "c", data)
    data = re.sub("’", "'", data)
    for typo, fix in _TYPO_FIXES:
        data = re.sub(rf"\b{typo}\b", fix, data)
    data = re.sub(r"\bo'[ ]+clock\b", "o'clock", data)
    data = re.sub(r"\bnone\b", "zero", data)
    for digit, word in _NUM_WORDS.items():
        data = re.sub(rf"\b{digit}\b", word, data)
    data = re.sub(r"\b([a-zA-Z]+)([0-9])\b", r"\g<1>", data)
    data = re.sub(r"\ba\b ([a-zA-Z]+)", r"\g<1>", data)
    data = re.sub(r"\ban\b ([a-zA-Z]+)", r"\g<1>", data)
    data = re.sub(r"\bthe\b ([a-zA-Z]+)", r"\g<1>", data)
    data = re.sub(r"\bbackwards\b", "backward", data)
    return data


def sqa3d_metrics(records: Sequence[dict]) -> dict:
    """records: {pred_response, gt_response, question_type}."""
    correct = defaultdict(list)
    for item in records:
        ok = int(clean_answer(item["pred_response"]) == clean_answer(item["gt_response"]))
        correct["all"].append(ok)
        correct[item["question_type"]].append(ok)
    return {k: float(np.mean(v)) * 100 for k, v in correct.items()}


# ---------------------------------------------------------------------------
# Scan2Cap
# ---------------------------------------------------------------------------

def _scan2cap_wrap(text: str) -> str:
    return "sos " + text.replace(".", " . ").replace(",", " , ").lower() + " eos"


def scan2cap_metrics(records: Sequence[dict]) -> dict:
    """records: {sample_id, pred_response, gt_response: [refs...]} — the
    CIDEr@0.5IoU protocol is implicit in data prep (box_input filtered at
    IoU >= 0.5, SURVEY.md E2)."""
    res, gts = {}, {}
    for item in records:
        res[item["sample_id"]] = [_scan2cap_wrap(item["pred_response"])]
        gts[item["sample_id"]] = [_scan2cap_wrap(t) for t in item["gt_response"]]
    cider, _ = Cider().compute_score(gts, res)
    bleu, _ = Bleu().compute_score(gts, res)
    m15 = Meteor15()
    meteor, _ = m15.compute_score(gts, res)
    rouge, _ = Rouge().compute_score(gts, res)
    return {"CIDEr": cider * 100, "BLEU-4": bleu[3] * 100,
            "METEOR": meteor * 100, "ROUGE-L": rouge * 100,
            "meteor_provenance": m15.provenance()}


# ---------------------------------------------------------------------------
# ScanRefer
# ---------------------------------------------------------------------------

def scanrefer_metrics(records: Sequence[dict]) -> dict:
    """records: {pred_response: box6, gt_response: box6, question_type}."""
    acc25, acc50 = defaultdict(list), defaultdict(list)
    for item in records:
        iou = box3d_iou(np.asarray(item["gt_response"], float),
                        np.asarray(item["pred_response"], float))
        for d, thr in ((acc25, 0.25), (acc50, 0.5)):
            d["all"].append(iou >= thr)
            d[item["question_type"]].append(iou >= thr)
    out = {}
    for k in acc25:
        out[f"{k}@0.25"] = float(np.mean(acc25[k])) * 100
        out[f"{k}@0.5"] = float(np.mean(acc50[k])) * 100
    return out


# ---------------------------------------------------------------------------
# NR3D (easy/hard, view-dep/indep; eval_nr3d.py:9-48)
# ---------------------------------------------------------------------------

def nr3d_metrics(records: Sequence[dict]) -> dict:
    acc25, acc50 = defaultdict(list), defaultdict(list)
    for item in records:
        iou = box3d_iou(np.asarray(item["gt_response"], float),
                        np.asarray(item["pred_response"], float))
        qt = item["question_type"]
        buckets = ["all",
                   "easy" if "easy" in qt else "hard",
                   "view-dep" if "view-dep" in qt else "view-indep"]
        for b in buckets:
            acc25[b].append(iou >= 0.25)
            acc50[b].append(iou >= 0.5)
    out = {}
    for k in acc25:
        out[f"{k}@0.25"] = float(np.mean(acc25[k])) * 100
        out[f"{k}@0.5"] = float(np.mean(acc50[k])) * 100
    return out


# ---------------------------------------------------------------------------
# Multi3DRefer
# ---------------------------------------------------------------------------

def select_boxes_cumulative(scores: np.ndarray, objects: Sequence,
                            threshold: float = 0.4,
                            temperature: float = 0.07) -> List:
    """Reference box selection (eval_multi3drefer.py:96-107): if argmax is the
    zero-target (last slot) predict nothing; else softmax(scores/t) over the
    real objects and take the top boxes until cumulative mass >= threshold."""
    scores = np.asarray(scores, np.float64)
    if int(scores.argmax()) == len(scores) - 1:
        return []
    s = scores / temperature
    s = np.exp(s - s.max())
    probs = (s / s.sum())[:-1]
    order = np.argsort(-probs)
    picked, cum = [], 0.0
    for idx in order:
        cum += probs[idx]
        picked.append(objects[int(idx)])
        if cum >= threshold:
            break
    return picked


def hungarian_f1(pred: Sequence, gt: Sequence) -> tuple:
    """F1@0.25 / F1@0.5 with Hungarian matching (eval_multi3drefer.py:13-52)."""
    from scipy.optimize import linear_sum_assignment

    np_, ng = len(pred), len(gt)
    if np_ == 0 and ng == 0:
        return 1.0, 1.0
    if np_ == 0 or ng == 0:
        return 0.0, 0.0
    side = max(np_, ng)
    iou = np.zeros((side, side), np.float32)
    for i, p in enumerate(pred):
        for j, g in enumerate(gt):
            iou[i, j] = box3d_iou(np.asarray(p, float), np.asarray(g, float))
    rows, cols = linear_sum_assignment(-iou)
    tp25 = tp50 = 0
    for i in range(np_):
        v = iou[rows[i], cols[i]]
        tp25 += v >= 0.25
        tp50 += v >= 0.5
    return 2 * tp25 / (np_ + ng), 2 * tp50 / (np_ + ng)


def multi3drefer_metrics(records: Sequence[dict], threshold: float = 0.4) -> dict:
    """records: {scores: [N+1], objects: [N x 6], gt_response: [boxes],
    question_type}."""
    f25, f50 = defaultdict(list), defaultdict(list)
    for item in records:
        pred = select_boxes_cumulative(np.asarray(item["scores"]),
                                       item["objects"], threshold)
        a, b = hungarian_f1(pred, item["gt_response"])
        f25["all"].append(a)
        f50["all"].append(b)
        f25[item["question_type"]].append(a)
        f50[item["question_type"]].append(b)
    out = {}
    for k in f25:
        out[f"{k}@F1_0.25"] = float(np.mean(f25[k]))
        out[f"{k}@F1_0.5"] = float(np.mean(f50[k]))
    return out
