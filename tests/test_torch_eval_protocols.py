"""The port's scoring protocols (``video3d_tpu_torch/eval/protocols.py``,
``eval/metrics/``, ``ops/box.py``) against the JAX package's on fixed
inputs: every metric and protocol returns the same values."""

import numpy as np
import pytest

from video3d_tpu.eval import metrics as jmetrics
from video3d_tpu.eval import protocols as jprot
from video3d_tpu.ops import box as jbox
from video3d_tpu_torch.eval import metrics as tmetrics
from video3d_tpu_torch.eval import protocols as tprot
from video3d_tpu_torch.ops import box as tbox

GTS = {
    "q0_0": ["a brown wooden chair", "the chair is brown"],
    "q1_0": ["two pillows", "there are two pillows on the bed"],
    "q2_0": ["on the left side of the sofa"],
    "q3_0": ["white"],
}
RES = {
    "q0_0": ["a brown chair"],
    "q1_0": ["two"],
    "q2_0": ["left of the couch"],
    "q3_0": ["black and white"],
}


def _boxes(seed, n):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-2, 2, (n, 3)),
                           rng.uniform(0.3, 1.5, (n, 3))], 1)


@pytest.mark.parametrize("name", ["Bleu", "Cider", "Meteor", "Meteor15",
                                  "Rouge"])
def test_caption_metric_matches_jax(name):
    got = getattr(tmetrics, name)().compute_score(GTS, RES)
    want = getattr(jmetrics, name)().compute_score(GTS, RES)
    np.testing.assert_equal(got, want)


@pytest.mark.parametrize("name", ["box3d_iou", "iou_matrix"])
def test_box_iou_matches_jax(name):
    a, b = _boxes(0, 6), _boxes(1, 6)
    if name == "box3d_iou":
        b[:2] = a[:2]
    np.testing.assert_array_equal(getattr(tbox, name)(a, b),
                                  getattr(jbox, name)(a, b))


def test_box_helpers_match_jax():
    a = _boxes(2, 1)[0]
    np.testing.assert_array_equal(tbox.get_3d_box_corners(a[:3], a[3:]),
                                  jbox.get_3d_box_corners(a[:3], a[3:]))
    c1 = jbox.get_3d_box_corners(a[:3], a[3:])
    c2 = jbox.get_3d_box_corners(a[:3] + 0.2, a[3:])
    assert tbox.corners_iou(c1, c2) == jbox.corners_iou(c1, c2)
    pc = np.random.default_rng(3).normal(size=(50, 3))
    np.testing.assert_array_equal(tbox.convert_pc_to_box(pc),
                                  jbox.convert_pc_to_box(pc))


def _qa_records():
    return [{"sample_id": k[:-2] + "_3", "pred_response": v[0],
             "gt_response": GTS[k][0], "question_type": t}
            for (k, v), t in zip(RES.items(), ["what", "how", "where",
                                               "what"])]


def test_scanqa_and_sqa3d_protocols_match_jax():
    recs = _qa_records()
    assert tprot.scanqa_metrics(recs, GTS) == jprot.scanqa_metrics(recs, GTS)
    sq = [dict(r, pred_response=p, gt_response=g) for r, p, g in zip(
        recs, ["Two.", "yes", "the left", "white"],
        ["two", "no", "left", "white"])]
    assert tprot.sqa3d_metrics(sq) == jprot.sqa3d_metrics(sq)
    for text in ("Two chairs.", "it's on the left!", "a table   "):
        assert tprot.clean_answer(text) == jprot.clean_answer(text)


def test_scan2cap_protocol_matches_jax():
    recs = [{"sample_id": k, "pred_response": RES[k][0],
             "gt_response": GTS[k]} for k in GTS]
    assert tprot.scan2cap_metrics(recs) == jprot.scan2cap_metrics(recs)


def test_grounding_protocols_match_jax():
    boxes = _boxes(4, 8)
    types = ["unique", "multiple", "unique", "multiple"]
    refer = [{"sample_id": f"r{i}", "pred_response":
              (boxes[i] + 0.1 * i).tolist(), "gt_response": boxes[i].tolist(),
              "question_type": t} for i, t in enumerate(types)]
    assert tprot.scanrefer_metrics(refer) == jprot.scanrefer_metrics(refer)
    nr3d = [dict(r, question_type=t) for r, t in
            zip(refer, ["easy", "hard", "view_dep", "view_indep"])]
    assert tprot.nr3d_metrics(nr3d) == jprot.nr3d_metrics(nr3d)
    rng = np.random.default_rng(5)
    multi = []
    for i, t in enumerate(["zt_w_d", "zt_wo_d", "st_w_d", "mt", "st_wo_d"]):
        gt = [] if t.startswith("zt") else boxes[i:i + 1 + (t == "mt")]
        multi.append({"sample_id": f"m{i}",
                      "scores": rng.normal(size=9).tolist(),
                      "objects": boxes.tolist(),
                      "gt_response": [b.tolist() for b in gt],
                      "question_type": t})
    assert tprot.multi3drefer_metrics(multi) == \
        jprot.multi3drefer_metrics(multi)
    scores = rng.normal(size=9)
    np.testing.assert_array_equal(
        np.asarray(tprot.select_boxes_cumulative(scores, boxes)),
        np.asarray(jprot.select_boxes_cumulative(scores, boxes)))
    assert tprot.hungarian_f1(boxes[:3], boxes[1:5]) == \
        jprot.hungarian_f1(boxes[:3], boxes[1:5])
