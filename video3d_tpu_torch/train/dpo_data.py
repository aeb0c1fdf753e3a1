"""The DPO preference-pair data path, counterpart of
``video3d_tpu/train/dpo_data.py`` (the reference's train_dpo.py and the
vendored trl DPODataCollator).

A record ``{"video": scene_id, "prompt": question, "chosen": preferred
answer, "rejected": dispreferred answer, ...}`` expands to two supervised
conversations sharing the prompt and the scene's frames; the training
``Collator`` builds each side's batch arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

from video3d_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
from video3d_tpu_torch.data.tokenization import preprocess_qwen


def dpo_record_to_conversations(record: Dict[str, Any]
                                ) -> Tuple[list, list]:
    """(chosen, rejected) conversations; a video record's prompt gains the
    ``<image>`` token in front when it has none."""
    prompt = record["prompt"]
    if DEFAULT_IMAGE_TOKEN not in prompt and "video" in record:
        prompt = f"{DEFAULT_IMAGE_TOKEN}\n{prompt}"
    chosen = [{"from": "human", "value": prompt},
              {"from": "gpt", "value": record["chosen"]}]
    rejected = [{"from": "human", "value": prompt},
                {"from": "gpt", "value": record["rejected"]}]
    return chosen, rejected


class DPODataset:
    """Preference pairs over the supervised pipeline: item i is a (chosen,
    rejected) pair of samples, each with the record's video arrays (frames
    sampled once, ``force_sample``) and its own ChatML tokens and labels."""

    def __init__(self, records: Sequence[dict], tokenizer, video_processor,
                 image_processor, frames_upbound: int = 32):
        self.records = list(records)
        self.tokenizer = tokenizer
        self.vp = video_processor
        self.ip = image_processor
        self.frames_upbound = frames_upbound

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> Tuple[Dict, Dict]:
        rec = self.records[i]
        video = {}
        if "video" in rec:
            vd = self.vp.process_3d_video(rec["video"], self.ip,
                                          force_sample=True,
                                          frames_upbound=self.frames_upbound)
            video = {k: vd[k] for k in ("images", "world_coords", "objects",
                                        "video_size")}
        out = []
        for conv in dpo_record_to_conversations(rec):
            tok = preprocess_qwen([conv], self.tokenizer,
                                  has_image="video" in rec)
            out.append({"input_ids": tok["input_ids"][0],
                        "labels": tok["labels"][0], "id": rec.get("id", i),
                        "dataset": "dpo", **video})
        return out[0], out[1]


class DPOCollator:
    """(chosen, rejected) sample pairs -> the two sides' batch arrays."""

    def __init__(self, collator):
        self.collator = collator

    def __call__(self, pairs: Sequence[Tuple[Dict, Dict]]):
        return (self.collator([p[0] for p in pairs]),
                self.collator([p[1] for p in pairs]))
